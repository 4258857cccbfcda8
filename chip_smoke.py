"""Smoke run of the PyTorch port (munit_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (exit code 1):
1. the card's name and power limit (nvidia-smi), and the build of every
   CUDA source of the port, one nvcc each, started together;
2. each norm kernel against its plain PyTorch version on the card, at every
   norm shape of the config_256 path, batch 1 and 8, f32 and bf16, ReLU on
   and off; then kernel, plain version, one library call and the
   device-memory bound timed per shape;
3. the golden fixture (tests/fixtures/golden_gen.npz) reproduced on the
   card through the kernels;
4. the main path: the translate CLI on the card at the full width of
   configs/config_256.yaml with seeded random weights (a style image and 4
   content images), the kernels' launch counts of that run, and the same
   translation on the CPU, which the card must match;
5. translation time per image at batch 1 and 8, TF32 off and on, and a
   profile of where a translation spends its device time at each batch.
Earlier lines are JSON objects. The line before the last is the kernel
table; the last is the status line. Without a CUDA card, or outside a
checkout of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SEED = 0
CONFIG = ROOT / "configs" / "config_256.yaml"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
FLOPS_PER_ELEMENT = 8       # Welford update 5, normalize and affine 2, ReLU 1
SHAPES = [(256, 256, 64), (128, 128, 128), (64, 64, 256)]
BATCHES = (1, 8)
# Calls per translated image of each wrapper at each (H, W, C) of the path.
PATH_CALLS = {
    "instance_norm": {(256, 256, 64): 1, (128, 128, 128): 1, (64, 64, 256): 9},
    "adain": {(64, 64, 256): 8},
    "whole_layer_norm": {(128, 128, 128): 1, (256, 256, 64): 1},
}
REPLACES = {
    "instance_norm": ("munit_tpu/kernels/norms.py:86",
                      "munit_tpu/kernels/tiled.py:52, munit_tpu/kernels/tiled.py:59"),
    "adain": ("munit_tpu/kernels/norms.py:86",
              "munit_tpu/kernels/tiled.py:52, munit_tpu/kernels/tiled.py:59"),
    "whole_layer_norm": ("munit_tpu/kernels/norms.py:212", None),
}
SOURCE = "munit_tpu_torch/kernels/csrc/norms.cu"
N_IMAGES = 4
ROUNDS = 5                  # timed loops per translate timing, median kept
SPIN_CYCLES = 2_000_000     # about 1 ms at the H100's clocks


def emit(**kw):
    print(json.dumps(kw), flush=True)


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(msg)


def parity_mode(on: bool):
    """TF32 off for comparisons (cuDNN convs use it by default)."""
    torch.backends.cudnn.allow_tf32 = not on
    torch.backends.cuda.matmul.allow_tf32 = not on


# ----------------------------------------------------------------- phase 2


def make_inputs(b, h, w, c, dtype, gen):
    x = (torch.randn((b, h, w, c), generator=gen, device="cuda") * 2 + 0.5)
    return {"x": x.to(dtype),
            "g2": torch.randn((b, c), generator=gen, device="cuda") + 1,
            "b2": torch.randn((b, c), generator=gen, device="cuda"),
            "g1": torch.rand((c,), generator=gen, device="cuda"),
            "b1": torch.randn((c,), generator=gen, device="cuda") * 0.1}


def call(norms, name, a, relu, plain=False):
    suffix = "_plain" if plain else ""
    fn = getattr(norms, name + suffix)
    if name == "instance_norm":
        return fn(a["x"], relu)
    if name == "adain":
        return fn(a["x"], a["g2"], a["b2"], relu)
    return fn(a["x"], a["g1"], a["b1"], relu)


def library(name, a):
    """One PyTorch call for the same norm on an NCHW-contiguous copy (its
    preferred layout). group_norm puts eps on the variance: timed only."""
    xc = a["x"].permute(0, 3, 1, 2).contiguous()
    b, c, h, w = xc.shape
    if name == "instance_norm":
        return lambda: F.instance_norm(xc)
    if name == "adain":
        flat = xc.view(1, b * c, h, w)
        g, bt = a["g2"].reshape(-1), a["b2"].reshape(-1)
        return lambda: F.batch_norm(flat, None, None, g, bt, True, 0.1, 1e-5)
    return lambda: F.group_norm(xc, 1, a["g1"], a["b1"], 1e-5)


def time_ms(fn, flush, iters=15):
    """Median device time of fn, each run after the L2 cache is flushed.
    A 1 ms spin on the card before each run lets the host enqueue all of
    fn's kernels first, so host overhead stays out of the device time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(name, a):
    x = a["x"]
    nbytes = 2 * x.numel() * x.element_size()
    if name == "adain":
        nbytes += 2 * a["g2"].numel() * 4
    elif name == "whole_layer_norm":
        nbytes += 2 * a["g1"].numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_ELEMENT * x.numel() / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(norms):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(100 * 2**20 // 4, device="cuda")
    err = {n: {"float32": 0.0, "bfloat16": 0.0} for n in PATH_CALLS}
    times = {}
    for b in BATCHES:
        for (h, w, c) in SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                a = make_inputs(b, h, w, c, dtype, gen)
                dname = str(dtype).split(".")[1]
                for name in PATH_CALLS:
                    shape_err = 0.0
                    for relu in (False, True):
                        got = call(norms, name, a, relu)
                        want = call(norms, name, a, relu, plain=True)
                        torch.cuda.synchronize()
                        check(got.dtype == dtype and got.shape == want.shape,
                              f"{name}: dtype or shape differs")
                        e = (got.float() - want.float()).abs().max().item()
                        shape_err = max(shape_err, e)
                        # f32: summation order; bf16: one bf16 ulp
                        rtol, atol = ((1e-4, 1e-4) if dtype == torch.float32
                                      else (2**-7, 3e-2))
                        check(torch.allclose(got.float(), want.float(),
                                             rtol=rtol, atol=atol),
                              f"{name} {(b, h, w, c)} {dname} relu={relu}: "
                              f"kernel differs from plain by {e}")
                    row = {"kernel": name, "shape": [b, h, w, c],
                           "dtype": dname,
                           "ms": time_ms(lambda: call(norms, name, a, False),
                                         flush)}
                    if dtype == torch.float32:
                        row["plain_ms"] = time_ms(
                            lambda: call(norms, name, a, False, plain=True),
                            flush)
                        row["library_ms"] = time_ms(library(name, a), flush)
                    row["bound_ms"], row["bound_by"] = bound(name, a)
                    row["max_abs_err"] = shape_err
                    err[name][dname] = max(err[name][dname], shape_err)
                    times[(name, b, h, w, c, dname)] = row
                    emit(phase="kernel", **row)
                del a
    return err, times


# ----------------------------------------------------------------- phase 3


def golden_phase(norms, GenBundle, validate, load_reference_checkpoint):
    path = ROOT / "tests" / "fixtures" / "golden_gen.npz"
    blob = np.load(path)
    gen = GenBundle(validate({"gen_state": 1, "gen": dict(
        dim=16, mlp_dim=32, style_dim=8, activ="relu", n_downsample=2,
        n_res=2, pad_type="reflect")}), "cuda")
    gen.load_state_dict(load_reference_checkpoint(str(path)))
    norms.reset_launches()
    with torch.inference_mode():
        c, s = gen.encode(torch.from_numpy(blob["x"]).cuda(), 1)
        y = gen.decode(c, s, 2).cpu().numpy()
    counts = dict(norms.launches)
    e = float(np.abs(y - blob["y"]).max())
    emit(phase="golden", max_abs_err=e, tol=1e-3, launches=counts)
    check(e <= 1e-3, f"golden fixture differs on the card by {e}")
    check(all(counts.values()), f"golden run missed a kernel: {counts}")


# ----------------------------------------------------------------- phase 4


def write_images(folder: Path, rng):
    """Smooth seeded RGB images (256x256): a style image and the inputs."""
    from PIL import Image

    def image():
        low = (rng.rand(8, 8, 3) * 255).astype(np.uint8)
        img = Image.fromarray(low).resize((256, 256), Image.BILINEAR)
        arr = np.asarray(img, np.float32) + rng.randn(256, 256, 3) * 8
        return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))

    (folder / "input").mkdir()
    image().save(folder / "style.png")
    for i in range(N_IMAGES):
        image().save(folder / "input" / f"street{i}.png")


def main_path_phase(norms, translate, GenBundle, get_config, tmp: Path):
    conf = get_config(str(CONFIG))
    gen = GenBundle(conf, "cpu")
    gen.init(torch.Generator().manual_seed(SEED))
    torch.save({"2": gen.state_dict()}, tmp / "gen.pt")
    write_images(tmp, np.random.RandomState(SEED))
    args = ["--config", str(CONFIG), "--checkpoint", str(tmp / "gen.pt"),
            "--input", str(tmp / "input"), "--style", str(tmp / "style.png")]

    parity_mode(True)
    norms.reset_launches()
    t0 = time.perf_counter()
    out_gpu = translate.main(args + ["--output_folder", str(tmp / "gpu"),
                                     "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(norms.launches)
    want = {"instance_norm": 11 * N_IMAGES, "adain": 8 * N_IMAGES,
            "whole_layer_norm": 2 * N_IMAGES}
    emit(phase="translate_card", images=N_IMAGES, seconds=wall,
         launches=launches, expected=want)
    check(launches == want, f"launch counts {launches}, expected {want}")

    out_cpu = translate.main(args + ["--output_folder", str(tmp / "cpu"),
                                     "--device", "cpu"])
    errs = [float(np.abs(g - c).max()) for g, c in zip(out_gpu, out_cpu)]
    finite = all(np.isfinite(o).all() for o in out_gpu)
    shapes = {tuple(o.shape) for o in out_gpu}
    emit(phase="translate_cpu_vs_card", max_abs_err=max(errs), tol=1e-3,
         finite=finite, shapes=sorted(shapes),
         out_range=[float(min(o.min() for o in out_gpu)),
                    float(max(o.max() for o in out_gpu))])
    check(len(out_gpu) == N_IMAGES and finite and shapes == {(256, 256, 3)},
          "card outputs are not finite 256x256x3 images")
    check(max(errs) <= 1e-3, f"card and CPU differ by {max(errs)}")
    return conf, launches, tmp / "gen.pt"


# ----------------------------------------------------------------- phase 5


def timing_phase(GenBundle, load_reference_checkpoint, conf, ckpt):
    gen = GenBundle(conf, "cuda")
    gen.load_state_dict(load_reference_checkpoint(str(ckpt)))
    g = torch.Generator(device="cuda").manual_seed(SEED)
    result = {}
    with torch.inference_mode():
        for b in BATCHES:
            x = torch.rand((b, 256, 256, 3), generator=g, device="cuda") * 2 - 1
            style = torch.rand((b, 256, 256, 3), generator=g,
                               device="cuda") * 2 - 1
            for tf32 in (False, True):
                parity_mode(not tf32)
                s = gen.encode_style(style)

                def step():
                    return gen.decode(gen.encode_content(x, 1), s, 2)

                for _ in range(3):
                    step()
                torch.cuda.synchronize()
                iters = 20 if b == 1 else 5
                rounds = []
                for _ in range(ROUNDS):
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        step()
                    torch.cuda.synchronize()
                    rounds.append((time.perf_counter() - t0) * 1e3 / iters / b)
                ms = float(np.median(rounds))
                result[(b, tf32)] = ms
                emit(phase="translate_time", batch=b, tf32=tf32,
                     ms_per_image=ms, rounds_ms_per_image=rounds, iters=iters,
                     note="encode_content + decode, style encoded once; "
                          "median of the rounds")
            profile(step, b, result[(b, True)])
        parity_mode(False)
    return result


def profile(step, b, ms_per_image):
    """Device time by kernel per image over 5 batch-b steps, TF32 on; the
    idle share is against the unprofiled time per image."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if dev > 0 and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            rows.append((dev / 1e3 / 5 / b, ev.key, ev.count // 5))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    groups = {"norm kernels": 0.0, "conv": 0.0, "pad": 0.0, "other": 0.0}
    for ms, key, _ in rows:
        k = key.lower()
        if any(t in k for t in ("norm_partials", "norm_finalize",
                                "norm_apply")):
            groups["norm kernels"] += ms
        elif "pad" in k:
            groups["pad"] += ms
        elif any(t in k for t in ("conv", "xmma", "gemm", "sm90", "implicit",
                                  "cudnn", "winograd", "fft")):
            groups["conv"] += ms
        else:
            groups["other"] += ms
    emit(phase="profile", batch=b, tf32=True,
         profiled_wall_ms_per_image=wall_ms / 5 / b,
         device_busy_ms_per_image=busy if rows else "not measured",
         device_idle_share=(1 - busy / ms_per_image) if rows
         else "not measured",
         by_group_ms=groups,
         top=[{"ms": r[0], "calls_per_step": r[2], "kernel": r[1][:90]}
              for r in rows[:12]])


# --------------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    # a checkout of the repo: the port and its sources must be here
    from munit_tpu_torch.cli import translate
    from munit_tpu_torch.config import get_config, validate
    from munit_tpu_torch.io.weights import load_reference_checkpoint
    from munit_tpu_torch.kernels import build, norms
    from munit_tpu_torch.nn.generator import GenBundle

    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs = build.build_all()
    ptxas = [ln.strip() for name in libs for ln in
             build.compiler_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries={k: str(v.relative_to(ROOT)) for k, v in libs.items()},
         ptxas=ptxas)
    emit(phase="versions", python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0))

    parity_mode(True)
    err, times = kernel_phase(norms)
    golden_phase(norms, GenBundle, validate, load_reference_checkpoint)
    with tempfile.TemporaryDirectory() as tmp:
        conf, launches, ckpt = main_path_phase(norms, translate, GenBundle,
                                               get_config, Path(tmp))
        timing_phase(GenBundle, load_reference_checkpoint, conf, ckpt)

    kernels = []
    for name, calls in PATH_CALLS.items():
        rows = [(n, times[(name, 1, *hwc, "float32")])
                for hwc, n in calls.items()]

        def total(key):
            return sum(n * row[key] for n, row in rows)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name][0], "also_replaces": REPLACES[name][1],
            "launches": launches[name], "max_abs_err": err[name]["float32"],
            "max_abs_err_bf16": err[name]["bfloat16"],
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for _, r in rows) else "operations"),
            "library_ms": total("library_ms"),
            "per": "one translated image: its calls at batch 1, float32",
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
