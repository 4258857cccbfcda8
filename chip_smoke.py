"""Smoke run of the PyTorch port (munit_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (exit code 1):
1. the card's name and power limit (nvidia-smi), and the build of every
   CUDA source of the port, one nvcc each, started together;
2. each norm kernel against its plain PyTorch version on the card, at every
   norm shape of the config_256 path, batch 1, 2, 8 and 16 (the wide
   decodes run at 2B), f32 and bf16, ReLU on and off; each path shape's
   launch plan (cluster design at (B, 64, 64, 256) for IN and AdaIN, the
   grid design at every other shape and for every LN, the split design
   nowhere; the cluster's group, K, rows and resident clusters, the grid's
   segments, blocks, rows kept on chip and blocks an SM holds); then
   kernel, plain version, one library call (for IN and AdaIN the
   F.batch_norm view, F.instance_norm beside it) and the device-memory
   bound timed per shape, the split design (the "was") and a copy of x
   timed in the same run, the split design held against the same
   references and two runs held bitwise equal (and the cluster design
   under other tile budgets than the plan's); then a profile that finds
   one device kernel per call, forward and backward, of AdaIN at
   (2, 64, 64, 256), IN at (1, 128, 128, 128) and the LN at
   (2, 256, 256, 64), and the host µs per wrapper call of each design;
3. the golden fixture (tests/fixtures/golden_gen.npz) reproduced on the
   card through the kernels;
4. the main path: the translate CLI on the card at the full width of
   configs/config_256.yaml with seeded random weights (a style image and 4
   content images), the kernels' launch counts of that run, and the same
   translation on the CPU, which the card must match; then the same
   weights packed as the JAX package's bf16 inference .npz (written here
   with numpy), translated from that file on the card and on the CPU;
5. translation time per image at batch 1 and 8, TF32 off and on, and a
   profile of where a translation spends its device time at each batch;
6. each backward kernel against the plain closed-form backward and against
   autograd of the plain forward, at every norm shape of the training path
   (the wide decodes at twice the batch), f32 and bf16, ReLU on and off;
   then kernel, plain backward, one library call's autograd backward (IN:
   the F.batch_norm view, F.instance_norm beside it) and the byte bound
   timed per shape, the split design beside it, two runs bitwise equal;
   and the LN backward at batch 16 against a float64 closed form;
7. the frozen ResNet34-8s segmenter (seeded random weights: the Cityscapes
   checkpoint is not in the repo) at (2, 256, 256, 3) on the card (TF32
   off) against the CPU, and the agreement of their pseudo-labels;
8. the training path: configs/config_256.yaml as it is (semantic_w 3),
   full width, seeded random weights, images and masks, first with TF32
   (f32 activations and operands) and then (8b) in bench.py's production
   bf16 mode (bf16 conv operands and images, every norm kernel on a bf16
   x, which the launch counts assert); 15 iterations in
   bench.py's cadence (12 dis steps, 3 fused dis+gen steps, 1
   classifier_sr step) at batch 1 and 8 with every loss finite,
   loss_sem_seg above 0, and the wrappers' launch counts asserted (the
   segmenter runs no norm kernel); then training time at batch 1 and 8:
   each step kind, ms per iteration over the 5-iteration cycle,
   images/s as bench.py counts them, peak memory, a profile of one fused
   step (which asserts 84 one-launch norm kernels each way: a cluster
   kernel per AdaIN and (64, 64, 256) IN call, a grid kernel per other IN
   and per LN call, and no split-design kernel, and times each of them
   inside the step), the wrappers' launches by design, and the segmenter's
   share (its targets pass and its
   loss forward and backward, timed and profiled apart: no weight-gradient
   kernel);
9. one fused step's gradients at batch 1, with the semantic term, on the
   card with TF32 off against the CPU, with TF32 on against float64, and in
   bf16 against the CPU's bf16 and float64, and the pseudo-label flips of
   each; then bench_torch.py at batch 8 and 30 iterations, bf16 and f32;
10. the moments kernels (sample_sums, sample_affine) against their plain
   versions at every whole-LN probe shape, f32 and bf16, ReLU on and off,
   timed against the byte bound, the plain version and one library call;
11. the whole-LN probes P1, P2 and P3 (munit_tpu_torch.tools.normprobe) at
   their full shapes with a short chain, each variant's time and error,
   and the moments kernels' launches in each probe.
Earlier lines are JSON objects. The line before the last is the kernel
table; the last is the status line. Without a CUDA card, or outside a
checkout of the repo, it exits non-zero and prints no result.

    python3 chip_smoke.py --ab TREE [TREE ...]

times translation (phase 5) in each given checkout of the repo, one fresh
process after another, with that checkout's own code: the same-call
comparison of two trees (parent, change, change, parent).
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
MOMENTS_SOURCE = "munit_tpu_torch/kernels/csrc/moments.cu"
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


def strided_affine(g, b):
    """(gamma, beta) as column slices of one wider (B, 4C) tensor, as the
    generator slices them from the style MLP's output."""
    c = g.shape[1]
    wide = torch.empty((g.shape[0], 4 * c), device=g.device)
    wide[:, c:2 * c], wide[:, :c] = g, b
    return wide[:, c:2 * c], wide[:, :c]


def make_inputs(b, h, w, c, dtype, gen):
    x = (torch.randn((b, h, w, c), generator=gen, device="cuda") * 2 + 0.5)
    g2 = torch.randn((b, c), generator=gen, device="cuda") + 1
    b2 = torch.randn((b, c), generator=gen, device="cuda")
    g2, b2 = strided_affine(g2, b2)
    return {"x": x.to(dtype), "g2": g2, "b2": b2,
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


def library(name, a, instance=False):
    """One PyTorch call for the same norm on an NCHW-contiguous copy (its
    preferred layout): for IN and AdaIN F.batch_norm on the (1, B C, H, W)
    view in training mode (per (sample, channel) statistics, biased
    variance, eps inside the root: the same function), or with
    ``instance`` F.instance_norm; group_norm puts eps on the variance and
    takes the biased std: timed only."""
    xc = a["x"].permute(0, 3, 1, 2).contiguous()
    b, c, h, w = xc.shape
    flat = xc.view(1, b * c, h, w)
    if name == "instance_norm":
        if instance:
            return lambda: F.instance_norm(xc)
        return lambda: F.batch_norm(flat, None, None, None, None, True, 0.1,
                                    1e-5)
    dt = xc.dtype
    if name == "adain":
        g, bt = a["g2"].reshape(-1).to(dt), a["b2"].reshape(-1).to(dt)
        return lambda: F.batch_norm(flat, None, None, g, bt, True, 0.1, 1e-5)
    g, bt = a["g1"].to(dt), a["b1"].to(dt)
    return lambda: F.group_norm(xc, 1, g, bt, 1e-5)


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


# Where the cluster design runs on the path: IN and AdaIN at (64, 64, 256),
# also at 2B (the wide decodes, and the phase-6 backward shapes). Every
# other norm call (IN at 128^2 and 256^2, every LN) runs the grid design.
CLUSTER_SHAPE = (64, 64, 256)
PLAN_BATCHES = (1, 2, 8, 16)
DTYPES = (torch.float32, torch.bfloat16)


def dtype_name(dtype):
    return str(dtype).split(".")[1]


def sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


def cluster_plan_of(norms, x, tiles):
    b, h, w, c = x.shape
    return norms.cluster_plan(b, h * w, c, x.element_size(), x.data_ptr(),
                              sm_count(), tiles)


def plan_of(norms, x, tiles, whole):
    b, h, w, c = x.shape
    return norms.choose(b, h * w, c, x.element_size(), x.data_ptr(),
                        sm_count(), tiles, whole)


def design_of(norms, name, x, tiles=1):
    """The design the wrapper runs for this call: "cluster" or "grid"."""
    p = plan_of(norms, x, tiles, name == "whole_layer_norm")
    return "cluster" if isinstance(p, norms.ClusterPlan) else "grid"


def plan_phase(norms):
    """Each path shape's launch plan, forward (one tile) and backward (x
    and dy), for IN/AdaIN and for the LN: the cluster design's group, K,
    rows, shared memory and resident clusters; the grid design's segments,
    blocks, rows kept on chip, shared memory and blocks an SM holds. IN and
    AdaIN must take the cluster design at (B, 64, 64, 256) and the grid
    design elsewhere, the LN the grid design everywhere, the split design
    nowhere; a grid must fit the card at once."""
    for tiles, way in ((1, "forward"), (2, "backward")):
        for dtype in DTYPES:
            for b in PLAN_BATCHES:
                for h, w, c in SHAPES:
                    x = torch.empty((b, h, w, c), dtype=dtype, device="cuda")
                    for norm, whole in (("in_adain", False), ("ln", True)):
                        p = plan_of(norms, x, tiles, whole)
                        design = ("cluster" if isinstance(p, norms.ClusterPlan)
                                  else "grid")
                        row = {"direction": way, "norm": norm,
                               "shape": [b, h, w, c],
                               "dtype": dtype_name(dtype), "design": design,
                               **p._asdict()}
                        if design == "cluster":
                            row["active_clusters"] = norms.cluster_occupancy(
                                x, tiles == 2)
                            row["blocks"] = b * -(-c // p.cg) * p.k
                        else:
                            per_sm = norms.grid_occupancy(x, tiles == 2, whole)
                            row["blocks_per_sm"] = per_sm
                            row["resident_share"] = min(
                                1.0, p.blocks * p.res / (b * h * w))
                            check(p.blocks <= per_sm * sm_count(),
                                  f"plan {row}: the grid does not fit")
                        emit(phase="plan", **row)
                        want = ("cluster" if not whole
                                and (h, w, c) == CLUSTER_SHAPE else "grid")
                        check(design == want, f"plan {row}: want {want}")
                    del x


SWEEP_BUDGETS = (32 * 1024, 64 * 1024, 128 * 1024)


def budget_sweep(norms):
    """The cluster design's time at the decoders' shape, f32, batch 1 and 8,
    forward and backward, under other tile budgets than the plan's (so
    other K), with the clusters the card holds at once: the reading the
    plan's budget follows. The plan's own budget is restored after."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    flush = torch.empty(100 * 2**20 // 4, device="cuda")
    keep = norms._CLUSTER_BUDGET
    try:
        for b in BATCHES:
            a = make_inputs(b, *CLUSTER_SHAPE, torch.float32, gen)
            a["dy"] = torch.randn(a["x"].shape, generator=gen, device="cuda")
            for budget in SWEEP_BUDGETS:
                norms._CLUSTER_BUDGET = budget
                row = {"shape": [b, *CLUSTER_SHAPE], "budget": budget,
                       "plan_budget": keep}
                for tiles, way in ((1, "forward"), (2, "backward")):
                    cp = cluster_plan_of(norms, a["x"], tiles)
                    if cp is None:
                        continue
                    fn = (direct_backward(norms, "adain", a, False)
                          if tiles == 2
                          else lambda: call(norms, "adain", a, False))
                    row[way] = {"k": cp.k, "smem": cp.smem,
                                "active_clusters": norms.cluster_occupancy(
                                    a["x"], tiles == 2),
                                "ms": time_ms(fn, flush)}
                emit(phase="budget_sweep", **row)
            del a
    finally:
        norms._CLUSTER_BUDGET = keep


def split_call(norms, name, a, relu):
    """The same norm forced through the split design (three kernels): the
    "was" of every path shape."""
    aff = {"instance_norm": (None, None), "adain": (a["g2"], a["b2"]),
           "whole_layer_norm": (a["g1"], a["b1"])}[name]
    return norms._launch(name, a["x"], *aff, relu,
                         name == "whole_layer_norm", split=True)[0]


def phase2_cases():
    for b in PLAN_BATCHES:
        for hwc in SHAPES:
            yield b, hwc, tuple(PATH_CALLS)


def kernel_phase(norms):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(100 * 2**20 // 4, device="cuda")
    err = {}   # (wrapper, design, dtype): largest error against plain
    times = {}
    for b, (h, w, c), names in phase2_cases():
        for dtype in DTYPES:
            a = make_inputs(b, h, w, c, dtype, gen)
            dname = dtype_name(dtype)
            for name in names:
                design = design_of(norms, name, a["x"])
                shape_err = 0.0
                for relu in (False, True):
                    got = call(norms, name, a, relu)
                    want = call(norms, name, a, relu, plain=True)
                    outs = [(got, "kernel"),
                            (split_call(norms, name, a, relu), "split design")]
                    again = call(norms, name, a, relu)
                    torch.cuda.synchronize()
                    check(got.dtype == dtype and got.shape == want.shape,
                          f"{name}: dtype or shape differs")
                    check(torch.equal(got, again),
                          f"{name} {(b, h, w, c)} {dname}: two runs differ")
                    for out, what in outs:
                        e = (out.float() - want.float()).abs().max().item()
                        shape_err = max(shape_err, e)
                        # f32: summation order; bf16: one bf16 ulp
                        rtol, atol = ((1e-4, 1e-4) if dtype == torch.float32
                                      else (2**-7, 3e-2))
                        check(torch.allclose(out.float(), want.float(),
                                             rtol=rtol, atol=atol),
                              f"{name} {(b, h, w, c)} {dname} relu={relu}: "
                              f"{what} differs from plain by {e}")
                y = torch.empty_like(a["x"])
                row = {"kernel": name, "shape": [b, h, w, c], "dtype": dname,
                       "design": design,
                       "ms": time_ms(lambda: call(norms, name, a, False),
                                     flush),
                       "split_ms": time_ms(
                           lambda: split_call(norms, name, a, False), flush),
                       "copy_ms": time_ms(lambda: y.copy_(a["x"]), flush),
                       "library_ms": time_ms(library(name, a), flush)}
                if name == "instance_norm":
                    row["instance_norm_ms"] = time_ms(
                        library(name, a, instance=True), flush)
                if dtype == torch.float32:
                    row["plain_ms"] = time_ms(
                        lambda: call(norms, name, a, False, plain=True),
                        flush)
                row["bound_ms"], row["bound_by"] = bound(name, a)
                row["max_abs_err"] = shape_err
                key = (name, design, dname)
                err[key] = max(err.get(key, 0.0), shape_err)
                times[(name, b, h, w, c, dname)] = row
                emit(phase="kernel", **row)
                del y
            del a
    return err, times


PROFILE_CALLS = 8
HOST_CALLS = 1000


# (wrapper, shape, forward kernel, backward kernel) profiled per call: one
# path shape of each design and norm kind.
ONE_KERNEL_CASES = (
    ("adain", (2, *CLUSTER_SHAPE), "norm_cluster_fwd", "norm_cluster_bwd"),
    ("instance_norm", (1, 128, 128, 128), "norm_grid_fwd", "norm_grid_bwd"),
    ("whole_layer_norm", (2, 256, 256, 64), "norm_grid_fwd", "norm_grid_bwd"),
)


def one_kernel_phase(norms):
    """One device kernel per call: PROFILE_CALLS forward calls (no grad) and
    as many backward calls (autograd.grad through the wrapper's Function;
    AdaIN's gamma and beta strided slices as the generator passes them) of
    each ONE_KERNEL_CASES row, f32 and bf16, profiled; each call's window
    must hold exactly one device kernel, the design's. Then the host µs
    per call (a mean over HOST_CALLS calls, no synchronise) of each
    design's launcher, and of the public wrapper."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for name, shape, fwd_kernel, bwd_kernel in ONE_KERNEL_CASES:
        for dtype in DTYPES:
            a = make_inputs(*shape, dtype, gen)
            dy = torch.randn(a["x"].shape, generator=gen,
                             device="cuda").to(dtype)
            y, inputs = kernel_graph(norms, name, a, True)

            def fwd():
                with torch.no_grad():
                    call(norms, name, a, True)

            def bwd():
                torch.autograd.grad(y, inputs, dy, retain_graph=True)

            for way, step, kernel in (("forward", fwd, fwd_kernel),
                                      ("backward", bwd, bwd_kernel)):
                step()
                rows, _ = device_profile(step, PROFILE_CALLS)
                per_call = [{"kernel": r[1][:90], "per_call": r[2]}
                            for r in rows]
                emit(phase="one_kernel", kernel=name, direction=way,
                     shape=list(shape), dtype=dtype_name(dtype),
                     device_kernels=per_call)
                check(len(rows) == 1 and kernel in rows[0][1]
                      and rows[0][2] == 1,
                      f"{name} {way} {list(shape)} {dtype_name(dtype)}: "
                      f"device kernels per call {per_call}, want one {kernel}")
            del a, dy, y, inputs
    for name, shape in (("adain", (1, *CLUSTER_SHAPE)),
                        ("instance_norm", (1, 128, 128, 128))):
        a = make_inputs(*shape, torch.float32, gen)
        dy = torch.randn(a["x"].shape, generator=gen, device="cuda")
        x = a["x"]
        aff = affine_of(name, a) or [None, None]
        stats = norms._launch(name, x, *aff, True, False)[1]
        design = design_of(norms, name, x)
        row = {}
        for split in (False, True):
            tag = "split" if split else design
            row[f"{tag}_forward_us"] = host_us(
                lambda: norms._launch(name, x, *aff, True, False, split=split))
            row[f"{tag}_backward_us"] = host_us(
                lambda: norms._launch_backward(name, x, stats, *aff, dy, True,
                                               False, split=split))
        with torch.no_grad():
            row["wrapper_forward_us"] = host_us(
                lambda: call(norms, name, a, True))
        emit(phase="host_per_call", kernel=name, shape=list(shape),
             dtype="float32", calls=HOST_CALLS, **row,
             note="host µs per call, mean over the calls, no synchronise")


def host_us(fn):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / HOST_CALLS
    torch.cuda.synchronize()
    return us


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
    check(all(counts[n] for n in norms.NAMES) and
          not any(counts[n + "_bwd"] for n in norms.NAMES),
          f"golden run missed a kernel: {counts}")


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


# Of each wrapper's calls on the path, the share each design takes (a
# content encode runs 9 of its 11 IN at (64, 64, 256), on the cluster
# design, and 2 at 128^2 and 256^2, on the grid design).
PATH_DESIGN_SHARE = {"instance_norm": {"cluster": 9, "grid": 2},
                     "adain": {"cluster": 1},
                     "whole_layer_norm": {"grid": 1}}


def designs_of_calls(norms, calls, share):
    """{wrapper (and _bwd): {design: launches}} of ``calls`` per wrapper,
    split by ``share``; no call on the split design."""
    out = {}
    for key, n in calls.items():
        parts = share[key.removesuffix("_bwd")]
        total = sum(parts.values())
        check(n % total == 0, f"{key}: {n} calls do not split as {parts}")
        out[key] = {d: n * parts.get(d, 0) // total for d in norms.DESIGNS}
    return out


def main_path_phase(norms, translate, GenBundle, get_config, tmp: Path):
    conf = get_config(str(CONFIG))
    gen = GenBundle(conf, "cpu")
    gen.init(torch.Generator().manual_seed(SEED))
    torch.save({"2": gen.state_dict()}, tmp / "gen.pt")
    write_images(tmp, np.random.RandomState(SEED))
    args = ["--checkpoint", str(tmp / "gen.pt"), "--config", str(CONFIG),
            "--input", str(tmp / "input"), "--style", str(tmp / "style.png")]

    parity_mode(True)
    norms.reset_launches()
    t0 = time.perf_counter()
    out_gpu = translate.main(args + ["--output_folder", str(tmp / "gpu"),
                                     "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(norms.launches)
    by_design = {k: dict(v) for k, v in norms.design_launches.items()}
    want = {"instance_norm": 11 * N_IMAGES, "adain": 8 * N_IMAGES,
            "whole_layer_norm": 2 * N_IMAGES, "instance_norm_bwd": 0,
            "adain_bwd": 0, "whole_layer_norm_bwd": 0}
    want_design = designs_of_calls(norms, want, PATH_DESIGN_SHARE)
    emit(phase="translate_card", images=N_IMAGES, seconds=wall,
         launches=launches, expected=want, launches_by_design=by_design,
         expected_by_design=want_design)
    check(launches == want, f"launch counts {launches}, expected {want}")
    check(by_design == want_design,
          f"launches by design {by_design}, expected {want_design}")

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
    packed_phase(translate, gen, args[2:], tmp)
    return conf, by_design, tmp / "gen.pt"


def bf16_bits(a) -> np.ndarray:
    """float32 → the uint16 bits of its bfloat16 rounding (to nearest,
    ties to even), as the JAX package stores a bf16 leaf."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def write_packed(path: Path, tree):
    """The JAX package's packed inference file (save_inference_params,
    quant bf16) of a JAX param tree, written with numpy: a JSON manifest as
    uint8 and one array per leaf, the kernels as bf16 bits."""
    from munit_tpu_torch.io.weights import PACKED_MAGIC

    def flat(t, prefix=""):
        for k, v in t.items():
            key = f"{prefix}/{k}" if prefix else k
            yield from flat(v, key) if isinstance(v, dict) else [(key, v)]

    arrays, keys = {}, {}
    for i, (key, v) in enumerate(sorted(flat(tree))):
        name = f"a{i}"
        if v.ndim >= 2:
            arrays[name] = bf16_bits(v)
            keys[key] = {"name": name, "dtype": "bfloat16"}
        else:
            arrays[name] = np.asarray(v, np.float32)
            keys[key] = {"name": name, "dtype": "float32"}
    arrays["__manifest__"] = np.frombuffer(json.dumps(
        {"magic": PACKED_MAGIC, "keys": keys}).encode(), np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def packed_phase(translate, gen, args, tmp: Path):
    """The translate CLI from a bf16-packed inference .npz of the same
    weights, on the card and on the CPU: the loaded weights are the bf16
    roundings of the originals, and the two translations agree."""
    from munit_tpu_torch.io.weights import (load_reference_checkpoint,
                                            to_jax_params)
    sd = gen.state_dict()
    path = tmp / "gen_packed.npz"
    write_packed(path, to_jax_params(sd))
    loaded = load_reference_checkpoint(str(path))
    check(set(loaded) == set(sd), "packed checkpoint keys differ")
    weight_err = max(float((loaded[k] - sd[k].to(torch.bfloat16).float()
                            if sd[k].dim() >= 2 else loaded[k] - sd[k])
                           .abs().max()) for k in sd)
    parity_mode(True)
    out = {dev: translate.main(["--checkpoint", str(path)] + args
                               + ["--output_folder", str(tmp / f"p_{dev}"),
                                  "--device", dev])
           for dev in ("cuda", "cpu")}
    errs = [float(np.abs(g - c).max()) for g, c in zip(out["cuda"], out["cpu"])]
    finite = all(np.isfinite(o).all() for o in out["cuda"])
    emit(phase="translate_packed", quant="bf16", file_mb=path.stat().st_size / 2**20,
         weights_vs_bf16_rounding=weight_err, max_abs_err=max(errs), tol=1e-3,
         finite=finite)
    check(weight_err == 0.0, f"packed weights off their bf16 rounding by "
                             f"{weight_err}")
    check(len(errs) == N_IMAGES and finite, "packed translation not finite")
    check(max(errs) <= 1e-3, f"packed: card and CPU differ by {max(errs)}")


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


# Kernel-name fragments of each group of device time, tried in this order.
GROUPS = (
    ("norm bwd", ("norm_bwd", "norm_cluster_bwd", "norm_grid_bwd")),
    ("norm fwd", ("norm_partials", "norm_finalize", "norm_apply",
                  "norm_cluster_fwd", "norm_grid_fwd")),
    ("pad", ("pad",)),
    ("optimizer", ("foreach", "multi_tensor", "adam")),
    ("conv", ("conv", "xmma", "gemm", "sm90", "implicit", "cudnn",
              "winograd", "fft", "wgrad", "dgrad", "fprop", "cutlass")),
)


def device_profile(step, reps):
    """[(device ms per step, kernel name, launches per step)] of ``reps``
    runs of ``step`` under torch.profiler, largest first, and the profiled
    host wall ms per step."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if dev > 0 and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            rows.append((dev / 1e3 / reps, ev.key, ev.count / reps))
    rows.sort(reverse=True)
    return rows, wall_ms


def grouped(rows, per=1.0):
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["other"] = 0.0
    for ms, key, _ in rows:
        k = key.lower()
        name = next((n for n, frags in GROUPS
                     if any(f in k for f in frags)), "other")
        groups[name] += ms / per
    return groups


def profile(step, b, ms_per_image):
    """Device time by kernel per image over 5 batch-b steps, TF32 on; the
    idle share is against the unprofiled time per image."""
    for _ in range(3):
        step()
    rows, wall_ms = device_profile(step, 5)
    busy = sum(r[0] for r in rows) / b
    emit(phase="profile", batch=b, tf32=True,
         profiled_wall_ms_per_image=wall_ms / b,
         device_busy_ms_per_image=busy if rows else "not measured",
         device_idle_share=(1 - busy / ms_per_image) if rows
         else "not measured",
         by_group_ms=grouped(rows, b),
         top=[{"ms": r[0] / b, "calls_per_step": r[2], "kernel": r[1][:90]}
              for r in rows[:12]])


# ----------------------------------------------------------------- phase 6

# Backward calls of each wrapper per fused step at batch B, by (batch
# multiple, H, W, C): the wide decodes run at 2B (recon | cross), the cycle
# decodes and the content encoders at B (train/trainer.py).
BWD_CALLS = {
    "instance_norm": {(1, 256, 256, 64): 4, (1, 128, 128, 128): 4,
                      (1, 64, 64, 256): 36},
    "adain": {(2, 64, 64, 256): 16, (1, 64, 64, 256): 16},
    "whole_layer_norm": {(2, 128, 128, 128): 2, (2, 256, 256, 64): 2,
                         (1, 128, 128, 128): 2, (1, 256, 256, 64): 2},
}
BWD_REPLACES = {
    "instance_norm": "munit_tpu/kernels/norms.py:188",
    "adain": "munit_tpu/kernels/norms.py:152",
    "whole_layer_norm": "munit_tpu/kernels/norms.py:253",
}
BWD_ALSO = "tools/normprobe3.py:102"
BWD_FLOPS_PER_ELEMENT = 14  # two recomputes of xh, mask, two sums, the apply


def gap_inputs(b, h, w, c, dtype, gen):
    """Inputs whose pre-activations x̂ gamma + beta stay 0.3 |gamma| or
    more from 0, so a recomputed ReLU mask cannot flip on a last-ulp
    difference: x = ±(1 + |N(0,1)|) + 0.5, |gamma| in [0.5, 1.5),
    |beta / gamma| <= 0.2; dy ~ N(0, 1)."""
    x = torch.randn((b, h, w, c), generator=gen, device="cuda")
    x = torch.sign(x) * (1 + x.abs()) + 0.5

    def affine(*shape):
        sign = torch.where(torch.rand(shape, generator=gen, device="cuda")
                           < 0.5, -1.0, 1.0)
        g = sign * (0.5 + torch.rand(shape, generator=gen, device="cuda"))
        u = torch.rand(shape, generator=gen, device="cuda") * 0.4 - 0.2
        return g, g * u

    g2, b2 = strided_affine(*affine(b, c))
    g1, b1 = affine(c)
    g1, b1 = g1.abs(), b1 * g1.sign()
    dy = torch.randn((b, h, w, c), generator=gen, device="cuda")
    return {"x": x.to(dtype), "g2": g2, "b2": b2, "g1": g1, "b1": b1,
            "dy": dy.to(dtype)}


def affine_of(name, a):
    return {"instance_norm": [], "adain": [a["g2"], a["b2"]],
            "whole_layer_norm": [a["g1"], a["b1"]]}[name]


def kernel_graph(norms, name, a, relu):
    """(y, inputs) of the kernel's forward with its autograd graph."""
    x = a["x"].detach().requires_grad_(True)
    aff = [t.detach().requires_grad_(True) for t in affine_of(name, a)]
    return getattr(norms, name)(x, *aff, relu), [x, *aff]


def plain_graph(norms, name, a, relu):
    x = a["x"].detach().requires_grad_(True)
    aff = [t.detach().requires_grad_(True) for t in affine_of(name, a)]
    return getattr(norms, name + "_plain")(x, *aff, relu), [x, *aff]


def plain_backward(norms, name, a, relu):
    fn = getattr(norms, name + "_backward_plain")
    out = fn(a["x"], *affine_of(name, a), a["dy"], relu)
    return list(out) if isinstance(out, tuple) else [out]


def library_backward(name, a, instance=False):
    """Autograd backward of one PyTorch call for the same norm, on NCHW
    copies (its preferred layout), the calls of ``library``; the port
    never calls it."""
    x = a["x"].permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    dy = a["dy"].permute(0, 3, 1, 2).contiguous()
    b, c, h, w = x.shape
    if name == "instance_norm" and instance:
        y, inputs = F.instance_norm(x), [x]
    elif name == "instance_norm":
        y = F.batch_norm(x.view(1, b * c, h, w), None, None, None, None,
                         True, 0.1, 1e-5).view(b, c, h, w)
        inputs = [x]
    elif name == "adain":
        g = a["g2"].reshape(-1).to(x.dtype).detach().requires_grad_(True)
        bt = a["b2"].reshape(-1).to(x.dtype).detach().requires_grad_(True)
        y = F.batch_norm(x.view(1, b * c, h, w), None, None, g, bt, True,
                         0.1, 1e-5).view(b, c, h, w)
        inputs = [x, g, bt]
    else:
        g = a["g1"].to(x.dtype).detach().requires_grad_(True)
        bt = a["b1"].to(x.dtype).detach().requires_grad_(True)
        y, inputs = F.group_norm(x, 1, g, bt, 1e-5), [x, g, bt]
    return lambda: torch.autograd.grad(y, inputs, dy, retain_graph=True)


def bwd_bound(name, a):
    """Read x and dy once, write dx once; the affine rows and their grads."""
    x = a["x"]
    nbytes = 3 * x.numel() * x.element_size()
    nbytes += 4 * sum(t.numel() * 4 for t in affine_of(name, a))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = BWD_FLOPS_PER_ELEMENT * x.numel() / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def close(got, want, dtype):
    """f32: rtol 1e-4 and 1e-4 of the largest |want| (summation order);
    bf16: two bf16 ulps of it. Returns the max abs error."""
    scale = want.float().abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 2 * 2**-8
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol * scale + tol * want.float().abs()).all())
    return err.max().item(), ok


def direct_backward(norms, name, a, relu, split=False):
    """The backward launcher alone, on the forward kernels' stats: the
    device work of one backward call through the Function."""
    aff = affine_of(name, a) or [None, None]
    whole = name == "whole_layer_norm"
    stats = norms._launch(name, a["x"], *aff, relu, whole)[1]
    return lambda: norms._launch_backward(name, a["x"], stats, *aff, a["dy"],
                                          relu, whole, split=split)


def backward_phase(norms):
    """Each backward kernel against the plain closed form and autograd of
    the plain forward, at every norm shape of the training path, f32 and
    bf16, ReLU on and off; the split design held against the same
    references and two runs held bitwise equal. Timed (ReLU off; the
    launcher alone, as the Function calls it) against the byte bound, the
    plain closed form and one library call's autograd backward (f32), and
    the split design in the same run."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    flush = torch.empty(100 * 2**20 // 4, device="cuda")
    err = {}   # (wrapper, design, dtype): largest error against plain
    times = {}
    for name, calls in BWD_CALLS.items():
        for mult, h, w, c in calls:
            for b in (mult * bb for bb in BATCHES):
                for dtype in (torch.float32, torch.bfloat16):
                    dname = str(dtype).split(".")[1]
                    a = gap_inputs(b, h, w, c, dtype, gen)
                    design = design_of(norms, name, a["x"], tiles=2)
                    shape_err = 0.0
                    for relu in (False, True):
                        y, inputs = kernel_graph(norms, name, a, relu)
                        got = [("kernel", torch.autograd.grad(y, inputs,
                                                              a["dy"]))]
                        split = direct_backward(norms, name, a, relu,
                                                split=True)()
                        got.append(("split design", split))
                        once = direct_backward(norms, name, a, relu)
                        first, second = once(), once()
                        yp, ip = plain_graph(norms, name, a, relu)
                        auto = torch.autograd.grad(yp, ip, a["dy"])
                        closed = plain_backward(norms, name, a, relu)
                        torch.cuda.synchronize()
                        check(y.grad_fn is not None
                              and got[0][1][0].dtype == dtype,
                              f"{name}: no grad_fn or dx dtype differs")
                        check(all(
                            torch.equal(p, q) for p, q in zip(first, second)
                            if p is not None),
                            f"{name} bwd {(b, h, w, c)} {dname}: two runs "
                            "differ")
                        for who, grads in got:
                            for want, what in ((closed, "closed form"),
                                               (auto, "autograd of plain")):
                                for part, g_, w_ in zip(
                                        ("dx", "dgamma", "dbeta"), grads,
                                        want):
                                    e, ok = close(g_, w_, dtype)
                                    shape_err = max(shape_err, e)
                                    check(ok, f"{name} bwd {(b, h, w, c)} "
                                              f"{dname} relu={relu} {part}: "
                                              f"{who} differs from {what} "
                                              f"by {e}")
                    row = {"kernel": name + "_bwd", "shape": [b, h, w, c],
                           "dtype": dname, "max_abs_err": shape_err,
                           "design": design,
                           "ms": time_ms(direct_backward(norms, name, a,
                                                         False), flush),
                           "split_ms": time_ms(direct_backward(
                               norms, name, a, False, split=True), flush),
                           "library_ms": time_ms(library_backward(name, a),
                                                 flush)}
                    if name == "instance_norm":
                        row["instance_norm_ms"] = time_ms(
                            library_backward(name, a, instance=True), flush)
                    row["bound_ms"], row["bound_by"] = bwd_bound(name, a)
                    if dtype == torch.float32:
                        row["plain_ms"] = time_ms(
                            lambda: plain_backward(norms, name, a, False),
                            flush)
                        times[(name, mult, h, w, c, b)] = row
                    key = (name, design, dname)
                    err[key] = max(err.get(key, 0.0), shape_err)
                    emit(phase="backward_kernel", **row)
                    del a
    return err, times


# The LN's affine gradients sum over the batch and every pixel (up to 4 M
# values a channel at (16, 256, 256, 64)), so float32 sums in any order
# carry 1e-7 or more of their magnitude; the limit against float64 is about
# three times the plain float32 version's own error there (3.4e-7 on an
# H100 80GB HBM3).
LN_F64_SHAPES = ((16, 256, 256, 64), (16, 128, 128, 128))
LN_F64_TOL = 1e-6


def ln_f64_phase(norms):
    """The LN backward (f32, the wide decodes' batch 16) against a float64
    closed form: the kernel's, the split design's and the plain f32
    version's largest errors in dx, dgamma and dbeta, relative to each
    gradient's largest magnitude. The kernel's must stay within
    LN_F64_TOL."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    for shape in LN_F64_SHAPES:
        a = gap_inputs(*shape, torch.float32, gen)
        args = (a["x"], a["g1"], a["b1"], a["dy"])
        for relu in (False, True):
            ref = norms.whole_layer_norm_backward_plain(
                *(t.double() for t in args), relu)
            stats = norms._launch("whole_layer_norm", a["x"], a["g1"],
                                  a["b1"], relu, True)[1]
            runs = {split: norms._launch_backward(
                "whole_layer_norm", a["x"], stats, a["g1"], a["b1"], a["dy"],
                relu, True, split=split) for split in (False, True)}
            runs = {"kernel": runs[False], "split design": runs[True],
                    "plain f32": norms.whole_layer_norm_backward_plain(
                        *args, relu)}
            row = {}
            for who, grads in runs.items():
                row[who] = {part: ((g.double() - r).abs().max()
                                   / r.abs().max()).item()
                            for part, g, r in zip(("dx", "dgamma", "dbeta"),
                                                  grads, ref)}
            emit(phase="ln_backward_vs_f64", shape=list(shape), relu=relu,
                 tol=LN_F64_TOL, rel_err=row,
                 note="largest |error| over the gradient's largest |value|")
            check(max(row["kernel"].values()) <= LN_F64_TOL,
                  f"LN backward {shape} relu={relu}: {row['kernel']}")
        del a


# ----------------------------------------------------------------- phase 7

SEG_SHAPE = (2, 256, 256, 3)
# Card (TF32 off) against the CPU: the logits of seeded random weights grow
# through 16 residual blocks to hundreds, so the 1e-3 is taken of the
# largest |logit| where that exceeds 1 (float32 sums over 36 convs in
# another order).
SEG_TOL = 1e-3


def segmenter_phase(ResNet34_8s, seg_preprocess):
    """The frozen ResNet34-8s at SEG_SHAPE on the card against the CPU."""
    parity_mode(True)
    net = ResNet34_8s().frozen_on("cpu")
    net.init(torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 7)
    x = torch.rand(SEG_SHAPE, generator=g) * 2 - 1
    with torch.no_grad():
        want = net(seg_preprocess(x))
        got = net.frozen_on("cuda")(seg_preprocess(x.cuda())).cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).double().mean())
    tol = SEG_TOL * max(1.0, scale)
    emit(phase="segmenter_card_vs_cpu", shape=list(SEG_SHAPE), tf32=False,
         max_abs_err=err, logit_scale=scale, tol=tol,
         pseudo_label_agreement=agree, finite=bool(torch.isfinite(got).all()))
    check(tuple(got.shape) == SEG_SHAPE[:3] + (19,) and
          bool(torch.isfinite(got).all()), "segmenter logits malformed")
    check(err <= tol, f"segmenter logits differ from the CPU by {err}")


# ----------------------------------------------------------------- phase 8

TRAIN_ITERS = 15        # bench.py's cadence: 12 dis, 3 fused, 1 classifier_sr


def step_launches(conf):
    """Forward and backward launches of one step of each kind at wide 1
    (train/trainer.py): a content encode runs 1 + n_downsample + 2 n_res IN,
    a decode 2 n_res AdaIN and n_downsample LN. A dis step encodes both
    domains and decodes one batch per domain; a fused step does that twice
    (the second encode and decode are the re-encode and the cycle) and runs
    every norm backward; a classifier_sr step encodes both domains. At
    config_256: 22 IN, 16 AdaIN, 4 LN; 44, 32, 8 each way; 22 IN."""
    g = conf["gen"]
    enc = 1 + g["n_downsample"] + 2 * g["n_res"]
    dec = {"adain": 2 * g["n_res"], "whole_layer_norm": g["n_downsample"]}
    dis = {"instance_norm": 2 * enc, **{k: 2 * v for k, v in dec.items()}}
    fused = {k: 2 * v for k, v in dis.items()}
    fused.update({k + "_bwd": v for k, v in fused.items()})
    return {"dis": dis, "fused": fused,
            "classifier_sr": {"instance_norm": 2 * enc}}


# Card (TF32 off) against CPU, relative L2 error per gradient leaf. At full
# width, ReLU masks flip on last-ulp differences and float32 sums run over
# ~40 layers; phase 9 also prints each float32 run's error against a
# float64 CPU run, the yardstick for this tolerance.
GRAD_TOL = 2e-2
# The bf16 leg: the card's bf16 gradients against float64 within this
# factor of the CPU's bf16 gradients against float64 (worst and median
# leaf). bf16 rounding moves ReLU masks and L1 signs, so two bf16 runs in
# different summation orders differ by about as much as each differs from
# float64.
BF16_VS_CPU = 1.5


def cadence(conf, iters):
    """Steps of each kind over ``iters`` iterations of bench.py's loop."""
    ad = conf["adaptation"]
    fused = sum((it + 1) % conf["ratio_disc_gen"] == 0 for it in range(iters))
    cls = sum((it + 1) % ad["classif_frequency"] == 0 for it in range(iters))
    return {"dis": iters - fused, "fused": fused, "classifier_sr": cls}


def expected_launches(norms, conf, steps):
    want = {k: 0 for k in norms.launches}
    per_step = step_launches(conf)
    for kind, n in steps.items():
        for k, per in per_step[kind].items():
            want[k] += n * per
    return want


def train_inputs(b, seed):
    """Seeded images in [-1, 1] and masks (30 % ones) on the card."""
    g = torch.Generator().manual_seed(seed)
    x_a, x_b = (torch.rand((b, 256, 256, 3), generator=g) * 2 - 1
                for _ in range(2))
    m_a, m_b = ((torch.rand((b, 256, 256, 1), generator=g) > 0.7).float()
                for _ in range(2))
    return [t.cuda() for t in (x_a, x_b, m_a, m_b)]


def new_trainer(MUNITTrainer, conf, device):
    tr = MUNITTrainer(conf, device)
    tr.init(torch.Generator().manual_seed(SEED))
    return tr


def set_numerics(numerics):
    """The numerics of a run: "tf32_off" (parity: f32 operands and
    activations, TF32 off), "tf32" (the same with TF32 on) or "bf16"
    (bench.py's production mode: bf16 conv operands and activations)."""
    from munit_tpu_torch.core import ops
    ops.set_conv_compute(torch.bfloat16 if numerics == "bf16" else None)
    parity_mode(numerics != "tf32")


def numerics_inputs(batch, numerics):
    """The images in bf16 for the bf16 mode (bench.py's BENCH_ACT_BF16);
    the masks stay f32."""
    if numerics != "bf16":
        return batch
    return [batch[0].bfloat16(), batch[1].bfloat16(), *batch[2:]]


def training_phase(norms, MUNITTrainer, train_steps, conf, b,
                   numerics="tf32"):
    """15 iterations at batch b on the card in the given numerics, every
    loss finite, the semantic loss above 0 in every gen step, the wrappers'
    launches as the cadence predicts (the segmenter adds none), in bf16
    every one of them on a bf16 x."""
    set_numerics(numerics)
    tr = new_trainer(MUNITTrainer, conf, "cuda")
    batch = numerics_inputs(train_inputs(b, SEED + b), numerics)
    torch.cuda.reset_peak_memory_stats()
    norms.reset_launches()
    t0 = time.perf_counter()
    metrics = train_steps(tr, *batch, range(TRAIN_ITERS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, copies = dict(norms.launches), dict(norms.dy_copies)
    on_bf16 = dict(norms.bf16_launches)
    by_design = {k: dict(v) for k, v in norms.design_launches.items()}
    steps = cadence(conf, TRAIN_ITERS)
    want = expected_launches(norms, conf, steps)
    want_design = designs_of_calls(norms, want, PATH_DESIGN_SHARE)
    values = {k: float(v) for m in metrics for k, v in m.items()}
    finite = all(np.isfinite(float(v)) for m in metrics for v in m.values())
    sem = [float(m["loss_sem_seg"]) for m in metrics if "loss_sem_seg" in m]
    want_bf16 = want if numerics == "bf16" else {k: 0 for k in want}
    emit(phase="train_card", batch=b, numerics=numerics,
         iterations=TRAIN_ITERS, steps=steps, semantic_w=conf["semantic_w"],
         seconds_incl_first_calls=wall, launches=launches, expected=want,
         launches_by_design=by_design, expected_by_design=want_design,
         launches_on_bf16_x=on_bf16, dy_copies=copies, finite=finite,
         loss_sem_seg=sem,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30,
         losses_first={k: float(v) for k, v in metrics[4].items()},
         losses_last={k: float(v) for k, v in metrics[-1].items()})
    check(finite, f"batch {b}: a loss is not finite: {values}")
    check(len(sem) == steps["fused"] and all(v > 0 for v in sem),
          f"batch {b}: loss_sem_seg {sem} in {steps['fused']} gen steps")
    check(launches == want, f"batch {b}: launches {launches}, want {want}")
    check(by_design == want_design,
          f"batch {b}: launches by design {by_design}, want {want_design}")
    check(on_bf16 == want_bf16,
          f"batch {b} {numerics}: launches on bf16 x {on_bf16}, want "
          f"{want_bf16}")
    return tr, batch, by_design


def leaf_errors(got, want, zero):
    """[(relative L2 error, relative max-abs error, name)] per gradient
    leaf outside ``zero``, largest L2 first."""
    rows = []
    for k, w in want.items():
        if k not in zero:
            e = got[k].double() - w.double()
            rows.append(((e.norm() / w.double().norm()).item(),
                         (e.abs().max() / w.double().abs().max()).item(), k))
    return sorted(rows, reverse=True)


def fused_grads(MUNITTrainer, conf, batch, device, numerics="tf32_off",
                f64=False):
    """One fused step's gradients (dis_gen_grads) of a freshly seeded
    trainer on ``device`` in the given numerics ("tf32_off", "tf32",
    "bf16"), with its pseudo-labels: ({name: CPU tensor}, labels, the
    trainer, seconds)."""
    set_numerics(numerics)
    tr = new_trainer(MUNITTrainer, conf, device)
    b = numerics_inputs([t.to(device) for t in batch], numerics)
    if f64:
        for net in (tr.gen.module, tr.dis_a, tr.dis_b, tr.classifier_sr_a,
                    tr.classifier_sr_b, tr.segmenter):
            net.double()
        b = [t.double() for t in b]
    with torch.no_grad():
        labels = [t.cpu() for t in tr._semantic_targets(*b[:2])]
    t0 = time.perf_counter()
    gd, gg = tr.dis_gen_grads(*b)
    grads = {k: v.cpu() for k, v in {**gd, **gg}.items()}
    seconds = time.perf_counter() - t0
    set_numerics("tf32_off")
    return grads, labels, tr, seconds


def error_summary(got, want, zero):
    rows = leaf_errors(got, want, zero)
    return {"max_rel_l2": rows[0][0], "worst_leaf": rows[0][2],
            "median_rel_l2": float(np.median([r[0] for r in rows])),
            "max_rel_maxabs": max(r[1] for r in rows)}


def flips(a, b):
    return sum(int((x != y).sum()) for x, y in zip(a, b))


def grads_phase(MUNITTrainer, conf, removed_by_norm):
    """One fused step's gradients (dis_gen_grads) at batch 1 with the
    semantic term, leaf by leaf, in three numerics on the card:
    - TF32 off against the CPU in float32: the relative L2 error within
      GRAD_TOL; the conv biases that a norm removes (exact gradient 0)
      below 1e-5 of the net's largest gradient;
    - TF32 on, against the float64 CPU run and the TF32-off card run: its
      worst leaf against float64 no larger than the bf16 leg's (TF32 keeps
      three more mantissa bits);
    - bf16 (bench.py's production mode) against the port's bf16 mode on
      the CPU and against float64: the card no farther from float64 than
      BF16_VS_CPU times the CPU's bf16 run, on the worst leaf and the
      median one. A bf16 run's error against float64 is the mode's own; it
      has no bound.
    Every float32 run is held against a float64 CPU run, and each leg's
    pseudo-labels against the CPU's in the same numerics: a flip moves one
    pixel's CE term."""
    batch = [t.cpu() for t in train_inputs(1, SEED + 100)]
    runs = {}
    for name, device, numerics in (("card", "cuda", "tf32_off"),
                                   ("card_tf32", "cuda", "tf32"),
                                   ("card_bf16", "cuda", "bf16"),
                                   ("cpu", "cpu", "tf32_off"),
                                   ("cpu_bf16", "cpu", "bf16")):
        grads, labels, tr, seconds = fused_grads(MUNITTrainer, conf, batch,
                                                 device, numerics)
        runs[name] = {"grads": grads, "labels": labels, "seconds": seconds}
        del tr
        torch.cuda.empty_cache()
    grads, labels, cpu, _ = fused_grads(MUNITTrainer, conf, batch, "cpu",
                                        f64=True)
    runs["cpu_f64"] = {"grads": grads, "labels": labels}
    zero = removed_by_norm(cpu)
    got, want, ref = (runs[k]["grads"] for k in ("card", "cpu", "cpu_f64"))
    net = max(v.abs().max().item() for v in want.values())
    worst_zero = max(max(got[k].abs().max().item(), want[k].abs().max().item())
                     for k in zero) / net
    summary = {name: error_summary(runs[a]["grads"], runs[b]["grads"], zero)
               for name, a, b in (("card_vs_cpu", "card", "cpu"),
                                  ("card_vs_f64", "card", "cpu_f64"),
                                  ("cpu_vs_f64", "cpu", "cpu_f64"))}
    emit(phase="grads_card_vs_cpu", batch=1, leaves=len(want),
         semantic_w=conf["semantic_w"],
         pseudo_label_flips=flips(runs["card"]["labels"],
                                  runs["cpu"]["labels"]),
         pseudo_labels=sum(t.numel() for t in runs["cpu"]["labels"]),
         tol_rel_l2=GRAD_TOL, norm_removed_biases=len(zero),
         their_max_over_net=worst_zero, their_tol=1e-5,
         cpu_f32_seconds=runs["cpu"]["seconds"], **summary)
    worst = summary["card_vs_cpu"]
    check(worst["max_rel_l2"] <= GRAD_TOL, f"card grads differ from CPU: {worst}")
    check(worst_zero <= 1e-5, f"norm-removed bias grads: {worst_zero}")

    legs = {
        "tf32": {
            "vs_f64": error_summary(runs["card_tf32"]["grads"], ref, zero),
            "vs_tf32_off": error_summary(runs["card_tf32"]["grads"], got,
                                         zero),
            "pseudo_label_flips_vs_cpu": flips(runs["card_tf32"]["labels"],
                                               runs["cpu"]["labels"])},
        "bf16": {
            "vs_cpu_bf16": error_summary(runs["card_bf16"]["grads"],
                                         runs["cpu_bf16"]["grads"], zero),
            "vs_f64": error_summary(runs["card_bf16"]["grads"], ref, zero),
            "cpu_bf16_vs_f64": error_summary(runs["cpu_bf16"]["grads"], ref,
                                             zero),
            "pseudo_label_flips_vs_cpu_bf16": flips(
                runs["card_bf16"]["labels"], runs["cpu_bf16"]["labels"]),
            "pseudo_label_flips_vs_cpu_f32": flips(
                runs["card_bf16"]["labels"], runs["cpu"]["labels"]),
            "cpu_bf16_seconds": runs["cpu_bf16"]["seconds"]},
    }
    emit(phase="grads_legs", batch=1, bf16_vs_cpu_factor=BF16_VS_CPU, **legs)
    tf32, bf16 = legs["tf32"]["vs_f64"], legs["bf16"]
    check(tf32["max_rel_l2"] <= bf16["vs_f64"]["max_rel_l2"],
          f"TF32-on worst leaf {tf32} above the bf16 leg's {bf16['vs_f64']}")
    for key in ("max_rel_l2", "median_rel_l2"):
        check(bf16["vs_f64"][key]
              <= BF16_VS_CPU * bf16["cpu_bf16_vs_f64"][key],
              f"card bf16 {key} against float64 {bf16['vs_f64'][key]}, the "
              f"CPU's bf16 {bf16['cpu_bf16_vs_f64'][key]}")
    parity_mode(False)


def host_ms(fn, reps):
    """Median host ms of fn over reps runs, each ending in a synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


def train_time_phase(tr, batch, conf, b, numerics="tf32"):
    """Training time at batch b in the given numerics: each step kind, the
    5-iteration cycle (4 dis, 1 fused), images/s as bench.py counts them
    (batch x iterations / seconds, the classifier_sr step included once per
    15), peak memory, and a profile of one fused step."""
    set_numerics(numerics)
    x_a, x_b, m_a, m_b = batch
    lamb = conf["adaptation"]["dfeat_lambda"]
    reps = 5 if b == 1 else 3
    dis_ms, _ = host_ms(lambda: tr.dis_update(x_a, x_b), reps)
    fused_ms, _ = host_ms(lambda: tr.dis_gen_update(x_a, x_b, m_a, m_b), reps)
    cls_ms, _ = host_ms(lambda: tr.domain_classifier_sr_update(
        x_a, x_b, False, lamb), reps)

    def cycle():
        for _ in range(4):
            tr.dis_update(x_a, x_b)
        tr.dis_gen_update(x_a, x_b, m_a, m_b)
    cycle_ms, rounds = host_ms(cycle, reps)
    per_it = cycle_ms / 5
    bench_ips = b * TRAIN_ITERS / ((3 * cycle_ms + cls_ms) / 1e3)
    emit(phase="train_time", batch=b, numerics=numerics,
         ms_per_iteration=per_it,
         cycle_ms=cycle_ms, cycle_rounds_ms=rounds, dis_step_ms=dis_ms,
         fused_step_ms=fused_ms, classifier_sr_step_ms=cls_ms,
         images_per_s_cycle=b * 5 / (cycle_ms / 1e3),
         images_per_s_bench=bench_ips,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30,
         note="median of host-clock rounds, each ending in a synchronise")
    rows, wall = device_profile(
        lambda: tr.dis_gen_update(x_a, x_b, m_a, m_b), 3)
    in_step = check_norm_kernels(rows, conf, b, numerics)
    busy = sum(r[0] for r in rows)
    emit(phase="train_profile", batch=b, numerics=numerics,
         step="fused dis+gen",
         profiled_wall_ms=wall, unprofiled_ms=fused_ms,
         device_busy_ms=busy if rows else "not measured",
         device_idle_share=(1 - busy / fused_ms) if rows else "not measured",
         by_group_ms=grouped(rows),
         top=[{"ms": r[0], "calls_per_step": r[2], "kernel": r[1][:90]}
              for r in rows[:15]])
    seg = segmenter_split(tr, batch, b, reps, fused_ms, busy, numerics)
    return {"ms_per_iteration": per_it, "images_per_s": bench_ips,
            "cls_ms": cls_ms, "segmenter": seg, "norm_kernels": in_step}


# The kernel each design launches first, forward and backward: one per call
# (the split design's is its first of three or four).
FIRST_KERNELS = {"cluster": ("norm_cluster_fwd", "norm_cluster_bwd"),
                 "grid": ("norm_grid_fwd", "norm_grid_bwd"),
                 "split": ("norm_partials", "norm_bwd_partials")}


def check_norm_kernels(rows, conf, b, numerics):
    """In a fused step's profile: one cluster kernel per AdaIN call and per
    IN call at the smallest resolution, each way; one grid kernel per other
    IN call and per LN call (step_launches' counts), each way; no split
    kernel. That is one one-launch norm kernel per norm call each way.
    Returns each kernel's device ms per fused step and per call."""
    g = conf["gen"]
    fused = step_launches(conf)["fused"]
    enc = 1 + g["n_downsample"] + 2 * g["n_res"]
    small_in = fused["instance_norm"] // enc * (1 + 2 * g["n_res"])
    want = {"cluster": fused["adain"] + small_in,
            "grid": fused["instance_norm"] - small_in
            + fused["whole_layer_norm"],
            "split": 0}
    got, ms = {}, {}
    for design, kernels in FIRST_KERNELS.items():
        for kernel in kernels:
            got[kernel] = sum(r[2] for r in rows if kernel in r[1])
            ms[kernel] = sum(r[0] for r in rows if kernel in r[1])
            check(got[kernel] == want[design],
                  f"batch {b} fused step: {got[kernel]} {kernel} launches, "
                  f"want {want[design]}")
    calls = fused["instance_norm"] + fused["adain"] + fused["whole_layer_norm"]
    check(want["cluster"] + want["grid"] == calls,
          f"batch {b}: {calls} norm calls a fused step, {want} one-launch")
    per_call = {k: ms[k] / got[k] for k in got if got[k]}
    emit(phase="train_norm_kernels", batch=b, numerics=numerics,
         per_fused_step=got, expected=want, one_launch_kernels_each_way=calls,
         ms_per_fused_step=ms, ms_per_call=per_call)
    return {"launches": got, "ms": ms, "ms_per_call": per_call}


def segmenter_split(tr, batch, b, reps, fused_ms, fused_busy_ms, numerics):
    """The segmenter's part of a fused step at batch b, timed and profiled
    apart: its targets pass over [x_a | x_b] (no gradient) and its loss
    pass over two translations with the backward to them. The frozen net
    must launch no weight-gradient kernel."""
    x_a, x_b, m_a, m_b = batch
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    fakes = [(torch.rand(x_a.shape, generator=g, device="cuda") * 2 - 1)
             .to(x_a.dtype) for _ in range(2)]
    targets = tr._semantic_targets(x_a, x_b)

    def loss_grad():
        x_ab, x_ba = (f.detach().requires_grad_(True) for f in fakes)
        loss = tr._semantic_loss_pair(x_ab, x_ba, targets, m_a, m_b)
        return torch.autograd.grad(loss, [x_ab, x_ba])

    targets_ms, _ = host_ms(lambda: tr._semantic_targets(x_a, x_b), reps)
    loss_ms, _ = host_ms(loss_grad, reps)
    rows, _ = device_profile(
        lambda: (tr._semantic_targets(x_a, x_b), loss_grad()), 2)
    busy = sum(r[0] for r in rows)
    wgrad = [r[1][:90] for r in rows if "wgrad" in r[1].lower()]
    dgrad = [r[1][:90] for r in rows if "dgrad" in r[1].lower()]
    out = {"targets_ms": targets_ms, "loss_fwd_bwd_ms": loss_ms,
           "share_of_fused_step": (targets_ms + loss_ms) / fused_ms,
           "device_busy_ms": busy,
           "device_share_of_fused_step": busy / fused_busy_ms
           if fused_busy_ms else "not measured"}
    emit(phase="train_segmenter", batch=b, numerics=numerics, **out,
         wgrad_kernels=wgrad, dgrad_kernels=len(dgrad),
         by_group_ms=grouped(rows),
         top=[{"ms": r[0], "calls_per_step": r[2], "kernel": r[1][:90]}
              for r in rows[:8]],
         note="targets: one no-grad pass over 2B images; loss: one pass "
              "over 2B translations and its backward to them")
    check(not wgrad, f"the frozen segmenter launched wgrad kernels: {wgrad}")
    return out


# ---------------------------------------------------------- bench_torch


BENCH_ENV = {"BENCH_BATCH": "8", "BENCH_ITERS": "30"}


def bench_phase():
    """bench_torch.py as a subprocess at batch 8 and 30 timed iterations,
    in bf16 (its default) and in f32 (TF32 off): each must exit 0 and end
    with its JSON line, echoed here."""
    import os
    out = {}
    for numerics, knobs in (("bf16", {}),
                            ("f32", {"BENCH_BF16": "0",
                                     "BENCH_ACT_BF16": "0"})):
        env = dict(os.environ, **BENCH_ENV, **knobs)
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")],
                             cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(run.returncode == 0,
              f"bench_torch.py {numerics}: rc {run.returncode}: "
              f"{run.stderr[-2000:]}")
        line = json.loads(run.stdout.strip().splitlines()[-1])
        check(line["numerics"] == numerics and line["value"] > 0,
              f"bench_torch.py {numerics}: {line}")
        emit(phase="bench_torch", knobs={**BENCH_ENV, **knobs},
             seconds=wall, result=line,
             stderr=run.stderr.strip().splitlines()[-8:])
        out[numerics] = line
    return out


# ---------------------------------------------------------------- phase 10

# (H, W, C) of every whole-LN probe shape, the batches the probes use
PROBE_SHAPES = ((16, 256, 256, 64), (16, 128, 128, 128), (8, 256, 256, 64))
SUMS_FLOPS_PER_ELEMENT = 2      # an add and a multiply-add
AFFINE_FLOPS_PER_ELEMENT = 5    # subtract, two multiplies, add, ReLU


def moments_bound(nbytes, elements, flops_per_element):
    """The larger of the bytes moved (each input read once, each output
    written once) at HBM rate and the f32 operations at the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops_per_element * elements / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sums_close(got, want, a, b):
    """Each sum within 1e-5 of the sum of the magnitudes it adds (float32
    sums of up to 4 M values in another order). Returns the max abs error,
    the max error relative to that sum of magnitudes, and the verdict."""
    af = a.float().flatten(1)
    bf = af if b is None else b.float().flatten(1)
    scale = torch.stack([af.abs().sum(1), (af * bf).abs().sum(1)], 1)
    err = (got - want).abs()
    return (float(err.max()), float((err / scale).max()),
            bool((err <= 1e-5 * scale).all()))


def moments_phase(moments):
    """sample_sums (moments and the a·b form) and sample_affine against
    their plain versions at every probe shape, f32 and bf16, ReLU on and
    off; each timed (ReLU off) against the byte bound, the plain version
    and one library call: torch.var_mean for the sums, the broadcast torch
    expression for the apply."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    flush = torch.empty(100 * 2**20 // 4, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    times, err = {}, {}
    for shape in PROBE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            b, c = shape[0], shape[3]
            x = (torch.randn(shape, generator=gen, device="cuda") * 2
                 + 0.5).to(dtype)
            y = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            # both kernels take 16-byte vectors here: the sums have no row
            # of channels to respect, the apply's C is a multiple of them
            vecs = [moments.plan(b, x[0].numel(), x.element_size(),
                                 x.data_ptr() | y.data_ptr(), sms, ch)[0]
                    for ch in (None, c)]
            check(all(v * x.element_size() == 16 for v in vecs),
                  f"moments plan {shape} {dname}: vectors {vecs}")
            e_sums = rel_sums = 0.0
            for other in (None, y):
                got = moments.sample_sums(x, other)
                want = moments.sample_sums_plain(x, other)
                e, rel, ok = sums_close(got, want, x, other)
                e_sums, rel_sums = max(e_sums, e), max(rel_sums, rel)
                check(ok and got.shape == (b, 2), f"sample_sums {shape} "
                      f"{dname} b={other is not None}: differs by {e}")
            mean = torch.randn(b, generator=gen, device="cuda") * 0.5
            inv = torch.rand(b, generator=gen, device="cuda") + 0.5
            gamma = torch.rand(c, generator=gen, device="cuda")
            beta = torch.randn(c, generator=gen, device="cuda") * 0.1
            e_aff = 0.0
            for relu in (False, True):
                got = moments.sample_affine(x, mean, inv, gamma, beta, relu)
                want = moments.sample_affine_plain(x, mean, inv, gamma, beta,
                                                   relu)
                e_aff = max(e_aff, float((got.float() - want.float())
                                         .abs().max()))
                # f32: FMA contraction; bf16: one bf16 ulp
                rtol, atol = ((1e-5, 1e-5) if dtype == torch.float32
                              else (2**-7, 3e-2))
                check(got.dtype == dtype and torch.allclose(
                    got.float(), want.float(), rtol=rtol, atol=atol),
                    f"sample_affine {shape} {dname} relu={relu}: {e_aff}")
            torch.cuda.synchronize()
            xf_lib = lambda: torch.var_mean(x.float(), (1, 2, 3))  # noqa: E731
            lib_aff = lambda: ((x.float() - mean[:, None, None, None])  # noqa: E731
                               * inv[:, None, None, None] * gamma
                               + beta).to(dtype)
            x_bytes = x.numel() * x.element_size()
            for name, fn, plain, lib, bnd, e in (
                    ("sample_sums", lambda: moments.sample_sums(x),
                     lambda: moments.sample_sums_plain(x), xf_lib,
                     moments_bound(x_bytes + 8 * b, x.numel(),
                                   SUMS_FLOPS_PER_ELEMENT), e_sums),
                    ("sample_affine",
                     lambda: moments.sample_affine(x, mean, inv, gamma, beta),
                     lambda: moments.sample_affine_plain(x, mean, inv, gamma,
                                                         beta),
                     lib_aff,
                     moments_bound(2 * x_bytes + 8 * b + 8 * c, x.numel(),
                                   AFFINE_FLOPS_PER_ELEMENT), e_aff)):
                row = {"kernel": name, "shape": list(shape), "dtype": dname,
                       "vec": vecs[name == "sample_affine"],
                       "ms": time_ms(fn, flush), "plain_ms": time_ms(plain, flush),
                       "library_ms": time_ms(lib, flush),
                       "bound_ms": bnd[0], "bound_by": bnd[1],
                       "max_abs_err": e}
                if name == "sample_sums":
                    row["max_rel_err"] = rel_sums
                times[(name, shape, dname)] = row
                err[(name, dname)] = max(err.get((name, dname), 0.0), e)
                emit(phase="moments_kernel", **row)
            del x, y
    return err, times


# ---------------------------------------------------------------- phase 11

PROBE_K, PROBE_REPS = 3, 2
# Each variant's error against the plain v1: P1 (bf16 outputs) two bf16
# ulps of the output's scale; P2 (f32) 1e-4 of it; P3 1e-4 of the largest
# plain input gradient of the LN + ReLU (f32, one upstream gradient).
PROBE_TOL = {"P1": 2 * 2**-8, "P2": 1e-4, "P3": 1e-4}


def probe_phase(moments, norms, normprobe):
    """The three probes on the card, each variant's time and error, and the
    moments kernels' launches in each probe (the counts set to 0 just
    before it)."""
    dev = torch.device("cuda")
    launched = {}
    rows = []
    for probe, fn, shapes in (
            ("P1", normprobe.probe_p1, normprobe.P1_SHAPES),
            ("P2", normprobe.probe_p2, normprobe.P2_SHAPES),
            ("P3", normprobe.probe_p3, normprobe.P3_SHAPE)):
        moments.reset_launches()
        norms.reset_launches()
        got = fn(dev, shapes, PROBE_K, PROBE_REPS)
        torch.cuda.synchronize()
        launched[probe] = {**moments.launches,
                           **{k: v for k, v in norms.launches.items() if v}}
        for r in got:
            emit(phase="probe", **r)
        rows += got
        emit(phase="probe_launches", probe=probe, launches=launched[probe])
    for r in rows:
        err = r.get("max_err_vs_plain")
        check(np.isfinite(r["ms"]) and r["ms"] > 0, f"probe row {r}")
        if err is not None:
            scale = r.get("plain_scale", 1.0)
            check(err <= PROBE_TOL[r["probe"]] * scale,
                  f"probe {r['probe']} {r['variant']} {r['shape']}: "
                  f"error {err}")
    check(launched["P1"]["sample_sums"] and launched["P1"]["sample_affine"]
          and launched["P2"]["sample_sums"] and launched["P3"]["sample_sums"],
          f"a probe missed a moments kernel: {launched}")
    ln_device_times(moments, norms)
    return rows, launched


def ln_device_times(moments, norms):
    """P1's question in device time alone (the K-chains above include the
    host's launches): per whole-LN probe shape and type, the identity+scale
    floor, v0 (the three Welford kernels of norms.cu) and v3 (sample_sums,
    the coefficients in torch, sample_affine), each after an L2 flush,
    against the one-read-one-write bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    flush = torch.empty(100 * 2**20 // 4, device="cuda")
    for shape in PROBE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            c = shape[3]
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.rand(c, generator=gen, device="cuda")
            b = torch.randn(c, generator=gen, device="cuda") * 0.01
            emit(phase="probe_device", shape=list(shape),
                 dtype=str(dtype).split(".")[1],
                 floor_ms=time_ms(lambda: x * 1.0009, flush),
                 v0_ms=time_ms(lambda: norms.whole_layer_norm(x, g, b), flush),
                 v3_ms=time_ms(lambda: moments.whole_layer_norm(x, g, b),
                               flush),
                 bound_ms=2 * x.numel() * x.element_size()
                 / HBM_BYTES_PER_S * 1e3,
                 note="device ms, L2 flushed; bound: read x once, write y "
                      "once")
            del x


# --------------------------------------------------------------------- main


def removed_by_norm(trainer):
    """Names of the generator's conv biases that an IN or AdaIN removes."""
    from munit_tpu_torch.nn.blocks import ConvBlock
    return {f"{n}.conv.bias" for n, m in trainer.gen.module.named_modules()
            if isinstance(m, ConvBlock) and m.norm_type in ("in", "adain")}


def norms_designs(rows):
    """The designs of a wrapper's path calls, cluster first."""
    return sorted({r["design"] for _, r in rows})


# The whole-LN probes' Pallas kernels: (row, wrapper, probe, dtype of the
# timed call, the TPU kernel it replaces)
PROBE_KERNELS = (
    ("P1a", "sample_sums", "P1", "bfloat16", "tools/normprobe.py:97"),
    ("P1b", "sample_affine", "P1", "bfloat16", "tools/normprobe.py:128"),
    ("P2", "sample_sums", "P2", "float32", "tools/normprobe2.py:114"),
    ("P3a", "sample_sums", "P3", "float32", "tools/normprobe3.py:65"),
)


def kernel_table(err, times, bwd_err, bwd_times, launches, train_launches,
                 mom_err, mom_times, probe_launches):
    """The kernel line: one entry per wrapper and design (the cluster and
    the grid kernels of a wrapper are separate kernels), forward and
    backward, then the moments kernels of the probes."""
    def total(rows, key):
        return sum(n * row[key] for n, row in rows)

    def bound_by(rows):
        return ("bytes" if all(r["bound_by"] == "bytes" for _, r in rows)
                else "operations")

    def entry(name, design, rows, errs, **kw):
        kernel = FIRST_KERNELS[design][name.endswith("_bwd")]
        out = {"name": f"{name} [{kernel}]", "route": "cuda",
               "source": SOURCE, **kw,
               "max_abs_err": errs[(name.removesuffix("_bwd"), design,
                                    "float32")],
               "max_abs_err_bf16": errs[(name.removesuffix("_bwd"), design,
                                         "bfloat16")],
               "ms": total(rows, "ms"), "split_ms": total(rows, "split_ms"),
               "plain_ms": total(rows, "plain_ms"),
               "bound_ms": total(rows, "bound_ms"), "bound_by": bound_by(rows),
               "library_ms": total(rows, "library_ms")}
        if name.removesuffix("_bwd") == "instance_norm":
            out["instance_norm_library_ms"] = total(rows, "instance_norm_ms")
        if all("copy_ms" in r for _, r in rows):
            out["copy_ms"] = total(rows, "copy_ms")
        return out

    kernels = []
    for name, calls in PATH_CALLS.items():
        rows = [(n, times[(name, 1, *hwc, "float32")])
                for hwc, n in calls.items()]
        for design in norms_designs(rows):
            mine = [(n, r) for n, r in rows if r["design"] == design]
            kernels.append(entry(
                name, design, mine, err,
                replaces=REPLACES[name][0], also_replaces=REPLACES[name][1],
                launches=launches[name][design],
                launches_train=train_launches["tf32"][name][design],
                launches_train_bf16=train_launches["bf16"][name][design],
                per="one translated image: its calls of this design at "
                    "batch 1, float32; split_ms: the split design's time "
                    "for the same calls (the was); library_ms: one PyTorch "
                    "call of the same function (IN and AdaIN: F.batch_norm "
                    "on the (1, B C, H, W) view); launches: translate run "
                    "(phase 4), launches_train(_bf16): 15 training "
                    "iterations at batch 1 with TF32 (in bf16; phase 8)"))
    for name, calls in BWD_CALLS.items():
        rows = [(n, bwd_times[(name, *key, key[0])])
                for key, n in calls.items()]
        for design in norms_designs(rows):
            mine = [(n, r) for n, r in rows if r["design"] == design]
            kernels.append(entry(
                name + "_bwd", design, mine, bwd_err,
                replaces=BWD_REPLACES[name], also_replaces=BWD_ALSO,
                launches=train_launches["tf32"][name + "_bwd"][design],
                launches_bf16=train_launches["bf16"][name + "_bwd"][design],
                per="one fused dis+gen step's backward calls of this design "
                    "at batch 1, float32; split_ms: the split design's "
                    "time for the same calls; launches(_bf16): 15 training "
                    "iterations at batch 1 with TF32 (in bf16; phase 8)"))
    for row, name, probe, dname, replaces in PROBE_KERNELS:
        t = mom_times[(name, PROBE_SHAPES[0], dname)]
        kernels.append({
            "name": f"{row} {name}", "route": "cuda", "source": MOMENTS_SOURCE,
            "replaces": replaces, "launches": probe_launches[probe][name],
            "max_abs_err": mom_err[(name, dname)],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "per": f"one call at {list(PROBE_SHAPES[0])} {dname}; launches: "
                   f"probe {probe} (phase 11); max_abs_err over every probe "
                   "shape (phase 10)",
        })
    return kernels


AB_CODE = """
import json, sys, tempfile, torch
sys.path.insert(0, ".")
import chip_smoke as c
from munit_tpu_torch.config import get_config
from munit_tpu_torch.io.weights import load_reference_checkpoint
from munit_tpu_torch.kernels import build
from munit_tpu_torch.nn.generator import GenBundle
build.build_all()
conf = get_config(str(c.CONFIG))
gen = GenBundle(conf, "cpu")
gen.init(torch.Generator().manual_seed(c.SEED))
with tempfile.TemporaryDirectory() as tmp:
    torch.save({"2": gen.state_dict()}, tmp + "/gen.pt")
    res = c.timing_phase(GenBundle, load_reference_checkpoint, conf,
                         tmp + "/gen.pt")
print(json.dumps({"ms_per_image": {f"batch {b}, tf32 {t}": v
                                   for (b, t), v in res.items()}}))
"""


def ab(trees) -> int:
    """Phase 5 of each checkout in ``trees``, in order, each in its own
    process with its own code."""
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", AB_CODE], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        check(out.returncode == 0, f"{tree}: {out.stderr[-2000:]}")
        emit(phase="ab_translate", tree=tree,
             **json.loads(out.stdout.strip().splitlines()[-1]))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--ab"]:
        return ab(sys.argv[2:])
    # a checkout of the repo: the port and its sources must be here
    from munit_tpu_torch.cli import translate
    from munit_tpu_torch.config import get_config, validate
    from munit_tpu_torch.io.weights import load_reference_checkpoint
    from munit_tpu_torch.kernels import build, moments, norms
    from munit_tpu_torch.nn.generator import GenBundle
    from munit_tpu_torch.nn.resnet import ResNet34_8s, seg_preprocess
    from munit_tpu_torch.tools import normprobe
    from munit_tpu_torch.train.trainer import MUNITTrainer, train_steps

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
    plan_phase(norms)
    budget_sweep(norms)
    err, times = kernel_phase(norms)
    one_kernel_phase(norms)
    golden_phase(norms, GenBundle, validate, load_reference_checkpoint)
    with tempfile.TemporaryDirectory() as tmp:
        conf, launches, ckpt = main_path_phase(norms, translate, GenBundle,
                                               get_config, Path(tmp))
        timing_phase(GenBundle, load_reference_checkpoint, conf, ckpt)

    parity_mode(True)
    bwd_err, bwd_times = backward_phase(norms)
    ln_f64_phase(norms)

    segmenter_phase(ResNet34_8s, seg_preprocess)

    train_conf = get_config(str(CONFIG))
    check(train_conf["semantic_w"] > 0, "config_256 trains with semantic_w")
    train_launches = {}
    for numerics in ("tf32", "bf16"):
        for b in BATCHES:
            tr, batch, counts = training_phase(
                norms, MUNITTrainer, train_steps, train_conf, b, numerics)
            train_launches.setdefault(numerics, counts)
            train_time_phase(tr, batch, train_conf, b, numerics)
            del tr, batch
            torch.cuda.empty_cache()
    grads_phase(MUNITTrainer, train_conf, removed_by_norm)
    bench_phase()

    parity_mode(True)
    mom_err, mom_times = moments_phase(moments)
    _, probe_launches = probe_phase(moments, norms, normprobe)

    print(json.dumps({"kernels": kernel_table(
        err, times, bwd_err, bwd_times, launches, train_launches, mom_err,
        mom_times, probe_launches)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
