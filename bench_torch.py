"""Benchmark: 256x256 MUNIT training throughput of the PyTorch port
(``munit_tpu_torch``) on one NVIDIA card, in images/sec/chip.

The workload is bench.py's, run through the port: configs/config_256.yaml's
shipped training (``gen_state 1``, ``guided 1``, ``semantic_w 3`` through the
frozen ResNet34-8s, the masked cycle loss, ``ratio_disc_gen 5``, the sim/real
classifier fool term at ``adv_lambda 6`` and its own update every
``classif_frequency 15`` iterations at ``dfeat_lambda 1``), in bench.py's
cadence (``munit_tpu_torch.train.trainer.train_steps``). Weights come from
``trainer.init`` with a torch.Generator seeded 0 (the segmenter's too), the
images and the mask from ``np.random.RandomState(0)`` as in bench.py.

Prints ONE JSON line last: {"metric", "value", "unit", "vs_baseline",
"numerics"}; vs_baseline is value / 20, bench.py's estimate of the PyTorch
reference on one H100. The card's name and power limit and the step times go
to stderr.

Knobs (bench.py's, with its defaults):
- BENCH_BATCH (8), BENCH_ITERS (150), BENCH_CROP (256), BENCH_TINY (0: the
  small widths of bench.py's smoke run);
- BENCH_BF16 (1): bf16 conv operands with f32 accumulation, norms, losses
  and the optimizer in f32 (``ops.set_conv_compute(torch.bfloat16)``); 0 is
  f32 with TF32 off;
- BENCH_ACT_BF16 (1): the images are fed in bf16, so the nets' activations
  run in bf16;
- BENCH_DEVICE (cuda): without a card the run exits non-zero; ``cpu`` runs
  the kernels' plain versions, for the smoke test only.
BENCH_MESH=auto and BENCH_REMAT are not ported and raise; BENCH_PARWARM has
nothing to warm (the port compiles no step). There is no retry: on the card
a retry would hide a failure.

    python3 bench_torch.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REFERENCE_H100_IMAGES_PER_SEC = 20.0
BATCH = int(os.environ.get("BENCH_BATCH", "8"))
WARMUP = 4
ITERS = int(os.environ.get("BENCH_ITERS", "150"))
CROP = int(os.environ.get("BENCH_CROP", "256"))
TINY = os.environ.get("BENCH_TINY", "0") == "1"
BF16 = os.environ.get("BENCH_BF16", "1") == "1"
ACT_BF16 = os.environ.get("BENCH_ACT_BF16", "1") == "1"
DEVICE = os.environ.get("BENCH_DEVICE", "cuda")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def spec():
    """bench.py's training spec (bench.py:78-93)."""
    out = {
        "gen_state": 1, "guided": 1, "semantic_w": 3, "recon_mask": 1,
        "batch_size": BATCH, "ratio_disc_gen": 5,
        "new_size": CROP, "crop_image_height": CROP, "crop_image_width": CROP,
        "adaptation": {"adv_lambda": 6, "dfeat_lambda": 1,
                       "classif_frequency": 15},
    }
    if TINY:
        out["gen"] = {"dim": 16, "mlp_dim": 32, "style_dim": 8,
                      "activ": "relu", "n_downsample": 2, "n_res": 2,
                      "pad_type": "reflect"}
        out["dis"] = {"dim": 16, "norm": "none", "activ": "lrelu",
                      "n_layer": 2, "gan_type": "lsgan", "num_scales": 2,
                      "pad_type": "reflect"}
    return out


def main():
    import torch

    if os.environ.get("BENCH_MESH", "off") == "auto":
        raise NotImplementedError(
            "BENCH_MESH=auto (data parallel) is not ported; ROADMAP queue 1 "
            "item 16")
    if os.environ.get("BENCH_REMAT", ""):
        raise NotImplementedError(
            "BENCH_REMAT is not ported; ROADMAP queue 1 item 13")
    if DEVICE not in ("cuda", "cpu"):
        raise SystemExit(f"bench_torch: BENCH_DEVICE must be cuda or cpu, "
                         f"got {DEVICE!r}")
    if ACT_BF16 and not BF16:
        raise SystemExit("bench_torch: BENCH_ACT_BF16=1 needs BENCH_BF16=1 "
                         "(bf16 images against f32 conv operands)")
    if DEVICE == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_torch: no CUDA card visible (BENCH_DEVICE=cpu "
                         "runs the smoke test's CPU path)")
    from munit_tpu_torch.config import validate
    from munit_tpu_torch.core import ops
    from munit_tpu_torch.train.trainer import MUNITTrainer, train_steps

    if DEVICE == "cuda":
        log("bench_torch: " + subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
    conf = validate(spec())
    # production numerics: bf16 conv operands, f32 accumulate and norms
    ops.set_conv_compute(torch.bfloat16 if BF16 else None)
    tr = MUNITTrainer(conf, DEVICE)
    tr.init(torch.Generator().manual_seed(0))

    rng = np.random.RandomState(0)
    act = torch.bfloat16 if ACT_BF16 else torch.float32
    x_a = torch.from_numpy(rng.randn(BATCH, CROP, CROP, 3)).to(DEVICE, act)
    x_b = torch.from_numpy(rng.randn(BATCH, CROP, CROP, 3)).to(DEVICE, act)
    mask = torch.from_numpy(
        (rng.rand(BATCH, CROP, CROP, 1) > 0.5).astype(np.float32)).to(DEVICE)
    ad = conf["adaptation"]

    def sync():
        if DEVICE == "cuda":
            torch.cuda.synchronize()

    def run(iterations):
        train_steps(tr, x_a, x_b, mask, mask, iterations)
        sync()

    log(f"bench_torch: batch {BATCH}, crop {CROP}, conv compute "
        f"{'bf16' if BF16 else 'f32 (TF32 off)'}, activations {act}, "
        f"device {DEVICE}")
    for kind, it in (("dis", 0), ("dis+gen", conf["ratio_disc_gen"] - 1),
                     ("dis+gen and classifier_sr",
                      ad["classif_frequency"] - 1)):
        sync()
        t0 = time.perf_counter()
        run([it])
        log(f"bench_torch: first {kind} step {time.perf_counter() - t0:.3f} s")
    run(range(WARMUP))
    sync()
    t0 = time.perf_counter()
    run(range(WARMUP, WARMUP + ITERS))
    dt = time.perf_counter() - t0
    log(f"bench_torch: {ITERS} iterations in {dt:.3f} s, "
        f"{dt / ITERS * 1e3:.3f} ms per iteration")
    if DEVICE == "cuda":
        log(f"bench_torch: peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    images_per_sec = BATCH * ITERS / dt
    print(json.dumps({
        "metric": "munit_256_train_images_per_sec_per_chip",
        "value": round(images_per_sec, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(images_per_sec / REFERENCE_H100_IMAGES_PER_SEC, 3),
        "numerics": "bf16" if BF16 else "f32",
    }), flush=True)


if __name__ == "__main__":
    main()
