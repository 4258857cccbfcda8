"""Smoke run of the PyTorch port (munit_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (exit code 1):
1. the card's name and power limit (nvidia-smi), and the build of every
   CUDA source of the port, one nvcc each, started together;
2. each norm kernel against its plain PyTorch version on the card, at every
   norm shape of the config_256 path, batch 1, 2, 4, 8, 10 and 16 (the
   wide decodes run at 2B; translate_batch's 10 styles at 10), f32 and
   bf16, ReLU on and off; each path shape's
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
   (2, 256, 256, 64) (a profile whose records the profiler lost is taken
   again), and the host µs per wrapper call of each design;
3. the golden fixture (tests/fixtures/golden_gen.npz) reproduced on the
   card through the kernels;
4. the main path: the translate CLI on the card at the full width of
   configs/config_256.yaml with seeded random weights (a style image and 4
   content images), the kernels' launch counts of that run, and the same
   translation on the CPU, which the card must match; the translate CLI
   again, as a user runs it, in a fresh process that sets no numerics
   (the CLI sets float32 with TF32 off itself), against the CPU within
   1e-4; then the same
   weights packed as the JAX package's bf16 inference .npz (written here
   with numpy), translated from that file on the card and on the CPU;
5. translation time per image at batch 1 and 8, TF32 off (the inference
   CLIs' numerics) and on, and a profile of where a translation spends
   its device time at each batch, TF32 off;
6. each backward kernel against the plain closed-form backward and against
   autograd of the plain forward, at every norm shape of the training path
   (the wide decodes at twice the batch), f32 and bf16, ReLU on and off;
   then kernel, plain backward, one library call's autograd backward (IN:
   the F.batch_norm view, F.instance_norm beside it) and the byte bound
   timed per shape, the split design beside it, two runs bitwise equal;
   and the LN backward at batch 16 against a float64 closed form; then
   (6b) each norm kernel design on the training path (cluster and grid,
   forward and backward, f32 and bf16) and the moments kernels run alone
   through the trainer's step graphs (train/graphs.py: eager, captured and
   replayed, replayed on other inputs), every output bit for bit equal to
   an eager call, and the launch counts by design those of as many eager
   calls;
7. the frozen ResNet34-8s segmenter (seeded random weights: the Cityscapes
   checkpoint is not in the repo) at (2, 256, 256, 3) on the card (TF32
   off) against the CPU, and the agreement of their pseudo-labels;
8. the training path: configs/config_256.yaml as it is (semantic_w 3),
   full width, seeded random weights, images and masks, first with TF32
   (f32 activations and operands) at batch 1 and then (8b) in bench.py's
   production bf16 mode (bf16 conv operands and images, every norm kernel
   on a bf16 x, which the launch counts assert) at batch 1 and 8; 15
   iterations in bench.py's cadence (12 dis steps, 3 fused dis+gen steps,
   1 classifier_sr step), as the trainer runs them on a
   card (each step kind eager at its first call, captured as a CUDA graph
   at its second, replayed after), with every loss finite,
   loss_sem_seg above 0, and the wrappers' launch counts asserted (the
   segmenter runs no norm kernel; replays counted); then training time at
   batch 1 and 8, eager and captured on the same trainer:
   each step kind, ms per iteration over the 5-iteration cycle,
   images/s as bench.py counts them, peak memory, the graphs and their
   capture seconds, a profile of one fused step eager and one replayed
   (each asserts 84 one-launch norm kernels each way: a cluster
   kernel per AdaIN and (64, 64, 256) IN call, a grid kernel per other IN
   and per LN call, and no split-design kernel, and times each of them
   inside the step), the wrappers' launches by design, and the segmenter's
   share (its targets pass and its
   loss forward and backward, timed and profiled apart: no weight-gradient
   kernel); then (8c) 15 iterations at batch 1 in parity numerics (TF32
   off, cuDNN deterministic), two eager trainers and a captured one in
   lockstep from one seeded state (each iteration from the first eager
   trainer's state, loaded in place): every loss an iteration takes
   before its own updates bit for bit; the state bit for bit where the
   two eager trainers' is, else its mean |difference| within twice
   theirs, and the losses taken after an update (the fused step's
   adversarial terms) within 1e-4 relative: the reflect pad's backward
   adds with atomics, which a repeated run of it shows; the graphs kept
   across the loads;
9. one fused step's gradients at batch 1, with the semantic term, on the
   card with TF32 off against the CPU, with TF32 on against float64, and in
   bf16 against the CPU's bf16 and float64, and the pseudo-label flips of
   each; then bench_torch.py at batch 8 and 30 iterations, bf16 and f32
   (the CPU's runs go on in a process of their own, started after the
   imports, beside phases 1-8, the card's runs and the bench);
10. the moments kernels (sample_sums, sample_affine) against their plain
   versions at every whole-LN probe shape, f32 and bf16, ReLU on and off,
   timed against the byte bound, the plain version and one library call;
11. the whole-LN probes P1, P2 and P3 (munit_tpu_torch.tools.normprobe) at
   their full shapes with a short chain, each variant's time and error,
   and the moments kernels' launches in each probe;
12. the train CLI: `python -m munit_tpu_torch train` in a subprocess on a
   copy of configs/config_256.yaml (bf16, semantic_w 3, full width) over 16
   seeded 286x286 JPEGs per domain with PNG masks, 20 iterations: every
   step logged and finite, loss_sem_seg above 0, the grids at 10 and 20,
   index.html, snapshots at 10 and 20, the norm launches of the cadence
   and the 8 sample grids by design, no PIL fallback, and the `--profile 2`
   trace of two replayed dis steps naming their norm kernels; `translate`
   from the
   step-20 snapshot; (b) resume at batch 1 in bf16 (extra_adam),
   captured: 11 iterations, a checkpoint, a trainer that has captured its
   steps restored bit for bit in place (its graphs kept) and 9 more
   against two uninterrupted runs of 20 (within twice their difference in
   the largest leaf), and the same resume with the anchor flag dropped,
   which the bit-for-bit check must catch; (c) the loop's images/s at
   batch 1 and 8 (captured steps; and eager) with its host stages, beside
   phase 8b's fixed-tensor time, the device idle share of a replayed fused
   step inside the loop, and the loader alone at batch 8 (decode cache, no
   cache, and the native image ops, which must run);
13. the sim→real path (ROADMAP item 11): the train CLI in bf16 on
   configs/final_test/FeatureDA.yaml, Output_DA.yaml and FeatureDA with
   the DANN and the seg head, 20 iterations each, the data keys and
   max_iter replaced (16 seeded 286x286 synthetic JPEG pairs whose B
   equals A outside a band, PNG masks, semantic PNGs in the table's gray
   values): every logged loss finite, the flavor's new losses logged,
   every step variant that ran twice captured and replayed as the cadence
   says, the norm launches by design; beside them, each step of an
   iteration with every sim→real step, card (TF32 off) against CPU at
   full width from one state, every loss within 1e-3 relative; a resume at iteration 10
   restored bit for bit with every new net; and ms per iteration (captured
   and eager), per step kind, peak memory and graphs of each flavor at
   batch 1 in bf16;
14. vanilla MUNIT (gen_state 0: two AdaINGen auto-encoders; guided 0:
   random styles; the VGG16 perceptual loss, its weights seeded): the
   train CLI in bf16 on the package defaults with vgg_w 1 and on
   config_256 with gen_state 0 and guided 0, 20 iterations each side by
   side over phase 12's JPEGs (phase 12's loop keys): every logged loss
   finite, the VGG terms above 0, every step variant that ran twice
   captured and replayed, the norm launches by design (a guided: 0 fused
   step: 124 forward, 104 backward); beside them, a dis, fused, gen and
   classifier_sr step, card (TF32 off) against CPU at full width from one state with
   the same explicit styles, every loss within 1e-3 relative; a resume at
   iteration 10 bit for bit, the style stream too, and the styles of
   iteration 11 equal to an uninterrupted run's; translate_batch with 10
   styles from the step-20 snapshot over the 16 JPEGs on the card, on the
   CPU over two of them within atol 1e-3, ms per image (the command and
   the model alone) and its launches; translate from that snapshot; and
   ms per iteration (captured and eager), per step kind, peak memory and
   graphs of each flavor at batch 1 in bf16;
15. configs/config_HD.yaml (512² crops) and grad_accum (ROADMAP 13, 13b):
   (a) each norm kernel at every HD path shape ((B, 512, 512, 64), (B,
   256, 256, 128), (B, 128, 128, 256); B = 1, 2, 4, 8), f32 and bf16: its
   plan (the grid design everywhere, fitting the card at once), forward
   and backward against the plain versions (and the split design; two
   runs bitwise), timed after an L2 flush against the byte bound, the
   plain version and one library call; (b) config_HD at its shipped batch
   1 in bf16, captured, narrow (wide 0, its default) and wide (1): the
   warm-up's norm launches by design and one replayed fused step's
   against the count from the code, ms per captured iteration and per
   step kind, peak memory and the graphs' pool; one fused step card (TF32
   off) against CPU at full width within 1e-3 relative; the train CLI on
   config_HD for 20 iterations over 16 seeded 600x600 JPEGs per domain
   (display_size 8 grids, snapshots, launches by design); (c) grad_accum
   at batch 8, bf16, captured: config_256 with K = 1, 2, 4 and config_HD
   (narrow) with K = 1, 2: ms per iteration, images/s, peak allocated
   eager, the graphs' pool and what is live (the pool must fall with K),
   and at K = 2 the captured fused step against the eager one within 1e-3;
16. evaluation (ROADMAP item 14) at config_256's full width, seeded
   generator and InceptionV3 (torchvision layout, .pth), 32 seeded JPEG
   pairs: the norm kernels' plans and forward checks at batch 32;
   translate+pool ms an image at batch 8 and 32 and the peak memory;
   Newton-Schulz's 400 iterations at 2048² timed, its FID against scipy's
   on one full-rank set; (a) compute_moments and evaluate fid --kid on the
   card (11 IN, 8 AdaIN, 2 LN launches per scored image) and the same
   commands on the CPU in a process beside it: FID and KID within 1e-3
   relative, the real pools within 1e-4 and the first batch's translated
   pools within 1e-3 of their largest magnitude, the set's FID against its
   own moments ~0; (b) translate_batch --num_style 3 --compute_IS
   --compute_CIS, card against CPU; (c) the train CLI in parity with
   eval_fid 1 (FID at each snapshot) beside two eval_fid 0 runs: replays
   equal, launches those of eval_fid 0 plus the FID translations, what
   the steps read (state, step scalars, graph inputs) bit for bit equal
   before and after each FID, the first iteration's losses bit for bit and
   every later one within 1e-5 relative (no two card runs are bitwise),
   and the logged FID that of evaluate fid on the last snapshot; (d) checkpoint_tools import → export
   → pack on the card; (e) a config_HD translation through the 512 → 299
   preprocessing and InceptionV3, card against CPU;
17. serving (ROADMAP 15) and the int8 tier (17's) at config_256's full
   width, seeded generator, two seeded JPEG styles, phase 12's JPEGs as
   requests: (a) the service in this process, max_batch 8: each bucket's
   CUDA graph (1, 2, 4, 8) against an eager call bit for bit, 11 IN, 8
   AdaIN and 2 LN launches a replay, ms a dispatch captured and eager; 16
   requests through the micro-batcher, their launches by design (the
   kernel line's ``launches_serve``) and within 1 uint8 step of the direct
   path; (b) `python -m munit_tpu_torch serve` in a process of its own,
   f32 and `--quant int8`: 64 POSTs from 1 and from 16 client threads,
   every answer 200 and 256x256, requests/s, p50/p99, the mean batch from
   /stats (above 1 under 16 clients), each process's launches by design;
   (c) the int8 product at its two config_256 sites, batch 8: int32 sums
   card against CPU bit for bit, timed against F.conv2d f32; `translate
   --quant int8` within 0.05 mean |d| of f32; int8 and f32 ms an image at
   batch 8; config_256 in bf16, captured, with MUNIT_INT8_DIS off and on
   (losses finite, dis steps replayed, ms); and, beside the card's work, a
   CPU service over 4 of the images, within 1 uint8 step of the card's;
18. the deployment artifact and UNIT (ROADMAP 17, 18) at config_256's full
   width, phase 4's seeded generator and images: (a) `checkpoint_tools
   export-aot` on the card three times, f32, bf16 and int8 (calibrated on
   phase 4's images and style), the seconds of each; (b) each artifact
   loaded in a fresh process that must import none of the port's `nn`,
   `config`, `cli` or `train`, translating at batch 1 and 8 from the one
   artifact: f32 within 1e-5 of the eager translation on the card (TF32
   off), bf16 and int8 (the artifact's scales) bit for bit; (c) the norm
   launches of each of those dispatches (11 IN, 8 AdaIN, 2 LN) beside the
   traced graph's operator nodes, its int8 products and convs; (d) `serve
   --artifact` (f32) for buckets 1-8 beside the config-built service on
   the same weights: each bucket's replay bit for bit against its eager
   call, its launches, the two services' replays within 1e-5, ms a
   dispatch captured and eager of both; (e) `translate_batch --trainer
   UNIT` (seeded VAE weights, slots a and b) over phase 12's 16 JPEGs on
   the card, its launches by design (17 cluster and 2 grid IN, 2 LN an
   image), ms an image (the command; the model alone), and the first two
   against the CPU's (run beside the card's work) within 1 uint8 step;
19. data parallel (ROADMAP 16; dist/mesh.py), config_256 as it is, four
   parts started together: (b) two processes on the one card in a gloo
   group (eager, TF32 off), 4 rows each of a batch of 8, against this
   process on the whole batch from the same seeded state: a dis, fused
   and classifier_sr step each, losses within 8c's post-update rtol, each
   updated net's weights past 1e-2 lr of the one-process update at most
   1 %, the classifiers' running statistics within the rtol of each
   vector's largest, the two ranks bit for bit; (c) `train --dist
   localhost:<port>,1,0` (NCCL) at full width with the segmenter, batch
   1, for 4 iterations and `--resume` to 6: each step logged once, the
   losses finite, snapshots at 2, 4, 6; (d) in this process after (b)'s
   reference, translate_batch's 10 decodes and the service's dispatch
   through ``Replicas([cuda:0, cuda:0])`` against one replica on the same
   parts, bit for bit, with their launches by design; and (a) a trainer
   in a world-1 NCCL group, captured, in lockstep with two plain captured
   trainers in 8c's test and numerics (batch 1, TF32 off), then, once (b)
   is done, the lockstep at batch 8 in bf16 (the post-update losses
   within 1e-3, DIST_BF16_POST_RTOL), its norm launches those of the
   cadence, and alone on the card once (c) is done, ms an iteration of
   each in turns, and a profile of a replayed dis, fused and fused +
   classifier_sr iteration, each with NCCL kernels (the gradient, metric
   and batch-norm means, ``ReduceOp.AVG``).
Earlier lines are JSON objects, each with ``at_s``, the seconds since the
script started. The line before the last is the kernel
table; the last is the status line. Without a CUDA card, or outside a
checkout of the repo, it exits non-zero and prints no result.

    python3 chip_smoke.py --ab TREE [TREE ...]

times translation (phase 5) in each given checkout of the repo, one fresh
process after another, with that checkout's own code: the same-call
comparison of two trees (parent, change, change, parent).

    python3 chip_smoke.py --sim2real

builds the kernels and runs phase 13 alone; ``--vanilla`` phase 14 alone;
``--hd`` phase 15 alone; ``--eval`` phase 16 alone; ``--serve`` phase 17
alone; ``--aot`` phase 18 alone; ``--dist`` phase 19 alone.

    python3 chip_smoke.py --host-us TREE [TREE ...]

times phase 2's host µs per wrapper call (no gradient: AdaIN at 64², IN
at 128², LN at 256²) in each given checkout, in turns with the direct
forward in the same process, one fresh process after another, with that
checkout's own code.

    python3 chip_smoke.py --cli-numerics TREE [TREE ...]

runs phase 4's fresh-process translation in each given checkout, against
this checkout's CPU translation of the same seeded weights and images.

    python3 chip_smoke.py --profiler [N]

counts how often torch.profiler loses the device records of phase 2's
one-kernel profiles, N profiles a step, without and with the idle that
``device_profile`` leaves at each end of its window.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
import zipfile
from collections import Counter
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


T0 = time.perf_counter()


def emit(**kw):
    """One JSON line; ``at_s``: seconds since the script started."""
    print(json.dumps({**kw, "at_s": time.perf_counter() - T0}), flush=True)


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
# The batches of the norm calls on the driven paths: 1 and 8 (phases 8
# and 12) and 2 (Output_DA's batch in phase 13), and twice each (the wide
# decodes), and 10 (translate_batch's 10-style decodes, phase 14): each
# one's plans are shown, and the forward kernels are held against plain at
# each of them, at 10 the AdaIN and LN calls alone (STYLE_BATCH_CALLS).
PLAN_BATCHES = (1, 2, 4, 8, 10, 16)
# The backward's per-call batches, times BWD_CALLS' multiplier
BWD_BATCHES = (1, 2, 8)
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


def plan_phase(norms, shapes=SHAPES, batches=PLAN_BATCHES,
               cluster_shape=CLUSTER_SHAPE, phase="plan"):
    """Each path shape's launch plan at each batch, forward (one tile) and
    backward (x and dy), for IN/AdaIN and for the LN: the cluster design's
    group, K, rows, shared memory and resident clusters; the grid design's
    segments, blocks, rows kept on chip, shared memory and blocks an SM
    holds. IN and AdaIN must take the cluster design at ``cluster_shape``
    (None: nowhere) and the grid design elsewhere, the LN the grid design
    everywhere, the split design nowhere; a grid must fit the card at
    once."""
    for tiles, way in ((1, "forward"), (2, "backward")):
        for dtype in DTYPES:
            for b in batches:
                for h, w, c in shapes:
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
                        emit(phase=phase, **row)
                        want = ("cluster" if not whole
                                and (h, w, c) == cluster_shape else "grid")
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


# translate_batch's decode of one image's 10 styles, the batch-10 calls of
# the driven paths: an AdaIN at 64², an LN at 128² and 256²
STYLE_BATCH_CALLS = {(64, 64, 256): ("adain",),
                     (128, 128, 128): ("whole_layer_norm",),
                     (256, 256, 64): ("whole_layer_norm",)}


def phase2_cases():
    for b in PLAN_BATCHES:
        for hwc in SHAPES:
            yield b, hwc, (STYLE_BATCH_CALLS[hwc] if b == 10
                           else tuple(PATH_CALLS))


def kernel_phase(norms, cases=None, seed=SEED, phase="kernel"):
    """Each forward kernel at each (batch, (H, W, C), wrappers) of
    ``cases`` (phase 2's by default), f32 and bf16, ReLU on and off,
    against its plain version, the split design too, two runs bitwise;
    timed after an L2 flush against its byte bound, the split design, a
    copy of x, one library call and (f32) the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(100 * 2**20 // 4, device="cuda")
    err = {}   # (wrapper, design, dtype): largest error against plain
    times = {}
    for b, (h, w, c), names in (phase2_cases() if cases is None else cases):
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
                emit(phase=phase, **row)
                del y
            del a
    return err, times


PROFILE_CALLS = 8
PROFILE_PAD_S = 0.01    # idle at each end of a profiler window
PROFILE_TAKES = 3       # profiles of a side-effect-free step, should the
                        # profiler lose its records
HOST_CALLS = 1000


# (wrapper, shape, forward kernel, backward kernel) profiled per call: one
# path shape of each design and norm kind.
ONE_KERNEL_CASES = (
    ("adain", (2, *CLUSTER_SHAPE), "norm_cluster_fwd", "norm_cluster_bwd"),
    ("instance_norm", (1, 128, 128, 128), "norm_grid_fwd", "norm_grid_bwd"),
    ("whole_layer_norm", (2, 256, 256, 64), "norm_grid_fwd", "norm_grid_bwd"),
)


def one_kernel_steps(norms, gen):
    """(name, shape, dtype, direction, step, kernel) of each
    ONE_KERNEL_CASES row, f32 and bf16: PROFILE_CALLS-worthy forward calls
    (no grad) and backward calls (autograd.grad through the wrapper's
    Function; AdaIN's gamma and beta strided slices as the generator passes
    them), each warmed up once. No step has a side effect."""
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
                yield name, shape, dtype, way, step, kernel
            del a, dy, y, inputs


def one_kernel_phase(norms):
    """One device kernel per call: PROFILE_CALLS calls of each
    one_kernel_steps step profiled; each call's window must hold exactly
    one device kernel, the design's (a profile whose records were lost is
    taken again, up to PROFILE_TAKES times). Then the host µs per call (a
    mean over HOST_CALLS calls, no synchronise) of each design's launcher,
    and of the public wrapper."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for name, shape, dtype, way, step, kernel in one_kernel_steps(norms, gen):
        for take in range(1, PROFILE_TAKES + 1):
            rows, _ = device_profile(step, PROFILE_CALLS)
            if not records_lost(rows, kernel):
                break
        per_call = [{"kernel": r[1][:90], "per_call": r[2]} for r in rows]
        emit(phase="one_kernel", kernel=name, direction=way,
             shape=list(shape), dtype=dtype_name(dtype),
             device_kernels=per_call, takes=take)
        check(len(rows) == 1 and kernel in rows[0][1] and rows[0][2] == 1,
              f"{name} {way} {list(shape)} {dtype_name(dtype)}: "
              f"device kernels per call {per_call}, want one {kernel}")
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


def records_lost(rows, kernel) -> bool:
    """A profile of calls that each launch ``kernel`` that shows nothing
    but fewer than one ``kernel`` a call: the profiler lost records (a
    lost record hides a kernel, it never adds one). One that shows
    another kernel is a reading."""
    return not rows or (len(rows) == 1 and kernel in rows[0][1]
                        and rows[0][2] < 1)


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

    # the fresh process runs beside the CPU translations here and in the
    # packed phase
    sub = unforced_start(ROOT, args, tmp / "sub")
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
    sub = unforced_finish(*sub, out_cpu)
    emit(phase="translate_unforced_subprocess", **sub)
    check(sub["max_abs_err"] <= UNFORCED_TOL,
          f"translate in a fresh process: card and CPU differ by "
          f"{sub['max_abs_err']}")
    check(not any(sub["flags_after"].values()),
          f"translate left TF32 on: {sub['flags_after']}")
    return conf, by_design, tmp / "gen.pt"


# The translate CLI as a user runs it: a fresh process that sets nothing,
# so the card's defaults (cuDNN's TF32 on) hold until the CLI sets its own
# numerics; its outputs into an .npy, the TF32 flags after it as JSON.
UNFORCED_RUNNER = """
import json, sys
import numpy as np, torch
from munit_tpu_torch.cli import translate
out = translate.main(sys.argv[2:])
np.save(sys.argv[1], np.stack(out))
print(json.dumps({"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                  "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}))
"""
# f32 with TF32 off reads ~2e-6 card against CPU; TF32 rounds each conv's
# operands to 10 mantissa bits, ~1e-3 of a value
UNFORCED_TOL = 1e-4


def unforced_start(tree, args, out: Path):
    """``translate`` of checkout ``tree`` on the card in a fresh process
    (UNFORCED_RUNNER), started: (tree, process, outputs file)."""
    proc = subprocess.Popen(
        [sys.executable, "-c", UNFORCED_RUNNER, f"{out}.npy", *args,
         "--output_folder", str(out), "--device", "cuda"],
        cwd=tree, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return tree, proc, Path(f"{out}.npy")


def unforced_finish(tree, proc, out: Path, cpu_outs) -> dict:
    """The started translation against ``cpu_outs``: the largest
    difference and the TF32 flags the process ended with."""
    stdout, stderr = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"{tree}: translate exit "
                                f"{proc.returncode}: {stderr[-3000:]}")
    got = np.load(out)
    return {"tree": str(tree), "images": len(got),
            "max_abs_err": max(float(np.abs(g - c).max())
                               for g, c in zip(got, cpu_outs)),
            "tol": UNFORCED_TOL,
            "flags_after": json.loads(stdout.strip().splitlines()[-1])}


def cli_numerics(trees) -> int:
    """``python3 chip_smoke.py --cli-numerics TREE ...``: phase 4's fresh-
    process translation in each given checkout, on this checkout's seeded
    weights and images, against this checkout's CPU translation; nothing
    checked, each reading emitted."""
    from munit_tpu_torch.cli import translate
    from munit_tpu_torch.config import get_config
    from munit_tpu_torch.nn.generator import GenBundle
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        gen = GenBundle(get_config(str(CONFIG)), "cpu")
        gen.init(torch.Generator().manual_seed(SEED))
        torch.save({"2": gen.state_dict()}, tmp / "gen.pt")
        write_images(tmp, np.random.RandomState(SEED))
        args = ["--checkpoint", str(tmp / "gen.pt"), "--config",
                str(CONFIG), "--input", str(tmp / "input"), "--style",
                str(tmp / "style.png")]
        cpu = translate.main(args + ["--output_folder", str(tmp / "cpu"),
                                     "--device", "cpu"])
        for i, tree in enumerate(trees):
            emit(phase="cli_numerics", **unforced_finish(
                *unforced_start(Path(tree).resolve(), args, tmp / f"sub{i}"),
                cpu))
    return 0


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
                     numerics="tf32" if tf32 else "f32, TF32 off (the "
                     "inference CLIs' own)",
                     ms_per_image=ms, rounds_ms_per_image=rounds, iters=iters,
                     note="encode_content + decode, style encoded once; "
                          "median of the rounds")
            parity_mode(True)
            profile(step, b, result[(b, False)], tf32=False)
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


def device_profile(step, reps, api=None):
    """[(device ms per step, kernel name, launches per step)] of ``reps``
    runs of ``step`` under torch.profiler, largest first, and the profiled
    host wall ms per step. ``api``: a dict that gets the host ms per step
    of each CUDA API call (where the host waits).

    The profiler keeps only the device records whose span, converted to
    the host's clock, lies inside its window; the kernels launched right
    after it starts or ending right before it stops can fall outside by
    the clocks' skew and be lost. PROFILE_PAD_S of idle on each side of
    the steps keeps them in."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        time.sleep(PROFILE_PAD_S)
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if dev > 0 and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            rows.append((dev / 1e3 / reps, ev.key, ev.count / reps))
        elif api is not None and ev.key.startswith("cu"):
            api[ev.key] = {"host_ms": ev.self_cpu_time_total / 1e3 / reps,
                           "calls": ev.count / reps}
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


def profile(step, b, ms_per_image, tf32):
    """Device time by kernel per image over 5 batch-b steps in the numerics
    set (``tf32`` says which); the idle share is against the unprofiled
    time per image."""
    for _ in range(3):
        step()
    rows, wall_ms = device_profile(step, 5)
    busy = sum(r[0] for r in rows) / b
    emit(phase="profile", batch=b, tf32=tf32,
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


def backward_phase(norms, bwd_calls=BWD_CALLS, batches=BWD_BATCHES,
                   seed=SEED + 6, phase="backward_kernel"):
    """Each backward kernel against the plain closed form and autograd of
    the plain forward, at every norm shape of ``bwd_calls`` (the training
    path's by default) times each of ``batches``, f32 and bf16, ReLU on
    and off; the split design held against the same references and two
    runs held bitwise equal. Timed (ReLU off; the launcher alone, as the
    Function calls it) against the byte bound, the plain closed form and
    one library call's autograd backward (f32), and the split design in
    the same run."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(100 * 2**20 // 4, device="cuda")
    err = {}   # (wrapper, design, dtype): largest error against plain
    times = {}
    for name, calls in bwd_calls.items():
        for mult, h, w, c in calls:
            for b in (mult * bb for bb in batches):
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
                    emit(phase=phase, **row)
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
    """Forward and backward launches of one step of each kind
    (train/trainer.py): a content encode runs 1 + n_downsample + 2 n_res
    IN, a decode 2 n_res AdaIN and n_downsample LN; the style encoders run
    no norm. A dis step encodes both domains and decodes one batch per
    domain. A fused step encodes both, decodes the recon and cross
    translations (one batch per domain when wide; a decode each when
    narrow: gen_state 0, or config_HD's 512² crops), re-encodes both,
    decodes the
    cycle if recon_x_cyc_w > 0 and, with guided 0, decodes D's own fakes
    without gradient; every other norm runs backward too. A classifier_sr
    step encodes both domains; a sample grid encodes both and decodes four
    times (guided) or six (guided 0: the display and the fresh styles). At
    config_256: 22 IN, 16 AdaIN, 4 LN; 44, 32, 8 each way; 22 IN; 22, 32,
    8."""
    g = conf["gen"]
    enc = 1 + g["n_downsample"] + 2 * g["n_res"]
    dec = {"adain": 2 * g["n_res"], "whole_layer_norm": g["n_downsample"]}

    def calls(encodes, decodes):
        return {"instance_norm": encodes * enc,
                **{k: decodes * v for k, v in dec.items()}}
    from munit_tpu_torch.train.trainer import wide_of
    cross = 2 if wide_of(conf) else 4
    cyc = 2 if conf["recon_x_cyc_w"] > 0 else 0
    fakes = 0 if conf["guided"] == 1 else 2
    fused = calls(4, cross + cyc + fakes)
    fused.update({k + "_bwd": v
                  for k, v in calls(4, cross + cyc).items()})
    return {"dis": calls(2, 2), "fused": fused,
            "classifier_sr": {"instance_norm": 2 * enc},
            "sample": calls(2, 4 if conf["guided"] == 1 else 6)}


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


def train_inputs(b, seed, size=256):
    """Seeded images in [-1, 1] and masks (30 % ones) on the card."""
    g = torch.Generator().manual_seed(seed)
    x_a, x_b = (torch.rand((b, size, size, 3), generator=g) * 2 - 1
                for _ in range(2))
    m_a, m_b = ((torch.rand((b, size, size, 1), generator=g) > 0.7).float()
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
    """15 iterations at batch b on the card in the given numerics, as the
    trainer runs them: each step kind eager at its first call, captured at
    its second, replayed after. Every loss finite, the semantic loss above
    0 in every gen step, the wrappers' launches as the cadence predicts
    (replays counted; the segmenter adds none), in bf16 every one of them
    on a bf16 x; one graph per step kind."""
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
         graphs=len(tr._graphs),
         capture_seconds={step_label(k): v
                          for k, v in tr._graphs.capture_seconds.items()},
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
    check(len(tr._graphs) == sum(n > 1 for n in steps.values()),
          f"batch {b}: {len(tr._graphs)} graphs for the steps {steps}")
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


# Phase 9's CPU runs (name, numerics, float64), in a process of their own
# (GRADS_CPU_RUNNER) started after the imports, beside phases 1-8 and
# phase 9's card runs and bench, on GRADS_CPU_THREADS of the host's 8 cores; each writes its gradients,
# pseudo-labels and step seconds to the file it is given.
GRADS_CPU_RUNS = (("cpu", "tf32_off", False), ("cpu_bf16", "bf16", False),
                  ("cpu_f64", "tf32_off", True))
GRADS_CPU_THREADS = 6
GRADS_CPU_RUNNER = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
from munit_tpu_torch.config import get_config
from munit_tpu_torch.train.trainer import MUNITTrainer
out, batch_file = sys.argv[1:3]
conf = get_config(str(c.CONFIG))
batch = torch.load(batch_file, weights_only=True)
runs = {}
for name, numerics, f64 in c.GRADS_CPU_RUNS:
    grads, labels, tr, seconds = c.fused_grads(MUNITTrainer, conf, batch,
                                               "cpu", numerics, f64)
    runs[name] = {"grads": grads, "labels": labels, "seconds": seconds}
    del tr
torch.save(runs, out)
"""


def grads_cpu_start(tmp: Path):
    """Starts phase 9's CPU runs on its batch; (process, batch, out file)."""
    batch = [t.cpu() for t in train_inputs(1, SEED + 100)]
    torch.save(batch, tmp / "grads_batch.pt")
    with open(tmp / "grads_cpu.err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", GRADS_CPU_RUNNER, str(tmp / "grads_cpu.pt"),
             str(tmp / "grads_batch.pt")],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=err,
            env={**os.environ, "OMP_NUM_THREADS": str(GRADS_CPU_THREADS)})
    return proc, batch, tmp / "grads_cpu.pt"


def grads_phase(MUNITTrainer, conf, removed_by_norm, cpu_side, meanwhile):
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
    pixel's CE term. The CPU runs come from ``cpu_side`` (grads_cpu_start);
    ``meanwhile`` runs after the card's runs, before they are waited for."""
    proc, batch, cpu_file = cpu_side
    runs = {}
    for name, device, numerics in (("card", "cuda", "tf32_off"),
                                   ("card_tf32", "cuda", "tf32"),
                                   ("card_bf16", "cuda", "bf16")):
        grads, labels, tr, seconds = fused_grads(MUNITTrainer, conf, batch,
                                                 device, numerics)
        runs[name] = {"grads": grads, "labels": labels, "seconds": seconds}
        zero = removed_by_norm(tr)
        del tr
        torch.cuda.empty_cache()
    meanwhile()
    rc = proc.wait(timeout=900)
    check(rc == 0, f"phase 9's CPU runs: exit {rc}: "
                   f"{cpu_file.with_suffix('.err').read_text()[-3000:]}")
    runs.update(torch.load(cpu_file, weights_only=True))
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


def step_times(tr, batch, conf, b, reps):
    """Host ms (median of rounds, each ending in a synchronise) of each
    step kind and of the 5-iteration cycle (4 dis, 1 fused), images/s as
    bench.py counts them (batch x iterations / seconds, the classifier_sr
    step included once per 15), and the peak memory of these runs."""
    x_a, x_b, m_a, m_b = batch
    lamb = conf["adaptation"]["dfeat_lambda"]
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dis_ms, _ = host_ms(lambda: tr.dis_update(x_a, x_b), reps)
    fused_ms, _ = host_ms(lambda: tr.dis_gen_update(x_a, x_b, m_a, m_b), reps)
    cls_ms, _ = host_ms(lambda: tr.domain_classifier_sr_update(
        x_a, x_b, False, lamb), reps)

    def cycle():
        for _ in range(4):
            tr.dis_update(x_a, x_b)
        tr.dis_gen_update(x_a, x_b, m_a, m_b)
    cycle_ms, rounds = host_ms(cycle, reps)
    return {"ms_per_iteration": cycle_ms / 5, "cycle_ms": cycle_ms,
            "cycle_rounds_ms": rounds, "dis_step_ms": dis_ms,
            "fused_step_ms": fused_ms, "classifier_sr_step_ms": cls_ms,
            "images_per_s_cycle": b * 5 / (cycle_ms / 1e3),
            "images_per_s_bench": b * TRAIN_ITERS
            / ((3 * cycle_ms + cls_ms) / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
            "peak_reserved_gb": torch.cuda.max_memory_reserved() / 2**30,
            "graph_pool_gb": tr._graphs.pool_bytes() / 2**30,
            "live_gb": torch.cuda.memory_allocated() / 2**30}


def step_label(key):
    return key[0] + (" extrapolate" if key[1] else "")


def train_time_phase(tr, batch, conf, b, numerics="tf32"):
    """Training time at batch b in the given numerics, eager and captured
    on the same trainer (its steps were captured by the training phase):
    each step kind, the 5-iteration cycle, images/s and peak memory of
    each (reserved: the graphs' pool is reserved, not allocated, between
    replays); the graphs and the seconds each took to capture; a profile
    of one fused step eager (which asserts its norm kernels) and one
    captured (its device busy time and idle share)."""
    set_numerics(numerics)
    x_a, x_b, m_a, m_b = batch
    reps = 5 if b == 1 else 3
    times = {}
    for mode, capture in (("eager", False), ("captured", True)):
        tr._capture = capture
        times[mode] = step_times(tr, batch, conf, b, reps)
    eager, captured = times["eager"], times["captured"]
    emit(phase="train_time", batch=b, numerics=numerics, **times,
         graphs=len(tr._graphs),
         capture_seconds={step_label(k): v
                          for k, v in tr._graphs.capture_seconds.items()},
         note="median of host-clock rounds, each ending in a synchronise; "
              "captured: replays of the graphs that the training phase "
              "captured, on the same trainer; peak_memory_gb: the most "
              "allocated during the mode's runs (a replay allocates only "
              "its outputs' copy); graph_pool_gb: what the graphs' one pool "
              "holds; live_gb: allocated after the runs (nets, optimizer "
              "state, the graphs' input and output buffers); reserved: the "
              "process's, after earlier phases")
    prof = {}
    for mode, capture in (("eager", False), ("captured", True)):
        tr._capture = capture
        for _ in range(PROFILE_TAKES):      # four steps a take
            tr.dis_gen_update(x_a, x_b, m_a, m_b)
            api = {}
            rows, wall = device_profile(
                lambda: tr.dis_gen_update(x_a, x_b, m_a, m_b), 3, api)
            if rows:
                break
        busy = sum(r[0] for r in rows)
        step_ms = times[mode]["fused_step_ms"]
        prof[mode] = {"rows": rows, "busy": busy, "wall": wall,
                      "idle": (1 - busy / step_ms) if rows
                      else "not measured",
                      "idle_profiled": (1 - busy / wall) if rows
                      else "not measured"}
        emit(phase="train_profile", batch=b, numerics=numerics,
             step="fused dis+gen", mode=mode,
             profiled_wall_ms=wall, unprofiled_ms=step_ms,
             device_busy_ms=busy if rows else "not measured",
             device_idle_share=prof[mode]["idle"],
             kernels_per_step=sum(r[2] for r in rows),
             host_api_ms=dict(sorted(api.items(),
                                     key=lambda kv: -kv[1]["host_ms"])[:5]),
             by_group_ms=grouped(rows),
             top=[{"ms": r[0], "calls_per_step": r[2], "kernel": r[1][:90]}
                  for r in rows[:15]])
    tr._capture = False
    in_step = check_norm_kernels(prof["eager"]["rows"], conf, b, numerics)
    in_graph = check_norm_kernels(prof["captured"]["rows"], conf, b,
                                  numerics, "captured")
    seg = segmenter_split(tr, batch, b, reps, eager["fused_step_ms"],
                          prof["eager"]["busy"], numerics)
    tr._capture = True
    return {"ms_per_iteration": captured["ms_per_iteration"],
            "images_per_s": captured["images_per_s_bench"],
            "eager_ms_per_iteration": eager["ms_per_iteration"],
            "eager_images_per_s": eager["images_per_s_bench"],
            "cls_ms": captured["classifier_sr_step_ms"], "segmenter": seg,
            "norm_kernels": in_step, "norm_kernels_captured": in_graph,
            "fused_idle_share": prof["captured"]["idle"],
            "fused_idle_share_profiled": prof["captured"]["idle_profiled"],
            "eager_fused_idle_share": prof["eager"]["idle"],
            "eager_fused_idle_share_profiled": prof["eager"]["idle_profiled"]}


# The kernel each design launches first, forward and backward: one per call
# (the split design's is its first of three or four).
FIRST_KERNELS = {"cluster": ("norm_cluster_fwd", "norm_cluster_bwd"),
                 "grid": ("norm_grid_fwd", "norm_grid_bwd"),
                 "split": ("norm_partials", "norm_bwd_partials")}


def check_norm_kernels(rows, conf, b, numerics, mode="eager"):
    """In a fused step's profile (eager, or its graph's replay): one
    cluster kernel per AdaIN call and per IN call at the smallest
    resolution, each way; one grid kernel per other IN call and per LN
    call (step_launches' counts), each way; no split kernel. That is one
    one-launch norm kernel per norm call each way. Returns each kernel's
    device ms per fused step and per call."""
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
                  f"batch {b} {mode} fused step: {got[kernel]} {kernel} "
                  f"launches, want {want[design]}")
    calls = fused["instance_norm"] + fused["adain"] + fused["whole_layer_norm"]
    check(want["cluster"] + want["grid"] == calls,
          f"batch {b}: {calls} norm calls a fused step, {want} one-launch")
    per_call = {k: ms[k] / got[k] for k in got if got[k]}
    emit(phase="train_norm_kernels", batch=b, numerics=numerics,
         mode=mode, per_fused_step=got, expected=want, one_launch_kernels_each_way=calls,
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


# ---------------------------------------------------------- captured steps

# (wrapper, shape) of each kernel design on the training path, captured
# alone: cluster at (B, 64, 64, 256), grid elsewhere and for every LN
CAPTURE_CASES = (("instance_norm", (1, 64, 64, 256), "cluster"),
                 ("adain", (2, 64, 64, 256), "cluster"),
                 ("instance_norm", (1, 128, 128, 128), "grid"),
                 ("instance_norm", (1, 256, 256, 64), "grid"),
                 ("whole_layer_norm", (1, 128, 128, 128), "grid"),
                 ("whole_layer_norm", (2, 256, 256, 64), "grid"))
CAPTURE_CALLS = 4   # through StepGraphs: eager, capture + replay, 2 replays


def captured_norm(norms, name, relu=True):
    """A norm's forward and its backward to x and the affine, as one step
    body of ``StepGraphs.run``."""
    def body(x, g, b, dy):
        a = {"x": x, "g2": g, "b2": b, "g1": g, "b1": b}
        y, inputs = kernel_graph(norms, name, a, relu)
        grads = torch.autograd.grad(y, inputs, dy)
        return {"y": y, **{f"d{i}": t for i, t in enumerate(grads)}}
    return body


def captured_moments(moments):
    def body(x, mean, inv, g, b):
        return {"sums": moments.sample_sums(x),
                "dots": moments.sample_sums(x, x),
                "y": moments.sample_affine(x, mean, inv, g, b, True)}
    return body


def bitwise(got, want):
    return all(g.keys() == w.keys() and all(
        g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]) for k in w)
        for g, w in zip(got, want))


def capture_phase(norms, moments, graphs):
    """Each norm kernel design alone (cluster, grid; forward and backward,
    f32 and bf16) and the moments kernels, run CAPTURE_CALLS times through
    ``train/graphs.py``'s StepGraphs (the first call eager on a side
    stream, the second captured and replayed, then replays, the last on
    other inputs): every output bit for bit equal to an eager call on the
    same inputs, and the launch counts by design those of as many eager
    calls."""
    rows = []
    for name, shape, design in CAPTURE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
            fixed = gap_inputs(*shape, dtype, gen)
            other = gap_inputs(*shape, dtype, gen)
            g, b = ((fixed["g2"], fixed["b2"]) if name == "adain"
                    else (fixed["g1"], fixed["b1"]))
            runs = [[fixed["x"], g, b, fixed["dy"]]] * (CAPTURE_CALLS - 1)
            runs.append([other["x"], *((other["g2"], other["b2"])
                                       if name == "adain" else
                                       (other["g1"], other["b1"])),
                         other["dy"]])
            body = captured_norm(norms, name)
            want = [body(*r) for r in runs]
            norms.reset_launches()
            steps = graphs.StepGraphs("cuda")
            got = [steps.run(("norm",), body, r) for r in runs]
            torch.cuda.synchronize()
            counts = {w: dict(norms.design_launches[w])
                      for w in (name, name + "_bwd")}
            want_counts = {w: {d: CAPTURE_CALLS * (d == design)
                               for d in norms.DESIGNS} for w in counts}
            row = {"wrapper": name, "shape": list(shape),
                   "dtype": dtype_name(dtype), "design": design,
                   "graphs": len(steps), "bitwise": bitwise(got, want),
                   "launches_by_design": counts}
            rows.append(row)
            emit(phase="capture_kernel", **row)
            check(row["bitwise"] and len(steps) == 1,
                  f"captured {name} {shape} {dtype}: not bitwise equal to "
                  f"eager")
            check(counts == want_counts, f"captured {name} {shape} {dtype}: "
                  f"launches {counts}, want {want_counts}")
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 71)
        shape = (2, *PROBE_SHAPES[0][1:])
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        mean, inv = (torch.rand(2, generator=gen, device="cuda")
                     for _ in range(2))
        g, b = (torch.randn(shape[-1], generator=gen, device="cuda")
                for _ in range(2))
        runs = [[x, mean, inv, g, b]] * (CAPTURE_CALLS - 1) + [
            [x * 2, mean, inv, g, b]]
        body = captured_moments(moments)
        want = [body(*r) for r in runs]
        moments.reset_launches()
        steps = graphs.StepGraphs("cuda")
        got = [steps.run(("moments",), body, r) for r in runs]
        torch.cuda.synchronize()
        counts = dict(moments.launches)
        want_counts = {"sample_sums": 2 * CAPTURE_CALLS,
                       "sample_affine": CAPTURE_CALLS}
        row = {"wrapper": "moments", "shape": list(shape),
               "dtype": dtype_name(dtype), "graphs": len(steps),
               "bitwise": bitwise(got, want), "launches": counts}
        rows.append(row)
        emit(phase="capture_kernel", **row)
        check(row["bitwise"], f"captured moments {dtype}: not bitwise")
        check(counts == want_counts,
              f"captured moments launches {counts}, want {want_counts}")
    norms.reset_launches()
    moments.reset_launches()
    return rows


def pad_backward_repeats(reps=8):
    """Distinct results of one reflect pad's backward (3 pixels, as the
    generator's 7x7 convs pad) run ``reps`` times on one input: its CUDA
    kernel adds the reflected gradients with atomics."""
    from munit_tpu_torch.core import ops
    gen = torch.Generator(device="cuda").manual_seed(SEED + 72)
    x = torch.randn((1, 256, 256, 64), generator=gen, device="cuda")
    dy = torch.randn((1, 262, 262, 64), generator=gen, device="cuda")
    distinct = []
    for _ in range(reps):
        xg = x.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(ops.pad2d(xg, 3, "reflect"), xg, dy)
        if not any(torch.equal(grad, d) for d in distinct):
            distinct.append(grad)
    return len(distinct)


# The losses of an iteration that it takes after one of its own updates:
# the fused step's adversarial terms and total (after its D update), and the
# classifier_sr step's loss when it follows a fused step (after the
# generator's update). Against another implementation of the same step the
# repo holds losses at rtol 1e-4 (tests/test_torch_train_cli.py).
POST_UPDATE = ("loss_gen_adv_a", "loss_gen_adv_b", "loss_gen_total")
POST_UPDATE_RTOL = 1e-4


def post_update(conf, cadence_steps, it):
    kinds = [k for k, _ in cadence_steps(conf, it)]
    if "dis_gen" not in kinds:
        return set()
    return set(POST_UPDATE) | ({"loss_classifier_sr"}
                               if "classifier_sr" in kinds else set())


def capture_parity_phase(MUNITTrainer, cadence_iteration, cadence_steps,
                         conf):
    """TRAIN_ITERS iterations of bench.py's cadence at batch 1 in parity
    numerics (TF32 off, cuDNN deterministic), in lockstep from one seeded
    state: before each iteration a second eager trainer and a captured
    one (each step kind eager at its first call, captured at its second,
    replayed after) take the first eager trainer's state in place, then
    all three run the iteration, so no difference carries into the next
    one. Every loss that an iteration takes before any of its own updates
    must be equal bit for bit. The reflect pad's backward adds with
    atomics (run repeatedly here, it shows how many results one input
    gives), so the updates may differ: the captured trainer's state must
    be bit for bit the first eager one's where the two eager trainers'
    are, and otherwise its mean |difference| over every element of the
    state, summed over the iterations, within twice theirs (the largest
    leaf's difference, a maximum over a few elements that the atomics
    pick at random, is printed); the losses taken after an update of the
    same iteration (POST_UPDATE) within POST_UPDATE_RTOL. The captured
    trainer keeps its graphs across the loads."""
    set_numerics("tf32_off")
    torch.backends.cudnn.deterministic = True
    batch = train_inputs(1, SEED + 1)
    from munit_tpu_torch.kernels import norms
    trainers = {}
    for name, capture in (("eager", False), ("eager_again", False),
                          ("captured", True)):
        tr = MUNITTrainer(conf, "cuda", _capture=capture)
        tr.init(torch.Generator().manual_seed(SEED))
        trainers[name] = tr
    eager = trainers["eager"]
    stats = {k: {"max_abs_leaf_diff": 0.0, "mean_abs_diff_sum": 0.0,
                 "bitwise_leaf_iterations": 0,
                 "pre_update_losses": 0, "pre_update_losses_differing": 0,
                 "post_update_max_rel_diff": 0.0, "losses_differing": []}
             for k in ("captured", "eager_again")}
    launches = {}
    for it in range(TRAIN_ITERS):
        for name in ("captured", "eager_again"):
            trainers[name].load_state_dict(eager.state_dict())
        out = {}
        for name, tr in trainers.items():
            tr.iterations = it
            norms.reset_launches()
            out[name] = cadence_iteration(tr, conf, it, *batch)
            launches.setdefault(name, Counter()).update(norms.launches)
        torch.cuda.synchronize()
        ref = state_leaves(eager)
        late = post_update(conf, cadence_steps, it)
        for name in ("captured", "eager_again"):
            st, m, w = stats[name], out[name], out["eager"]
            state = state_leaves(trainers[name])
            leaf = largest_difference(state, ref)
            st["max_abs_leaf_diff"] = max(st["max_abs_leaf_diff"], leaf)
            st["mean_abs_diff_sum"] += (
                sum((v - ref[0][k]).abs().sum().item()
                    for k, v in state[0].items())
                / sum(v.numel() for v in ref[0].values()))
            st["bitwise_leaf_iterations"] += leaf == 0
            for k in w:
                if k == "lr":
                    continue
                if not torch.equal(m[k], w[k]):
                    st["losses_differing"].append(
                        (it, k, float(m[k]), float(w[k])))
                if k in late:
                    st["post_update_max_rel_diff"] = max(
                        st["post_update_max_rel_diff"],
                        abs(float(m[k]) - float(w[k])) / abs(float(w[k])))
                else:
                    st["pre_update_losses"] += 1
                    st["pre_update_losses_differing"] += not torch.equal(
                        m[k], w[k])
    graphs = len(trainers["captured"]._graphs)
    distinct = pad_backward_repeats()
    got, noise = stats["captured"], stats["eager_again"]
    emit(phase="capture_parity", batch=1, numerics="tf32_off",
         cudnn_deterministic=True, iterations=TRAIN_ITERS,
         mode="lockstep: each iteration from the first eager trainer's state",
         graphs=graphs, captured_vs_eager=got, eager_vs_eager=noise,
         post_update_losses=list(POST_UPDATE) + ["loss_classifier_sr after "
                                                 "a fused step"],
         post_update_rtol=POST_UPDATE_RTOL,
         launches_equal=launches["captured"] == launches["eager"],
         reflect_pad_backward_distinct_results_of_8=distinct,
         note="pre-update losses bit for bit; the state bit for bit where "
              "eager_vs_eager is, else mean_abs_diff_sum (the state's mean "
              "|diff| over all its elements, summed over the iterations) "
              "within twice eager_vs_eager's; post-update losses within "
              "post_update_rtol")
    check(launches["captured"] == launches["eager"],
          f"captured launches {launches['captured']}, eager "
          f"{launches['eager']}")
    check(graphs == 2, f"{graphs} graphs after {TRAIN_ITERS} iterations of "
          f"loads: load_state_dict dropped the captured steps")
    check(got["pre_update_losses_differing"] == 0,
          f"losses before any update differ from eager's: {got}")
    check(got["post_update_max_rel_diff"] <= POST_UPDATE_RTOL,
          f"losses after an update differ from eager's: {got}")
    if noise["bitwise_leaf_iterations"] == TRAIN_ITERS:
        check(got["bitwise_leaf_iterations"] == TRAIN_ITERS,
              f"captured state differs from eager where eager is bitwise: "
              f"{got}")
    else:
        check(got["mean_abs_diff_sum"] <= 2 * noise["mean_abs_diff_sum"],
              f"captured {got} against eager-to-eager {noise}")
    torch.backends.cudnn.deterministic = False
    del eager, trainers
    torch.cuda.empty_cache()
    return got, noise


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
    and one library call: torch.var_mean for the sums; the apply has none
    (no one PyTorch call applies per-sample statistics and a per-channel
    affine; the broadcast expression is the plain version itself), so its
    library_ms is null."""
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
                     None,
                     moments_bound(2 * x_bytes + 8 * b + 8 * c, x.numel(),
                                   AFFINE_FLOPS_PER_ELEMENT), e_aff)):
                row = {"kernel": name, "shape": list(shape), "dtype": dname,
                       "vec": vecs[name == "sample_affine"],
                       "ms": time_ms(fn, flush), "plain_ms": time_ms(plain, flush),
                       "library_ms": time_ms(lib, flush) if lib else None,
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


# ---------------------------------------------------------------- phase 12

CLI_ITERS = 20
# config_256.yaml as it is but for these keys (and the data keys)
CLI_KEYS = {"max_iter": CLI_ITERS, "snapshot_save_iter": 10,
            "image_save_iter": 10, "image_display_iter": 5,
            "display_size": 2, "num_workers": 8}
DATA_IMAGES, DATA_SIZE = 16, 286   # per domain; 286 = 256 * 1.12
# `python -m munit_tpu_torch <args>` in this process, then the norm
# wrappers' launch counts and the image paths taken, into a JSON file
CLI_RUNNER = """
import json, runpy, sys
from munit_tpu_torch.data import transforms
from munit_tpu_torch.kernels import norms
out, sys.argv = sys.argv[1], ["munit_tpu_torch", *sys.argv[2:]]
try:
    runpy.run_module("munit_tpu_torch", run_name="__main__", alter_sys=True)
finally:
    with open(out, "w") as f:
        json.dump({"launches": norms.launches,
                   "launches_by_design": norms.design_launches,
                   "launches_on_bf16_x": norms.bf16_launches,
                   "image_paths": dict(transforms.paths)}, f)
"""
CLI_PROFILE = 2     # --profile: iterations 2-3, replays of the dis step
RESUME_ITERS, RESUME_SPLIT = 20, 11   # an odd split: mid-extrapolation
RESUME_WARM = 10    # iterations a trainer runs (and captures) before resume
# the loop's first 30 iterations dropped: each step kind's first call runs
# eagerly and its second captures (the classifier_sr step's at 14 and 29)
FEED_WARM, FEED_ITERS = 30, 60


def write_train_data(root: Path, size=DATA_SIZE) -> dict:
    """16 seeded random size x size (286) JPEGs per domain, binary PNG masks
    and their lists; returns the config's data keys (absolute paths)."""
    from PIL import Image
    rng = np.random.RandomState(SEED)
    root.mkdir(parents=True)
    keys = {}
    for dom in ("a", "b"):
        imgs, masks = [], []
        for i in range(DATA_IMAGES):
            img, mask = root / f"{dom}{i:02d}.jpg", root / f"{dom}{i:02d}.png"
            Image.fromarray(rng.randint(0, 256, (size, size, 3),
                                        np.uint8)).save(img, quality=90)
            Image.fromarray(((rng.rand(size, size) > 0.7) * 255)
                            .astype(np.uint8)).save(mask)
            imgs.append(str(img))
            masks.append(str(mask))
        for name, paths in ((f"{dom}.txt", imgs), (f"{dom}_seg.txt", masks)):
            (root / name).write_text("\n".join(paths) + "\n")
        keys.update({f"data_list_train_{dom}": str(root / f"{dom}.txt"),
                     f"data_list_test_{dom}": str(root / f"{dom}.txt"),
                     f"data_folder_train_{dom}": "/",
                     f"data_folder_test_{dom}": "/",
                     f"data_list_train_{dom}_seg":
                         str(root / f"{dom}_seg.txt")})
    return keys


def write_config(path: Path, data: dict, keys: dict) -> Path:
    """configs/config_256.yaml with the data keys and ``keys`` replaced."""
    import yaml
    raw = yaml.safe_load(CONFIG.read_text())
    raw.update(data)
    raw.update(keys)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(raw))
    return path


def sample_calls(conf, iters):
    """trainer.sample calls of the loop over ``iters`` iterations: test and
    train grids at image_save_iter, train_current at image_display_iter."""
    return sum(2 * ((it + 1) % conf["image_save_iter"] == 0)
               + ((it + 1) % conf["image_display_iter"] == 0)
               for it in range(iters))


def replayed_norm_kernels(trace: Path) -> dict:
    """Kernel events of each norm forward design in a chrome trace."""
    events = json.loads(trace.read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(k in n for n in names)
            for k in ("norm_cluster_fwd", "norm_grid_fwd")}


def cli_phase(norms, get_config, tmp: Path):
    """12(a): `python -m munit_tpu_torch train` on a copy of config_256
    (bf16, semantic_w 3, full width) over seeded JPEGs in a subprocess,
    its run directory and the norm launches by design; then `translate`
    from its step-20 snapshot through the module's entry point."""
    data = write_train_data(tmp / "data")
    cfg = write_config(tmp / "cli" / "config_256.yaml", data, CLI_KEYS)
    conf = get_config(str(cfg))
    counts_file = tmp / "cli_counts.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CLI_RUNNER, str(counts_file), "train",
         "--config", str(cfg), "--output_path", str(tmp / "cli"),
         "--profile", str(CLI_PROFILE)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"train CLI exit {proc.returncode}: {proc.stderr[-3000:]}")
    counts = json.loads(counts_file.read_text())
    run = tmp / "cli" / "outputs" / "config_256"
    lines = [json.loads(ln) for ln in (run / "metrics.jsonl").open()]
    losses = {m["step"]: m for m in lines if "loss_dis_total" in m}
    finite = all(np.isfinite(v) for m in losses.values()
                 for k, v in m.items() if k != "step")
    sem = [m["loss_sem_seg"] for m in losses.values() if "loss_sem_seg" in m]
    images = sorted(p.name for p in (run / "images").iterdir())
    want_images = sorted(f"gen_{d}_{k}.jpg" for d in ("a2b", "b2a")
                         for k in ("test_00000010", "train_00000010",
                                   "test_00000020", "train_00000020",
                                   "train_current"))
    from munit_tpu_torch.io import checkpoint
    snapshots = checkpoint.steps(str(run / "checkpoints"))
    steps = cadence(conf, CLI_ITERS)
    steps["sample"] = sample_calls(conf, CLI_ITERS)
    want = expected_launches(norms, conf, steps)
    want_bf16 = expected_launches(
        norms, conf, {k: v for k, v in steps.items() if k != "sample"})
    want_design = designs_of_calls(norms, want, PATH_DESIGN_SHARE)
    ips = [m["images_per_sec"] for m in lines if "images_per_sec" in m]
    traced = replayed_norm_kernels(run / "trace" / "trace.json")
    want_traced = designs_of_calls(
        norms, {k: CLI_PROFILE * n
                for k, n in step_launches(conf)["dis"].items()},
        PATH_DESIGN_SHARE)
    want_traced = {f"norm_{d}_fwd": sum(v[d] for v in want_traced.values())
                   for d in ("cluster", "grid")}
    emit(phase="train_cli_profile", iterations=[2, 1 + CLI_PROFILE],
         norm_kernels=traced, expected=want_traced,
         note="--profile: the trace of iterations 2-3, two replays of the "
              "dis step graph (captured at iteration 1); its norm forward "
              "kernels by name")
    check(traced == want_traced,
          f"--profile saw {traced} in replays, want {want_traced}")
    emit(phase="train_cli", seconds_incl_start=wall, iterations=CLI_ITERS,
         steps=steps, logged_steps=sorted(losses), finite=finite,
         loss_sem_seg=sem, images=images, snapshots=snapshots,
         images_per_sec=ips, launches=counts["launches"], expected=want,
         launches_by_design=counts["launches_by_design"],
         expected_by_design=want_design,
         launches_on_bf16_x=counts["launches_on_bf16_x"],
         expected_on_bf16_x=want_bf16, image_paths=counts["image_paths"],
         losses_last=losses.get(CLI_ITERS),
         note="images_per_sec: the loop's own, one window over all 20 "
              "iterations (first calls, grids and snapshots included); "
              "image_paths: image_transform calls by path (the training "
              "and display datasets crop from the decode cache)")
    check(sorted(losses) == list(range(1, CLI_ITERS + 1)),
          f"logged steps {sorted(losses)}")
    check(finite, "a logged loss is not finite")
    check(len(sem) == steps["fused"] and all(v > 0 for v in sem),
          f"loss_sem_seg {sem} in {steps['fused']} gen steps")
    check(images == want_images, f"images {images}")
    check((run / "index.html").exists(), "no index.html")
    check(snapshots == [10, 20], f"snapshots {snapshots}")
    check(counts["launches"] == want,
          f"CLI launches {counts['launches']}, want {want}")
    check(counts["launches_by_design"] == want_design,
          f"CLI launches by design {counts['launches_by_design']}, want "
          f"{want_design}")
    check(counts["launches_on_bf16_x"] == want_bf16,
          f"CLI launches on bf16 x {counts['launches_on_bf16_x']}, want "
          f"{want_bf16}")
    check(counts["image_paths"].get("pil", 0) == 0,
          f"the PIL fallback ran: {counts['image_paths']}")

    from munit_tpu_torch.__main__ import main as entry
    from PIL import Image
    (tmp / "tr_in").mkdir()
    content = Path(data["data_list_train_a"]).read_text().split()[:2]
    style = Path(data["data_list_train_b"]).read_text().split()[0]
    for i, path in enumerate(content):
        Image.open(path).save(tmp / "tr_in" / f"input{i}.jpg")
    set_numerics("tf32_off")     # as a fresh translate process runs
    norms.reset_launches()
    rc = entry(["translate", "--config", str(cfg), "--checkpoint",
                str(run / "checkpoints"), "--input", str(tmp / "tr_in"),
                "--style", style, "--output_folder", str(tmp / "tr_out")])
    outs = sorted(p.name for p in (tmp / "tr_out").iterdir())
    sizes = {Image.open(tmp / "tr_out" / o).size for o in outs}
    tr_launches = {k: v for k, v in norms.launches.items() if v}
    emit(phase="translate_from_snapshot", step=snapshots[-1], outputs=outs,
         sizes=sorted(sizes), launches=tr_launches)
    check(rc == 0 and outs == ["output000.jpg", "output001.jpg"]
          and sizes == {(256, 256)}, f"translate wrote {outs} {sizes}")
    check(tr_launches == {"instance_norm": 22, "adain": 16,
                          "whole_layer_norm": 4},
          f"translate launches {tr_launches}")
    return counts["launches_by_design"], data


def state_leaves(tr):
    """Every tensor of a trainer's whole state, as a flat dict of copies on
    the card, and the Python numbers apart."""
    out, nums = {}, {}

    def walk(state, prefix):
        for k, v in state.items():
            name = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, name)
            elif isinstance(v, torch.Tensor):
                out[name] = v.detach().float().clone()
            else:
                nums[name] = v
    walk(tr.state_dict(), "")
    return out, nums


def largest_difference(a, b):
    """The largest per-leaf max |a - b| over the state's tensors."""
    check(set(a[0]) == set(b[0]) and a[1] == b[1],
          "the two states differ in leaves or counters")
    return max((a[0][k] - b[0][k]).abs().max().item() for k in a[0])


def part_differences(a, b):
    """Mean |a - b| over each part of the state: each net's parameters and
    buffers, and each optimizer's mu, nu and params_copy. A fault moves
    every element of a part a little; the card's run-to-run noise moves a
    few elements a lot, which is what the largest leaf sees."""
    sums, counts = {}, {}
    for k, v in a[0].items():
        p = k.split("/")
        part = "/".join(p[:3] if p[0] == "opt" else p[:2])
        sums[part] = sums.get(part, 0.0) + (v - b[0][k]).abs().sum().item()
        counts[part] = counts.get(part, 0) + v.numel()
    return {part: sums[part] / counts[part] for part in sums}


def restored_exactly(a, b):
    """The leaves whose tensors or numbers differ at all (``iterations``
    aside: resume sets it to the step it returns)."""
    return sorted([k for k in a[0] if not torch.equal(a[0][k], b[0][k])]
                  + [k for k in a[1]
                     if k != "iterations" and a[1][k] != b[1].get(k)])


def resume_phase(MUNITTrainer, train_steps, conf, tmp: Path):
    """12(b): at batch 1 in bf16, captured as the trainer runs on a card,
    two uninterrupted runs of 20 iterations, then 11, a checkpoint, a
    trainer of other weights that has run (and captured) 10 iterations,
    resume into it in place, its graphs kept, and 9 more. The fresh
    trainer's state must equal the saved one bit for bit (counters and the
    anchor flag too). Conv and pad backward kernels may use atomics on the
    card, so after the 9 iterations the resumed run is held against the
    first uninterrupted one within 2x the two uninterrupted runs'
    difference in their largest leaf (0 when that is 0). The same resume
    with the discriminators' anchor flag cleared (a resume that lost it)
    must fail the bit-for-bit check. Each part's mean |difference| is
    printed for all three: the fault moves each discriminator weight by
    about as much as the card's run-to-run noise does in 20 bf16
    iterations, so no check after the 9 iterations can tell them apart.
    config_256 with ``optimizer: extra_adam`` (it ships adam, which never
    extrapolates): after 11 iterations the discriminators' last half-step
    (iteration 10) was an extrapolation, so the checkpoint carries its
    anchor."""
    from munit_tpu_torch.cli.train import load_segmenter
    from munit_tpu_torch.io import checkpoint
    conf = {**conf, "optimizer": "extra_adam"}
    set_numerics("bf16")
    batches = [numerics_inputs(train_inputs(1, SEED + 100 + it), "bf16")
               for it in range(RESUME_ITERS)]

    def trainer(seed):
        tr = MUNITTrainer(conf, "cuda")
        tr.init(torch.Generator().manual_seed(seed))
        load_segmenter(tr, conf)        # as the CLI re-makes it
        return tr

    def run(tr, start, stop):
        for it in range(start, stop):
            train_steps(tr, *batches[it], [it])

    t0 = time.perf_counter()
    full = []
    for _ in range(2):
        tr = trainer(SEED)
        run(tr, 0, RESUME_ITERS)
        full.append(state_leaves(tr))
        del tr
    tr = trainer(SEED)
    run(tr, 0, RESUME_SPLIT)
    anchor = tr.dis_opt.has_copy
    saved = state_leaves(tr)
    ckpt = str(tmp / "resume_checkpoints")
    checkpoint.save_checkpoint(ckpt, tr.state_dict(), RESUME_SPLIT)
    del tr
    noise_max = largest_difference(full[1], full[0])
    noise = part_differences(full[1], full[0])
    out = {}
    for name in ("resumed", "anchor_dropped"):
        # a trainer that has captured its steps on other weights, so that
        # the resume runs on graphs captured before load_state_dict
        tr = trainer(SEED + 1)
        run(tr, 0, RESUME_WARM)
        graphs_before = len(tr._graphs)
        start = checkpoint.resume(tr, ckpt)
        if name == "anchor_dropped":
            tr.dis_opt.has_copy = False     # the planted fault
        not_restored = restored_exactly(state_leaves(tr), saved)
        graphs_kept = len(tr._graphs)
        run(tr, start, RESUME_ITERS)
        final = state_leaves(tr)
        graphs_after = len(tr._graphs)
        del tr
        parts = part_differences(final, full[0])
        out[name] = {"resumed_from": start, "not_restored": not_restored,
                     "graphs_before_resume": graphs_before,
                     "graphs_after_resume": graphs_kept,
                     "graphs_at_the_end": graphs_after,
                     "max_abs_diff": largest_difference(final, full[0]),
                     "mean_abs_diff_by_part": parts,
                     "parts_over_bound": [k for k in parts
                                          if parts[k] > 2 * noise[k]]}
    torch.cuda.synchronize()
    emit(phase="resume_card", batch=1, numerics="bf16",
         optimizer=conf["optimizer"], iterations=RESUME_ITERS,
         split=RESUME_SPLIT, saved_mid_extrapolation=anchor,
         leaves=len(full[0][0]), run_to_run_max_abs_diff=noise_max,
         bound=2 * noise_max, run_to_run_mean_abs_diff_by_part=noise, **out,
         seconds=time.perf_counter() - t0,
         note="max_abs_diff: the largest leaf's max |diff| over the state's "
              "tensors (parameters, buffers, ExtraAdam moments and "
              "anchors); mean_abs_diff_by_part: mean |diff| over each net's "
              "tensors and each optimizer's mu, nu, params_copy; "
              "parts_over_bound: parts above twice the run-to-run one "
              "(printed, not asserted); "
              "anchor_dropped: the same resume with dis_opt.has_copy "
              "cleared, a planted fault")
    ok, bad = out["resumed"], out["anchor_dropped"]
    check(ok["resumed_from"] == RESUME_SPLIT and anchor,
          "not resumed mid-extrapolation")
    check(not ok["not_restored"],
          f"resume did not restore {ok['not_restored'][:5]}")
    check(ok["max_abs_diff"] <= 2 * noise_max,
          f"resumed run differs by {ok['max_abs_diff']}, twice the "
          f"run-to-run difference is {2 * noise_max}")
    check(bad["not_restored"] == ["opt/dis/has_copy"],
          f"the planted fault (anchor flag dropped) read as not restored: "
          f"{bad['not_restored'][:5]}")
    check(ok["graphs_before_resume"] == ok["graphs_after_resume"] > 0,
          f"load_state_dict dropped the captured steps: {ok}")
    torch.cuda.empty_cache()


def loader_rate(make, batches=20):
    """images/s of a loader over ``batches`` batches after one epoch."""
    loader = make()
    it = iter(loader)
    try:
        for _ in range(len(loader)):       # one epoch: fills a cache
            next(it)
        t0 = time.perf_counter()
        n = sum(next(it)["image"].shape[0] for _ in range(batches))
        return n / (time.perf_counter() - t0)
    finally:
        it.close()


class MemoryLoader:
    """The first batches of a loader, decoded once and yielded again in
    turn: the loop's feed without the decode threads."""

    def __init__(self, loader, n=2):
        it = iter(loader)
        self.batches = [next(it) for _ in range(n)]
        it.close()

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start):
        i = start
        while True:
            yield self.batches[i % len(self.batches)]
            i += 1


def feed_phase(norms, MUNITTrainer, get_config, data, fixed, tmp: Path):
    """12(c): the loop's images/s at batch 1 and 8 in bf16 (60 iterations
    of train_loop with the CLI's loaders, the first 30 dropped, so that
    every step kind replays its graph) and the host's seconds in each
    stage of an iteration, beside phase 8b's ms per iteration on tensors
    already on the card (captured and eager), beside 30 more iterations fed
    from batches decoded once (the feed's host-to-device stage without the
    decode threads) and 30 more with eager steps; the device idle share of
    a fused step inside the loop at batch 8 (its third, a replay, profiled
    as it runs); then the loader alone at batch 8."""
    from munit_tpu_torch.cli.train import build_loaders, load_segmenter
    from munit_tpu_torch.data import transforms
    from munit_tpu_torch.data.datasets import ImageFilelist, ImageMaskDataset
    from munit_tpu_torch.data.loader import DataLoader
    from munit_tpu_torch.train.loop import train_loop
    set_numerics("bf16")
    out = {}
    for b in BATCHES:
        keys = {**CLI_KEYS, "batch_size": b, "max_iter": FEED_ITERS,
                "snapshot_save_iter": 10**6, "image_save_iter": 10**6,
                "image_display_iter": 10**6}
        cfg = write_config(tmp / f"feed{b}" / "config_256.yaml", data, keys)
        conf = get_config(str(cfg))
        tr = new_trainer(MUNITTrainer, conf, "cuda")
        load_segmenter(tr, conf)
        loaders = build_loaders(conf, seed=SEED)
        prof = {}
        orig, calls = tr.dis_gen_update, []

        def fused(*a, **k):
            calls.append(1)
            if len(calls) != 3:
                return orig(*a, **k)
            res, api = [], {}
            rows, wall = device_profile(
                lambda: res.append(orig(*a, **k)), 1, api)
            busy = sum(r[0] for r in rows)
            prof.update(profiled_wall_ms=wall, device_busy_ms=busy,
                        device_idle_share=1 - busy / wall,
                        by_group_ms=grouped(rows),
                        host_api_ms=dict(sorted(
                            api.items(), key=lambda kv: -kv[1]["host_ms"])[:8]))
            return res[0]
        tr.dis_gen_update = fused
        train_loop(tr, conf, loaders, str(tmp / f"feed{b}" / "warm"),
                   max_iter=FEED_WARM, device="cuda")
        steady = tmp / f"feed{b}" / "steady"
        host = {}
        train_loop(tr, conf, loaders, str(steady), start_iteration=FEED_WARM,
                   max_iter=FEED_ITERS, device="cuda", host_seconds=host)
        span = FEED_ITERS - FEED_WARM
        check(host["iterations"] == span, f"batch {b}: host stages {host}")
        host_ms_per_it = {k: v * 1e3 / span for k, v in host.items()
                          if k != "iterations"}

        def loop_rate(name, loop_conf, feed, start):
            """The loop's images_per_sec over ``span`` iterations."""
            run = tmp / f"feed{b}" / name
            train_loop(tr, loop_conf, feed, str(run), start_iteration=start,
                       max_iter=start + span, device="cuda")
            ips = [json.loads(ln)["images_per_sec"]
                   for ln in (run / "metrics.jsonl").open()
                   if "images_per_sec" in ln]
            check(len(ips) == 1, f"batch {b} {name}: images_per_sec {ips}")
            return ips[0]

        ips = [json.loads(ln)["images_per_sec"]
               for ln in (steady / "metrics.jsonl").open()
               if "images_per_sec" in ln]
        check(len(ips) == 1, f"batch {b}: images_per_sec lines {ips}")
        mem_ips = [loop_rate("memory", conf, {k: MemoryLoader(v) for k, v
                                              in loaders.items()},
                             FEED_ITERS)]
        tr._capture = False
        eager_ips = loop_rate("eager", conf, loaders, FEED_ITERS + span)
        tr._capture = True
        fixed_ms = fixed[b]["ms_per_iteration"]
        out[b] = {"loop_images_per_sec": ips[0],
                  "loop_ms_per_iteration": b * 1e3 / ips[0],
                  "loop_host_ms_per_iteration": host_ms_per_it,
                  "memory_fed_loop_images_per_sec": mem_ips[0],
                  "memory_fed_loop_ms_per_iteration": b * 1e3 / mem_ips[0],
                  "eager_loop_images_per_sec": eager_ips,
                  "eager_loop_ms_per_iteration": b * 1e3 / eager_ips,
                  "fixed_tensor_ms_per_iteration": fixed_ms,
                  "fixed_tensor_images_per_s": fixed[b]["images_per_s"],
                  "eager_fixed_tensor_ms_per_iteration":
                      fixed[b]["eager_ms_per_iteration"],
                  "feed_share": 1 - fixed_ms / (b * 1e3 / ips[0])}
        if prof:
            prof["fixed_tensor_fused_step_idle_share"] = \
                fixed[b]["fused_idle_share"]
            prof["fixed_tensor_fused_step_idle_share_profiled_wall"] = \
                fixed[b]["fused_idle_share_profiled"]
            out[b]["fused_step_in_loop"] = prof
        emit(phase="feed_loop", batch=b, numerics="bf16",
             iterations=FEED_ITERS - FEED_WARM, **out[b],
             note="images_per_sec: the loop's metrics.jsonl over iterations "
                  "30-59 (bench.py's cadence, the classifier_sr step twice, "
                  "every step a replay); host ms: the loop's own stages "
                  "over those iterations (next_batch: waiting on the feed; "
                  "step: issuing the steps; bookkeeping: the rest, with the "
                  "metric flush that waits for the card); memory fed: "
                  "iterations 60-89 from 2 batches decoded once; eager: "
                  "iterations 90-119, the CLI's loaders, eager steps; "
                  "fixed tensor: phase 8b's 5-iteration cycle, batch "
                  "already on the card; feed_share: the loop's time per "
                  "iteration beyond that; the in-loop fused step's idle "
                  "share is against its profiled wall, as is the fixed "
                  "tensor's _profiled_wall one")
        check(all(np.isfinite(v) for v in (ips[0], fixed_ms)),
              f"batch {b}: no loop rate")
        del tr, loaders
        torch.cuda.empty_cache()

    lists = (data["data_list_train_a"], data["data_list_train_a_seg"])
    rates = {}
    for name, cache_mb in (("mask_dataset_decode_cache", None),
                           ("mask_dataset_no_cache", 0)):
        rates[name] = loader_rate(lambda: DataLoader(
            ImageMaskDataset(*lists, 256, 256, 256, cache_mb=cache_mb), 8,
            shuffle=True, num_workers=CLI_KEYS["num_workers"], seed=SEED))
    before = dict(transforms.paths)
    rates["list_dataset_native"] = loader_rate(lambda: DataLoader(
        ImageFilelist("", lists[0], 256, 256, 256, train=True, cache_mb=0),
        8, shuffle=True, num_workers=CLI_KEYS["num_workers"], seed=SEED))
    took = {k: transforms.paths[k] - before.get(k, 0)
            for k in ("native", "pil")}
    emit(phase="feed_loader", batch=8, images_per_sec=rates,
         image_transform_paths=took,
         note="DataLoader alone over the phase's 16 JPEGs per domain, "
              "uint8 out, 8 workers, 20 batches after one epoch; decode "
              "cache: the training default (decode and resize once, then "
              "crop); no cache: PIL decode and resize every draw; native: "
              "the list dataset without cache, its resize and crop in the "
              "native image ops")
    check(took["native"] >= 8 * 20 and took["pil"] == 0,
          f"the native image ops did not run: {took}")
    return out


# ---------------------------------------------------------------- phase 13

SIM_DIR = ROOT / "configs" / "final_test"
# FeatureDA with the DANN and the seg head, which no shipped config turns on
SIM_EXTRA = {"domain_adv_w": 1, "adaptation": {"sem_seg_lambda": 1}}
# (name, flavor, keys merged into it) of the phase's train CLI runs
SIM_RUNS = (("FeatureDA", "FeatureDA", None), ("Output_DA", "Output_DA", None),
            ("FeatureDA_dann_seg", "FeatureDA", SIM_EXTRA))
# every sim→real term in one trainer: the card-against-CPU check, the resume
SIM_ALL = {"domain_adv_w": 1,
           "adaptation": {"sem_seg_lambda": 1, "output_classifier_lambda": 1,
                          "output_adv_lambda": 1}}
SIM_ITERS = 20
SIM_BAND = (96, 176)    # rows where B differs from A, on JPEG's 16-px blocks
# data/transforms.py::_SEM_VALUE_TABLE's gray values (any other raises)
SEM_GRAYS = (0, 29, 55, 76, 133, 149, 178, 200, 255)
# Card (TF32 off) against CPU, relative, per loss of one step from one
# state: float32 sums in another order through ~40 layers
SIM_LOSS_RTOL = 1e-3
SIM_RESUME_AT = 10
SIM_TIME_ITERS = 10     # timed iterations after the warm-up, captured
SIM_EAGER_ITERS = 5     # the same trainer's eager iterations after them
# The norm launches of each step kind: the DANN and seg-head steps encode
# both domains' content as the classifier_sr step does; the output-level
# classifier step runs no generator.
SIM_STEP_NORMS = {"dis": "dis", "dis_gen": "fused", "dis_gen_synth": "fused",
                  "dann": "classifier_sr", "classifier_sr": "classifier_sr",
                  "classifier_sr_synth": "classifier_sr",
                  "seg_head": "classifier_sr", "output_classifier_sr": None}
# `python -m munit_tpu_torch <args>` in this process, as CLI_RUNNER; then
# the norm launches and the trainer's captured steps (kind as the cadence
# names it, extrapolate, anchor flags, replays) into a JSON file
SIM_RUNNER = """
import json, runpy, sys
from munit_tpu_torch.cli import train as cli
from munit_tpu_torch.kernels import norms
out, sys.argv = sys.argv[1], ["munit_tpu_torch", *sys.argv[2:]]
seen = {}
loop = cli.train_loop
def spy(trainer, *a, **k):
    seen["trainer"] = trainer
    return loop(trainer, *a, **k)
cli.train_loop = spy
def kind(key):
    synth = key[0] in ("dis_gen", "classifier_sr") and key[4][0]
    return key[0] + ("_synth" if synth else "")
try:
    runpy.run_module("munit_tpu_torch", run_name="__main__", alter_sys=True)
finally:
    g = seen["trainer"]._graphs if seen else None
    with open(out, "w") as f:
        json.dump({"launches": norms.launches,
                   "launches_by_design": norms.design_launches,
                   "graphs": [[kind(k), k[1], list(k[2]), n]
                              for k, n in g.replays.items()] if g else []},
                  f)
"""


def write_synth_data(root: Path) -> dict:
    """16 seeded 286x286 synthetic pairs: JPEGs whose B equals A outside a
    band of rows (on JPEG's 16-pixel blocks, so the aligned mask is
    neither empty nor full), the band as the PNG mask, and semantic PNGs
    in the table's gray values; returns the config's synthetic data keys
    (absolute paths)."""
    from PIL import Image
    rng = np.random.RandomState(SEED + 13)
    root.mkdir(parents=True)
    lists = {k: [] for k in ("a", "b", "mask", "sem_a", "sem_b")}
    lo, hi = SIM_BAND
    grays = np.asarray(SEM_GRAYS, np.uint8)
    for i in range(DATA_IMAGES):
        a = rng.randint(0, 256, (DATA_SIZE, DATA_SIZE, 3), np.uint8)
        b = a.copy()
        b[lo:hi] = rng.randint(0, 256, (hi - lo, DATA_SIZE, 3), np.uint8)
        mask = np.zeros((DATA_SIZE, DATA_SIZE), np.uint8)
        mask[lo:hi] = 255
        arrays = {"a": a, "b": b, "mask": mask,
                  "sem_a": grays[rng.randint(0, 9, (DATA_SIZE, DATA_SIZE))],
                  "sem_b": grays[rng.randint(0, 9, (DATA_SIZE, DATA_SIZE))]}
        for k, arr in arrays.items():
            ext = "jpg" if k in ("a", "b") else "png"
            path = root / f"{k}{i:02d}.{ext}"
            Image.fromarray(arr).save(path, **({"quality": 90}
                                               if ext == "jpg" else {}))
            lists[k].append(str(path))
    names = {"a": "data_list_train_a_synth", "b": "data_list_train_b_synth",
             "mask": "data_list_train_b_seg_synth", "sem_a": "seg_list_a",
             "sem_b": "seg_list_b"}
    keys = {}
    for k, paths in lists.items():
        (root / f"{k}.txt").write_text("\n".join(paths) + "\n")
        keys[names[k]] = str(root / f"{k}.txt")
    return keys


def sim_raw(flavor, over=None) -> dict:
    """configs/final_test/<flavor>.yaml as it is, ``over`` merged in."""
    import yaml
    raw = yaml.safe_load((SIM_DIR / f"{flavor}.yaml").read_text())
    for k, v in (over or {}).items():
        raw[k] = {**raw[k], **v} if isinstance(v, dict) else v
    return raw


def sim_inputs(b, seed, numerics):
    """A real batch (train_inputs) and a synthetic one on the card: B equal
    to A outside a band of rows, the band as the mask, class ids 0-8."""
    g = torch.Generator().manual_seed(seed)
    x_a = torch.rand((b, 256, 256, 3), generator=g) * 2 - 1
    x_b = x_a.clone()
    x_b[:, 96:160] = torch.rand((b, 64, 256, 3), generator=g) * 2 - 1
    mask = torch.zeros((b, 256, 256, 1))
    mask[:, 96:160] = 1.0
    sem = [torch.randint(0, 9, (b, 256, 256), generator=g,
                         dtype=torch.int32) for _ in range(2)]
    synth = {"image_a": x_a, "image_b": x_b, "mask": mask, "sem_a": sem[0],
             "sem_b": sem[1]}
    if numerics == "bf16":
        synth["image_a"], synth["image_b"] = x_a.bfloat16(), x_b.bfloat16()
    batch = numerics_inputs(train_inputs(b, seed), numerics)
    return batch, {k: v.cuda() for k, v in synth.items()}


def without_styles(state):
    """A trainer's state without its style stream and display styles: what
    a trainer on another device type can load (a CPU generator's state is
    not a CUDA generator's)."""
    return {k: v for k, v in state.items() if k != "styles"}


def cli_trainer(MUNITTrainer, conf, device, seed=SEED):
    """A trainer as the train CLI makes it: seeded weights and styles, the
    frozen segmenter and VGG16 seeded (neither checkpoint is in the
    repo)."""
    from munit_tpu_torch.cli.train import load_segmenter, load_vgg
    tr = MUNITTrainer(conf, device)
    tr.init(torch.Generator().manual_seed(seed))
    tr.seed_styles(seed)
    if tr.segmenter is not None:
        load_segmenter(tr, conf)
    if tr.vgg is not None:
        load_vgg(tr, conf)
    return tr


def variant_label(kind, extrapolate, has_copy):
    return (f"{kind} {'extrapolate' if extrapolate else 'step'} anchors="
            + "".join("1" if h else "0" for h in has_copy))


def run_beside(runs, meanwhile) -> dict:
    """Runs ``meanwhile`` while the train CLIs of ``runs`` ({name: (config,
    counts file, process)}) go on, each waited for in a thread of its own;
    {name: (its stderr, the perf_counter at which it ended)}. A failure of
    ``meanwhile`` ends the processes."""
    from concurrent.futures import ThreadPoolExecutor

    def finish(proc):
        _, err = proc.communicate(timeout=600)
        return err, time.perf_counter()
    with ThreadPoolExecutor(len(runs)) as pool:
        waits = {name: pool.submit(finish, r[2]) for name, r in runs.items()}
        try:
            meanwhile()
        except BaseException:
            for _, _, proc in runs.values():
                proc.kill()
            raise
        return {name: w.result() for name, w in waits.items()}


def sim_cli_phase(norms, get_config, step_variants, data, tmp: Path,
                  meanwhile):
    """13(a): `python -m munit_tpu_torch train` in three subprocesses run
    side by side, bf16, 20 iterations each, on
    configs/final_test/FeatureDA.yaml, Output_DA.yaml and FeatureDA with
    the DANN and the seg head, with the data keys and max_iter
    overridden: the config's own log_iter, batch and cadence (a real and a
    synthetic fused step every iteration). Every logged loss finite, the
    flavor's new losses logged, every step variant that ran twice
    captured and replayed as often as the cadence says, the norm launches
    by design. ``meanwhile`` (13(b)) runs beside them."""
    import yaml
    synth = write_synth_data(tmp / "sim_data")
    runs = {}
    t0 = time.perf_counter()
    for name, flavor, over in SIM_RUNS:
        raw = {**sim_raw(flavor, over), **data, **synth,
               "max_iter": SIM_ITERS}
        cfg = tmp / "sim" / f"{name}.yaml"
        cfg.parent.mkdir(parents=True, exist_ok=True)
        cfg.write_text(yaml.safe_dump(raw))
        counts_file = tmp / f"{name}_counts.json"
        proc = subprocess.Popen(
            [sys.executable, "-c", SIM_RUNNER, str(counts_file), "train",
             "--config", str(cfg), "--output_path", str(tmp / "sim")],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
        runs[name] = (cfg, counts_file, proc)
    done = run_beside(runs, meanwhile)
    total = {}
    for name, (cfg, counts_file, proc) in runs.items():
        err, end = done[name]
        wall = end - t0
        check(proc.returncode == 0,
              f"{name}: train CLI exit {proc.returncode}: {err[-3000:]}")
        conf = get_config(str(cfg))
        counts = json.loads(counts_file.read_text())
        run = tmp / "sim" / "outputs" / name
        lines = [json.loads(ln) for ln in (run / "metrics.jsonl").open()]
        losses = {m["step"]: m for m in lines if "loss_dis_total" in m}
        finite = all(np.isfinite(v) for m in losses.values()
                     for k, v in m.items() if k != "step")
        variants = Counter(step_variants(conf, range(SIM_ITERS), synth=True))
        kinds, norm_steps = Counter(), Counter()
        for (kind, *_), n in variants.items():
            kinds[kind] += n
            if SIM_STEP_NORMS[kind]:
                norm_steps[SIM_STEP_NORMS[kind]] += n
        want = expected_launches(norms, conf, norm_steps)
        want_design = designs_of_calls(norms, want, PATH_DESIGN_SHARE)
        want_graphs = {variant_label(*v): n - 1 for v, n in variants.items()
                       if n >= 2}
        got_graphs = {variant_label(k, e, h): n
                      for k, e, h, n in counts["graphs"]}
        ad = conf["adaptation"]
        new_keys = ["loss_gen_recon_synth", "loss_sem_seg"]
        if ad["output_classifier_lambda"] > 0:
            new_keys += ["loss_output_classifier_sr",
                         "loss_output_classifier_adv_sr"]
        if conf["domain_adv_w"] > 0:
            new_keys += ["domain_class_loss", "domain_adv_loss_gen"]
        if ad["sem_seg_lambda"] > 0:
            new_keys.append("loss_semantic_head")
        last = losses.get(SIM_ITERS, {})
        emit(phase="sim2real_cli", config=name, batch=conf["batch_size"],
             numerics="bf16", seconds_incl_start=wall, iterations=SIM_ITERS,
             steps=dict(kinds), logged_steps=sorted(losses), finite=finite,
             new_losses_last={k: last.get(k) for k in new_keys},
             graphs=got_graphs, expected_graphs=want_graphs,
             launches=counts["launches"], expected=want,
             launches_by_design=counts["launches_by_design"],
             expected_by_design=want_design, losses_last=last,
             note="configs/final_test/<flavor>.yaml with the data keys and "
                  "max_iter: 20 replaced; the three runs side by side, "
                  "seconds from their common start; graphs: replays of each "
                  "captured step variant (kind, phase, the updated "
                  "optimizers' anchor flags), the one after its capture "
                  "included; a variant that runs once runs eagerly "
                  "(classifier_sr at iteration 14)")
        check(sorted(losses) == list(range(conf["log_iter"], SIM_ITERS + 1,
                                           conf["log_iter"])),
              f"{name}: logged steps {sorted(losses)}")
        check(finite, f"{name}: a logged loss is not finite")
        check(all(last.get(k) is not None and last[k] > 0
                  for k in new_keys),
              f"{name}: new losses {[(k, last.get(k)) for k in new_keys]}")
        check(got_graphs == want_graphs,
              f"{name}: graphs {got_graphs}, want {want_graphs}")
        check(counts["launches"] == want,
              f"{name}: launches {counts['launches']}, want {want}")
        check(counts["launches_by_design"] == want_design,
              f"{name}: launches by design {counts['launches_by_design']}, "
              f"want {want_design}")
        for k, v in counts["launches_by_design"].items():
            for d, n in v.items():
                total.setdefault(k, Counter())[d] += n
    return {k: dict(v) for k, v in total.items()}


def sim_parity_phase(MUNITTrainer, cadence_step, cadence_steps, get_config,
                     tmp: Path):
    """13(b): at full width, batch 1, parity numerics (TF32 off, cuDNN
    deterministic), each step of an iteration that runs every sim→real
    step (FeatureDA with the DANN, the output-level classifiers and the seg
    head), on the card and on the CPU from one state (the CPU trainer's,
    loaded into the card's before each step) and one batch: every loss
    within SIM_LOSS_RTOL relative."""
    import yaml
    cfg = tmp / "sim_all.yaml"
    cfg.write_text(yaml.safe_dump(sim_raw("FeatureDA", SIM_ALL)))
    conf = get_config(str(cfg))
    set_numerics("tf32_off")
    torch.backends.cudnn.deterministic = True
    try:
        trs = {d: cli_trainer(MUNITTrainer, conf, d) for d in ("cpu", "cuda")}
        batch, synth = sim_inputs(1, SEED + 131, "tf32_off")
        inputs = {"cuda": (batch, synth),
                  "cpu": ([t.cpu() for t in batch],
                          {k: v.cpu() for k, v in synth.items()})}
        it = conf["adaptation"]["classif_frequency"] - 1
        rows, worst, cpu_s = [], 0.0, 0.0
        for kind, _ in cadence_steps(conf, it, synth=True):
            trs["cuda"].load_state_dict(
                without_styles(trs["cpu"].state_dict()))
            out = {}
            for dev, tr in trs.items():
                tr.iterations = it
                t0 = time.perf_counter()
                out[dev] = {k: float(v) for k, v in cadence_step(
                    tr, conf, kind, *inputs[dev][0], inputs[dev][1]).items()
                    if k != "lr"}
                if dev == "cpu":
                    cpu_s += time.perf_counter() - t0
            errs = {k: abs(out["cuda"][k] - w) / abs(w) if w else
                    abs(out["cuda"][k]) for k, w in out["cpu"].items()}
            key = max(errs, key=errs.get)
            worst = max(worst, errs[key])
            rows.append({"step": kind, "losses": len(errs),
                         "worst": key, "rel_err": errs[key],
                         "cpu": out["cpu"][key], "card": out["cuda"][key]})
        emit(phase="sim2real_card_vs_cpu", batch=1, width="full (256, "
             "gen dim 64, 3-scale discriminators)", numerics="tf32_off",
             iteration=it, steps=rows, worst_rel_err=worst,
             tol=SIM_LOSS_RTOL, cpu_seconds=cpu_s,
             note="each step from the CPU trainer's state, loaded into the "
                  "card's before it; every loss the step logs, relative to "
                  "the CPU's (absolute where the CPU's is 0)")
        check(worst <= SIM_LOSS_RTOL,
              f"sim2real card against CPU: {worst} > {SIM_LOSS_RTOL}: {rows}")
    finally:
        torch.backends.cudnn.deterministic = False
        del trs
        torch.cuda.empty_cache()
    return conf


def sim_resume_phase(MUNITTrainer, train_steps, conf, tmp: Path):
    """13(c): bf16, batch 1, captured, every sim→real net: 10 iterations, a
    checkpoint, and a trainer of other weights that has run (and
    captured) 10 iterations restored from it in place: its whole state,
    the new nets and their optimizers too, equal to the saved one bit for
    bit, its graphs kept."""
    from munit_tpu_torch.io import checkpoint
    set_numerics("bf16")
    batch, synth = sim_inputs(1, SEED + 132, "bf16")
    tr = cli_trainer(MUNITTrainer, conf, "cuda")
    train_steps(tr, *batch, range(SIM_RESUME_AT), synth)
    saved = state_leaves(tr)
    ckpt = str(tmp / "sim_checkpoints")
    checkpoint.save_checkpoint(ckpt, tr.state_dict(), SIM_RESUME_AT)
    nets = sorted(tr.state_dict()["nets"])
    del tr
    other = cli_trainer(MUNITTrainer, conf, "cuda", SEED + 1)
    train_steps(other, *batch, range(SIM_RESUME_AT), synth)
    graphs_before = len(other._graphs)
    start = checkpoint.resume(other, ckpt)
    not_restored = restored_exactly(state_leaves(other), saved)
    emit(phase="sim2real_resume", batch=1, numerics="bf16",
         resumed_from=start, nets=nets, leaves=len(saved[0]),
         not_restored=not_restored, graphs_before_resume=graphs_before,
         graphs_after_resume=len(other._graphs))
    check(start == SIM_RESUME_AT, f"resumed from {start}")
    check({"dann", "output_classifier_sr_a", "seg_head"} <= set(nets),
          f"nets {nets}")
    check(not not_restored, f"resume did not restore {not_restored[:5]}")
    check(graphs_before == len(other._graphs) > 0,
          "load_state_dict dropped the captured steps")
    del other
    torch.cuda.empty_cache()


def sim_time_phase(MUNITTrainer, train_steps, cadence_step, cadence_steps,
                   capture_warmup, validate):
    """13(d): FeatureDA, Output_DA and FeatureDA with the DANN and the seg
    head, at batch 1 in bf16 on tensors already on the card:
    capture_warmup iterations (every variant captured), then
    ms per iteration captured (median of 3 rounds of 10 iterations) and
    eager (1 round of the next 5, on the same trainer), ms per step kind
    captured (median of 5), peak memory and the graphs per key."""
    set_numerics("bf16")
    for name, flavor, over in SIM_RUNS:
        conf = validate({**sim_raw(flavor, over), "batch_size": 1})
        tr = cli_trainer(MUNITTrainer, conf, "cuda")
        batch, synth = sim_inputs(1, SEED + 133, "bf16")
        warm = capture_warmup(conf, synth=True)
        t0 = time.perf_counter()
        train_steps(tr, *batch, range(warm), synth)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        graphs = len(tr._graphs)
        timed = range(warm, warm + SIM_TIME_ITERS)

        def iterations():
            train_steps(tr, *batch, timed, synth)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        captured_ms, rounds = host_ms(iterations, 3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(len(tr._graphs) == graphs, f"{name}: a step was captured "
              "on the clock")
        captured, tr._capture = tr._capture, False
        eager_ms = eager_round_ms(tr, batch, timed.stop, synth)
        tr._capture = captured
        it = conf["adaptation"]["classif_frequency"] - 1
        steps = {}
        for kind, _ in cadence_steps(conf, it, synth=True):
            tr.iterations = it
            steps[kind], _ = host_ms(lambda: cadence_step(
                tr, conf, kind, *batch, synth), 5)
        check(len(tr._graphs) == graphs, f"{name}: the step timing "
              "captured a step")
        keys = [{"kind": k[0], "extrapolate": k[1],
                 "static": [str(s) for s in k[4]],
                 "replays": tr._graphs.replays[k],
                 "capture_s": tr._graphs.capture_seconds[k]}
                for k in tr._graphs.capture_seconds]
        emit(phase="sim2real_time", config=name, batch=1, numerics="bf16",
             ms_per_iteration_captured=captured_ms / SIM_TIME_ITERS,
             ms_per_iteration_eager=eager_ms,
             captured_rounds_ms=[r / SIM_TIME_ITERS for r in rounds],
             step_ms_captured=steps, peak_memory_gb=peak,
             graph_pool_gb=tr._graphs.pool_bytes() / 2**30, graphs=graphs,
             graph_keys=keys, warmup_iterations=warm, warmup_seconds=warm_s,
             note="host clock, each round ending in a synchronise; "
                  "captured: replays only (no capture on the clock); eager: "
                  "the next 5 iterations on the same trainer, one round, "
                  "no warm-up; step_ms: one "
                  "step of each kind of iteration 14, replayed; "
                  "peak_memory_gb: the most allocated during the captured "
                  "rounds")
        del tr
        gc.collect()
        torch.cuda.empty_cache()


def eager_round_ms(tr, batch, start, synth=None):
    """Host ms per iteration of SIM_EAGER_ITERS eager iterations from
    ``start``, one round ending in a synchronise, with no warm-up call: the
    trainer has just run the same steps captured."""
    from munit_tpu_torch.train.trainer import train_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_steps(tr, *batch, range(start, start + SIM_EAGER_ITERS), synth)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / SIM_EAGER_ITERS


def sim2real_phase(norms, get_config, validate, data, tmp: Path):
    """Phase 13: the sim→real training path (the train CLI on the
    final_test flavors, card against CPU, resume, timing); returns the CLI
    runs' norm launches by design."""
    from munit_tpu_torch.train.trainer import (MUNITTrainer, cadence_step,
                                               cadence_steps, capture_warmup,
                                               step_variants, train_steps)
    t0 = time.perf_counter()
    parity = {}
    launches = sim_cli_phase(
        norms, get_config, step_variants, data, tmp,
        lambda: parity.update(conf=sim_parity_phase(
            MUNITTrainer, cadence_step, cadence_steps, get_config, tmp)))
    conf = parity["conf"]
    sim_resume_phase(MUNITTrainer, train_steps, conf, tmp)
    sim_time_phase(MUNITTrainer, train_steps, cadence_step, cadence_steps,
                   capture_warmup, validate)
    emit(phase="sim2real_seconds", seconds=time.perf_counter() - t0)
    return launches


def sim2real_alone() -> int:
    """``python3 chip_smoke.py --sim2real``: the build and phase 13 alone,
    for working on it; the kernel line and status line are the full
    run's."""
    from munit_tpu_torch.config import get_config, validate
    from munit_tpu_torch.kernels import build, norms
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        data = write_train_data(Path(tmp) / "data")
        sim2real_phase(norms, get_config, validate, data, Path(tmp))
    return 0


# ---------------------------------------------------------------- phase 14

# (name, base config or None for the package defaults, keys merged into
# it) of the vanilla MUNIT runs: upstream's model (the defaults: gen_state
# 0, guided 0, batch 1, 256 px, adam, a fused step every iteration) with the
# VGG loss, and config_256 with upstream's generator and random styles
VANILLA_RUNS = (("vanilla", None, {"vgg_w": 1}),
                ("config_256_vanilla", CONFIG, {"gen_state": 0, "guided": 0}))
# the card-against-CPU check: config_256 with every vanilla term on
VANILLA_ALL = {"gen_state": 0, "guided": 0, "vgg_w": 1}
VANILLA_STYLES = 10         # translate_batch --num_style
VANILLA_CPU_IMAGES = 2      # translate_batch's images on the CPU as well
# translate_batch, card (TF32 off) against CPU on the same styles: float32
# sums in another order through one encode and one decode
VANILLA_TRANSLATE_ATOL = 1e-3
# the step kinds of the card-against-CPU check and the styles each takes
VANILLA_STEPS = (("dis", 2), ("dis_gen", 4), ("gen", 2), ("classifier_sr", 0))


def vanilla_raw(base, over) -> dict:
    """The base config (the package defaults when None) with ``over``
    merged in (phases 14 and 15)."""
    import yaml
    raw = yaml.safe_load(base.read_text()) if base is not None else {}
    for k, v in over.items():
        raw[k] = {**raw[k], **v} if isinstance(v, dict) else v
    return raw


def spy_draws(tr):
    """Every style batch ``tr`` draws from now on, copied, in order."""
    calls, draw = [], tr.draw_style

    def spy(bsz, dtype):
        t = draw(bsz, dtype)
        calls.append(t.detach().clone())
        return t
    tr.draw_style = spy
    return calls


def vanilla_cli_phase(norms, get_config, step_variants, data, tmp: Path,
                      meanwhile):
    """14(a): `python -m munit_tpu_torch train` in two subprocesses side by
    side, bf16, 20 iterations each: the vanilla defaults with vgg_w 1, and
    config_256 with gen_state 0 and guided 0, over phase 12's JPEGs, with
    phase 12's keys (snapshots and grids at 10 and 20, a train_current grid
    every 5, display_size 2, 8 workers) and the data keys. Every logged
    loss finite, the VGG terms above 0 where vgg_w is, every step variant
    that ran twice captured and replayed as the cadence says, the norm
    launches by design (the steps' and the guided: 0 grids'). ``meanwhile``
    (14(b)) runs beside them. Returns the launches by design and each
    run's directory and config."""
    import yaml
    runs, out = {}, {}
    t0 = time.perf_counter()
    for name, base, over in VANILLA_RUNS:
        raw = {**vanilla_raw(base, over), **data, **CLI_KEYS}
        cfg = tmp / "vanilla" / f"{name}.yaml"
        cfg.parent.mkdir(parents=True, exist_ok=True)
        cfg.write_text(yaml.safe_dump(raw))
        counts_file = tmp / f"{name}_counts.json"
        proc = subprocess.Popen(
            [sys.executable, "-c", SIM_RUNNER, str(counts_file), "train",
             "--config", str(cfg), "--output_path", str(tmp / "vanilla")],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
        runs[name] = (cfg, counts_file, proc)
    done = run_beside(runs, meanwhile)
    total = {}
    for name, (cfg, counts_file, proc) in runs.items():
        err, end = done[name]
        wall = end - t0
        check(proc.returncode == 0,
              f"{name}: train CLI exit {proc.returncode}: {err[-3000:]}")
        conf = get_config(str(cfg))
        counts = json.loads(counts_file.read_text())
        run = tmp / "vanilla" / "outputs" / name
        lines = [json.loads(ln) for ln in (run / "metrics.jsonl").open()]
        losses = {m["step"]: m for m in lines if "loss_dis_total" in m}
        finite = all(np.isfinite(v) for m in losses.values()
                     for k, v in m.items() if k != "step")
        variants = Counter(step_variants(conf, range(CLI_ITERS)))
        kinds, norm_steps = Counter(), Counter()
        for (kind, *_), n in variants.items():
            kinds[kind] += n
            norm_steps[SIM_STEP_NORMS[kind]] += n
        norm_steps["sample"] = sample_calls(conf, CLI_ITERS)
        want = expected_launches(norms, conf, norm_steps)
        want_design = designs_of_calls(norms, want, PATH_DESIGN_SHARE)
        want_graphs = {variant_label(*v): n - 1 for v, n in variants.items()
                       if n >= 2}
        got_graphs = {variant_label(k, e, h): n
                      for k, e, h, n in counts["graphs"]}
        vgg = [m["loss_gen_vgg_a"] for m in losses.values()
               if "loss_gen_vgg_a" in m]
        fused_per_step = step_launches(conf)["fused"]
        images = sorted(p.name for p in (run / "images").iterdir())
        from munit_tpu_torch.io import checkpoint
        snapshots = checkpoint.steps(str(run / "checkpoints"))
        emit(phase="vanilla_cli", config=name, batch=conf["batch_size"],
             numerics="bf16", seconds_incl_start=wall,
             iterations=CLI_ITERS, steps=dict(kinds),
             logged_steps=sorted(losses), finite=finite,
             loss_gen_vgg_a=vgg, fused_step_norm_launches=fused_per_step,
             graphs=got_graphs, expected_graphs=want_graphs,
             launches=counts["launches"], expected=want,
             launches_by_design=counts["launches_by_design"],
             expected_by_design=want_design, images=images,
             snapshots=snapshots, losses_last=losses.get(CLI_ITERS),
             note="gen_state 0, guided 0; the two runs side by side, "
                  "seconds from their common start; the launches include "
                  "the 8 sample grids' (guided 0: six decodes each); "
                  "fused_step_norm_launches: one fused step's, by design "
                  "of the code (config_256's guided step: 44 IN, 32 AdaIN, "
                  "8 LN each way)")
        check(sorted(losses) == list(range(conf["log_iter"],
                                           CLI_ITERS + 1,
                                           conf["log_iter"])),
              f"{name}: logged steps {sorted(losses)}")
        check(finite, f"{name}: a logged loss is not finite")
        if conf["vgg_w"] > 0:
            check(len(vgg) == len(losses) and all(v > 0 for v in vgg),
                  f"{name}: loss_gen_vgg_a {vgg}")
        check(sum(fused_per_step[k] for k in PATH_CALLS) > 84
              and sum(fused_per_step[k + "_bwd"] for k in PATH_CALLS) > 84,
              f"{name}: the guided: 0 fused step's launches "
              f"{fused_per_step} are not above config_256's 84 each way")
        check(got_graphs == want_graphs,
              f"{name}: graphs {got_graphs}, want {want_graphs}")
        check(counts["launches"] == want,
              f"{name}: launches {counts['launches']}, want {want}")
        check(counts["launches_by_design"] == want_design,
              f"{name}: launches by design {counts['launches_by_design']}, "
              f"want {want_design}")
        check(snapshots == [10, 20], f"{name}: snapshots {snapshots}")
        for k, v in counts["launches_by_design"].items():
            for d, n in v.items():
                total.setdefault(k, Counter())[d] += n
        out[name] = (run, cfg)
    return {k: dict(v) for k, v in total.items()}, out


def vanilla_parity_phase(MUNITTrainer, validate):
    """14(b): at full width, batch 1, parity numerics (TF32 off, cuDNN
    deterministic), config_256 with gen_state 0, guided 0 and vgg_w 1: a
    dis, a fused, a gen and a classifier_sr step on the card and on the CPU
    from one state (the CPU trainer's, its styles aside, loaded into the
    card's before each step) with the same explicit styles, drawn on the
    CPU: every loss within SIM_LOSS_RTOL relative."""
    conf = validate(vanilla_raw(CONFIG, VANILLA_ALL))
    set_numerics("tf32_off")
    torch.backends.cudnn.deterministic = True
    trs = {}
    try:
        trs = {d: cli_trainer(MUNITTrainer, conf, d)
               for d in ("cpu", "cuda")}
        batch = train_inputs(1, SEED + 141)
        inputs = {"cuda": batch, "cpu": [t.cpu() for t in batch]}
        g = torch.Generator().manual_seed(SEED + 142)
        it = conf["adaptation"]["classif_frequency"] - 1
        rows, worst, cpu_s = [], 0.0, 0.0
        for kind, n in VANILLA_STEPS:
            styles = [torch.randn((1, conf["gen"]["style_dim"]), generator=g)
                      for _ in range(n)]
            trs["cuda"].load_state_dict(
                without_styles(trs["cpu"].state_dict()))
            out = {}
            for dev, tr in trs.items():
                tr.iterations = it
                x_a, x_b, m_a, m_b = inputs[dev]
                st = [s.to(dev) for s in styles] or None
                t0 = time.perf_counter()
                if kind == "dis":
                    m = tr.dis_update(x_a, x_b, styles=st)
                elif kind == "gen":
                    m = tr.gen_update(x_a, x_b, m_a, m_b, styles=st)
                elif kind == "dis_gen":
                    m = tr.dis_gen_update(x_a, x_b, m_a, m_b, styles=st)
                else:
                    m = tr.domain_classifier_sr_update(
                        x_a, x_b, domain_synth=False,
                        lamb=conf["adaptation"]["dfeat_lambda"])
                out[dev] = {k: float(v) for k, v in m.items() if k != "lr"}
                if dev == "cpu":
                    cpu_s += time.perf_counter() - t0
            errs = {k: abs(out["cuda"][k] - w) / abs(w) if w else
                    abs(out["cuda"][k]) for k, w in out["cpu"].items()}
            key = max(errs, key=errs.get)
            worst = max(worst, errs[key])
            rows.append({"step": kind, "styles": n, "losses": len(errs),
                         "worst": key, "rel_err": errs[key],
                         "cpu": out["cpu"][key], "card": out["cuda"][key],
                         "loss_gen_vgg_a": out["cpu"].get("loss_gen_vgg_a")})
        emit(phase="vanilla_card_vs_cpu", batch=1, width="full (256, gen "
             "dim 64, 3-scale discriminators, VGG16 to relu5_3)",
             numerics="tf32_off", iteration=it, steps=rows,
             worst_rel_err=worst, tol=SIM_LOSS_RTOL, cpu_seconds=cpu_s,
             note="config_256 with gen_state 0, guided 0, vgg_w 1 (segmenter "
                  "and VGG seeded); each step from the CPU trainer's state, "
                  "loaded into the card's before it, with the same explicit "
                  "styles; every loss the step logs, relative to the CPU's "
                  "(absolute where the CPU's is 0)")
        check(worst <= SIM_LOSS_RTOL,
              f"vanilla card against CPU: {worst} > {SIM_LOSS_RTOL}: {rows}")
        check(all(r["loss_gen_vgg_a"] > 0 for r in rows
                  if r["step"] in ("gen", "dis_gen")), f"VGG terms: {rows}")
    finally:
        torch.backends.cudnn.deterministic = False
        del trs
        gc.collect()
        torch.cuda.empty_cache()


def vanilla_resume_phase(MUNITTrainer, validate, tmp: Path):
    """14(c): the vanilla defaults with vgg_w 1, bf16, batch 1, captured:
    10 iterations, a checkpoint, and a trainer of other weights and another
    style seed that has run (and captured) 10 iterations restored from it
    in place: its whole state, the style stream's state and the display
    styles too, equal to the saved one bit for bit, its graphs kept; then
    the 11th iteration's styles equal the uninterrupted run's."""
    from munit_tpu_torch.io import checkpoint
    from munit_tpu_torch.train.trainer import train_steps
    conf = validate(vanilla_raw(None, {"vgg_w": 1}))
    set_numerics("bf16")
    batch = numerics_inputs(train_inputs(1, SEED + 143), "bf16")
    tr = cli_trainer(MUNITTrainer, conf, "cuda")
    train_steps(tr, *batch, range(SIM_RESUME_AT))
    saved = state_leaves(tr)
    ckpt = str(tmp / "vanilla_checkpoints")
    checkpoint.save_checkpoint(ckpt, tr.state_dict(), SIM_RESUME_AT)
    want = spy_draws(tr)
    train_steps(tr, *batch, [SIM_RESUME_AT])
    del tr
    other = cli_trainer(MUNITTrainer, conf, "cuda", SEED + 1)
    train_steps(other, *batch, range(SIM_RESUME_AT))
    graphs_before = len(other._graphs)
    start = checkpoint.resume(other, ckpt)
    not_restored = restored_exactly(state_leaves(other), saved)
    got = spy_draws(other)
    train_steps(other, *batch, [SIM_RESUME_AT])
    torch.cuda.synchronize()
    same = len(got) == len(want) == 4 and all(
        torch.equal(a, b) for a, b in zip(got, want))
    emit(phase="vanilla_resume", batch=1, numerics="bf16",
         resumed_from=start, leaves=len(saved[0]),
         not_restored=not_restored, graphs_before_resume=graphs_before,
         graphs_after_resume=len(other._graphs),
         draws_after_resume=len(got), draws_equal=same,
         style_dtype=str(got[0].dtype) if got else None)
    check(start == SIM_RESUME_AT, f"resumed from {start}")
    check("styles/generator" in saved[0], "the style stream is not saved")
    check(not not_restored, f"resume did not restore {not_restored[:5]}")
    check(graphs_before == len(other._graphs) > 0,
          "load_state_dict dropped the captured steps")
    check(same, "the styles after the resume differ from the "
                "uninterrupted run's")
    check(got[0].dtype == torch.bfloat16, "bf16 styles expected")
    del other
    torch.cuda.empty_cache()


def translate_batch_model_ms(cfg: Path, ckpts: str) -> dict:
    """What translate_batch runs on the card for one 256x256 image, the
    content encode and the batched decode over VANILLA_STYLES styles: host
    ms (median of 10, each ending in a synchronise), and its device time by
    kernel group and its largest kernels in one profiled run."""
    from munit_tpu_torch.cli.translate import load_generator_weights
    from munit_tpu_torch.config import get_config
    from munit_tpu_torch.nn.generator import GenBundle
    conf = get_config(str(cfg))
    gen = GenBundle(conf, "cuda")
    gen.load_state_dict(load_generator_weights(ckpts))
    x = train_inputs(1, SEED + 145)[0]
    styles = torch.randn((VANILLA_STYLES, conf["gen"]["style_dim"]),
                         generator=torch.Generator().manual_seed(SEED)).cuda()

    def one():
        c = gen.encode_content(x, 1)
        gen.decode(c.repeat(VANILLA_STYLES, 1, 1, 1), styles, 2)
    with torch.inference_mode():
        ms, _ = host_ms(one, 10)
        rows, _ = device_profile(one, 1)
    return {"model_ms_per_image": ms,
            "model_device_ms_by_group": grouped(rows),
            "model_top_kernels": [{"ms": r[0], "calls": r[2],
                                   "kernel": r[1][:90]} for r in rows[:6]]}


def vanilla_translate_phase(norms, run: Path, cfg: Path, data: dict,
                            tmp: Path):
    """14(d): from the vanilla run's step-20 snapshot, `translate_batch
    --num_style 10` over phase 12's 16 domain-A JPEGs on the card (twice:
    the second run timed), and over the first two on the CPU with the same
    seed, hence the same styles: every output within
    VANILLA_TRANSLATE_ATOL; its norm launches (one encode and one decode of
    10 a image); then `translate` from the same snapshot."""
    from munit_tpu_torch.__main__ import main as entry
    from munit_tpu_torch.cli import translate_batch
    from PIL import Image
    paths = Path(data["data_list_train_a"]).read_text().split()
    folders = {"all": tmp / "tb_in", "cpu": tmp / "tb_in_cpu"}
    for key, folder in folders.items():
        folder.mkdir()
        for p in paths[:VANILLA_CPU_IMAGES] if key == "cpu" else paths:
            shutil.copy(p, folder)
    ckpts = str(run / "checkpoints")    # the CLI sets f32, TF32 off

    def tb(folder, out, device):
        return translate_batch.main([
            "--config", str(cfg), "--checkpoint", ckpts, "--input_folder",
            str(folder), "--output_folder", str(out), "--num_style",
            str(VANILLA_STYLES), "--seed", str(SEED), "--output_only",
            "--device", device])
    norms.reset_launches()
    t0 = time.perf_counter()
    tb(folders["all"], tmp / "tb_card0", "cuda")
    cold = time.perf_counter() - t0
    launches = {k: v for k, v in norms.launches.items() if v}
    t0 = time.perf_counter()
    card = tb(folders["all"], tmp / "tb_card", "cuda")
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = tb(folders["cpu"], tmp / "tb_cpu", "cpu")
    cpu_s = time.perf_counter() - t0
    err = max(float(np.abs(a - b).max()) for a, b in zip(card, cpu))
    model = translate_batch_model_ms(cfg, ckpts)
    written = [sorted(p.name for p in (tmp / f"tb_card_{j:02d}").iterdir())
               for j in range(VANILLA_STYLES)]
    n = len(paths)
    want = {"instance_norm": 11 * n, "adain": 8 * n, "whole_layer_norm": 2 * n}
    emit(phase="vanilla_translate_batch", images=n, styles=VANILLA_STYLES,
         ms_per_image=warm / n * 1e3, ms_per_image_first_run=cold / n * 1e3,
         **model,
         cpu_images=len(cpu), cpu_seconds=cpu_s, max_abs_err=err,
         atol=VANILLA_TRANSLATE_ATOL, launches=launches, expected=want,
         shapes=sorted({tuple(a.shape) for a in card}),
         note="ms_per_image: host clock over the whole command (its "
              "start, the checkpoint's load, decode, 10 JPEG writes an "
              "image), the second run timed; model_ms_per_image: one "
              "image's content encode and 10-style decode alone, median of "
              "10, in the numerics the CLI set (f32, TF32 off); card "
              "against the CPU on the first images, the same seeded "
              "styles")
    check(all(w == sorted(Path(p).name for p in paths) for w in written),
          "translate_batch did not write every image into every folder")
    check(all(a.shape == (VANILLA_STYLES, 256, 256, 3) for a in card),
          f"translate_batch shapes {[a.shape for a in card[:2]]}")
    check(err <= VANILLA_TRANSLATE_ATOL,
          f"translate_batch card against CPU: {err}")
    check(launches == want, f"translate_batch launches {launches}, "
                            f"want {want}")

    (tmp / "vt_in").mkdir()
    for i, p in enumerate(paths[:2]):
        Image.open(p).save(tmp / "vt_in" / f"input{i}.jpg")
    style = Path(data["data_list_train_b"]).read_text().split()[0]
    norms.reset_launches()
    rc = entry(["translate", "--config", str(cfg), "--checkpoint", ckpts,
                "--input", str(tmp / "vt_in"), "--style", style,
                "--output_folder", str(tmp / "vt_out")])
    outs = sorted(p.name for p in (tmp / "vt_out").iterdir())
    tr_launches = {k: v for k, v in norms.launches.items() if v}
    emit(phase="vanilla_translate", outputs=outs, launches=tr_launches)
    check(rc == 0 and outs == ["output000.jpg", "output001.jpg"],
          f"translate wrote {outs}")
    check(tr_launches == {"instance_norm": 22, "adain": 16,
                          "whole_layer_norm": 4},
          f"translate launches {tr_launches}")


def vanilla_time_phase(MUNITTrainer, validate):
    """14(e): each vanilla flavor at batch 1 in bf16 on tensors already on
    the card: capture_warmup iterations, then ms per iteration captured
    (median of 3 rounds of 10) and eager (1 round of the next 5, same
    trainer), ms per step kind (median of 5), peak memory, the graphs and
    their capture seconds."""
    from munit_tpu_torch.train.trainer import (cadence_step, cadence_steps,
                                               capture_warmup, train_steps)
    set_numerics("bf16")
    for name, base, over in VANILLA_RUNS:
        conf = validate({**vanilla_raw(base, over), "batch_size": 1})
        tr = cli_trainer(MUNITTrainer, conf, "cuda")
        batch = numerics_inputs(train_inputs(1, SEED + 144), "bf16")
        warm = capture_warmup(conf)
        t0 = time.perf_counter()
        train_steps(tr, *batch, range(warm))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        graphs = len(tr._graphs)
        timed = range(warm, warm + SIM_TIME_ITERS)

        def iterations():
            train_steps(tr, *batch, timed)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        captured_ms, rounds = host_ms(iterations, 3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(len(tr._graphs) == graphs, f"{name}: a step was captured "
              "on the clock")
        captured, tr._capture = tr._capture, False
        eager_ms = eager_round_ms(tr, batch, timed.stop)
        tr._capture = captured
        it = conf["adaptation"]["classif_frequency"] - 1
        steps = {}
        for kind, _ in cadence_steps(conf, it):
            tr.iterations = it
            steps[kind], _ = host_ms(lambda: cadence_step(
                tr, conf, kind, *batch), 5)
        check(len(tr._graphs) == graphs, f"{name}: the step timing "
              "captured a step")
        keys = [{"kind": k[0], "extrapolate": k[1],
                 "replays": tr._graphs.replays[k],
                 "capture_s": tr._graphs.capture_seconds[k]}
                for k in tr._graphs.capture_seconds]
        emit(phase="vanilla_time", config=name, batch=1, numerics="bf16",
             ms_per_iteration_captured=captured_ms / SIM_TIME_ITERS,
             ms_per_iteration_eager=eager_ms,
             captured_rounds_ms=[r / SIM_TIME_ITERS for r in rounds],
             step_ms_captured=steps, peak_memory_gb=peak,
             graph_pool_gb=tr._graphs.pool_bytes() / 2**30, graphs=graphs,
             graph_keys=keys, warmup_iterations=warm, warmup_seconds=warm_s,
             note="host clock, each round ending in a synchronise; "
                  "captured: replays only; eager: the next 5 iterations on "
                  "the same trainer, one round, no warm-up; step_ms: one "
                  "step of each kind of "
                  "iteration 14, replayed; peak_memory_gb: the most "
                  "allocated during the captured rounds")
        del tr
        gc.collect()
        torch.cuda.empty_cache()


def vanilla_phase(norms, get_config, validate, data, tmp: Path):
    """Phase 14: vanilla MUNIT (gen_state 0, guided 0, the VGG loss): the
    train CLI on two flavors, card against CPU, resume, translate_batch and
    translate from a snapshot, timing; returns the CLI runs' norm launches
    by design."""
    from munit_tpu_torch.train.trainer import MUNITTrainer, step_variants
    t0 = time.perf_counter()
    launches, runs = vanilla_cli_phase(
        norms, get_config, step_variants, data, tmp,
        lambda: vanilla_parity_phase(MUNITTrainer, validate))
    vanilla_resume_phase(MUNITTrainer, validate, tmp)
    vanilla_translate_phase(norms, *runs["vanilla"], data, tmp)
    vanilla_time_phase(MUNITTrainer, validate)
    emit(phase="vanilla_seconds", seconds=time.perf_counter() - t0)
    return launches


def vanilla_alone() -> int:
    """``python3 chip_smoke.py --vanilla``: the build and phase 14 alone,
    for working on it; the kernel line and status line are the full
    run's."""
    from munit_tpu_torch.config import get_config, validate
    from munit_tpu_torch.kernels import build, norms
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        data = write_train_data(Path(tmp) / "data")
        vanilla_phase(norms, get_config, validate, data, Path(tmp))
    return 0


# ---------------------------------------------------------------- phase 15

HD_CONFIG = ROOT / "configs" / "config_HD.yaml"
HD_CROP = 512
# The HD path's norm calls per image at each (H, W, C): a content encode's
# IN (its stem at 512², its down at 256², 9 at 128²), a decode's 8 AdaIN
# at 128² and its up-stage LN at 256² and 512².
HD_CALLS = {
    "instance_norm": {(512, 512, 64): 1, (256, 256, 128): 1,
                      (128, 128, 256): 9},
    "adain": {(128, 128, 256): 8},
    "whole_layer_norm": {(256, 256, 128): 1, (512, 512, 64): 1},
}
HD_SHAPES = [(512, 512, 64), (256, 256, 128), (128, 128, 256)]
# The batches of the HD calls: batch 1 narrow (1) and wide (2, the [recon
# | cross] decodes), batch 8 narrow at K = 2 (4, a micro-batch) and K = 1
# (8). Every one takes the grid design.
HD_BATCHES = (1, 2, 4, 8)
HD_DESIGN_SHARE = {k: {"grid": 1} for k in HD_CALLS}
# Backward calls of one narrow fused step at batch 1 (config_HD's default)
# by (batch multiple, H, W, C), as BWD_CALLS: 4 content encodes, 6 decodes
# (recon, cross and cycle, a call each)
HD_BWD_CALLS = {
    "instance_norm": {(1, 512, 512, 64): 4, (1, 256, 256, 128): 4,
                      (1, 128, 128, 256): 36},
    "adain": {(1, 128, 128, 256): 48},
    "whole_layer_norm": {(1, 256, 256, 128): 6, (1, 512, 512, 64): 6},
}
HD_DATA_SIZE = 600           # config_HD's new_size
HD_CLI_KEYS = {"max_iter": CLI_ITERS, "snapshot_save_iter": 10,
               "image_save_iter": 10, "image_display_iter": 5,
               "num_workers": 8}
HD_TIME_ROUNDS, HD_TIME_ITERS = 3, 10
# grad_accum at full width, bf16, captured: bench.py's spec (config_256) at
# batch 8 with K = 1, 2, 4; config_HD at batch 8 (wide 0) with K = 1, 2;
# each timed over rounds of bench.py's 15-iteration cycle
ACCUM_BATCH = 8
ACCUM_RUNS = (("config_256", CONFIG, 256, (1, 2, 4)),
              ("config_HD", HD_CONFIG, HD_CROP, (1, 2)))
ACCUM_ROUNDS, ACCUM_ITERS = 3, 15


def hd_cases():
    """Phase 15(a)'s forward cases for ``kernel_phase``: every HD shape at
    every HD batch, with the wrappers that the HD path calls there."""
    for b in HD_BATCHES:
        for hwc in HD_SHAPES:
            yield b, hwc, tuple(n for n, calls in HD_CALLS.items()
                                if hwc in calls)


def launches_by_design(norms):
    return {k: dict(v) for k, v in norms.design_launches.items()}


def hd_time_phase(norms, MUNITTrainer, validate):
    """15(b): config_HD at its shipped batch 1, bf16, captured, narrow
    (wide 0, its default at 512²) and wide (1), full width, the segmenter
    seeded, on tensors already on the card: capture_warmup iterations with
    their norm launches by design (every one on the grid design), one
    replayed fused step's launches against step_launches' count, ms per
    captured iteration (median of 3 rounds of 10), ms per step kind
    (replayed, median of 5), peak allocated and the graphs' pool."""
    from munit_tpu_torch.train.trainer import (cadence_step, capture_warmup,
                                               train_steps)
    set_numerics("bf16")
    out = {}
    for wide in (0, 1):
        conf = validate(vanilla_raw(HD_CONFIG, {"wide": wide}))
        tr = cli_trainer(MUNITTrainer, conf, "cuda")
        check(tr.wide == wide and tr.grad_accum == 1,
              f"config_HD wide {wide}: trainer wide {tr.wide}")
        batch = numerics_inputs(train_inputs(1, SEED + 150, HD_CROP), "bf16")
        warm = capture_warmup(conf)
        norms.reset_launches()
        t0 = time.perf_counter()
        train_steps(tr, *batch, range(warm))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        want = designs_of_calls(norms, expected_launches(
            norms, conf, cadence(conf, warm)), HD_DESIGN_SHARE)
        got = launches_by_design(norms)
        check(got == want, f"config_HD wide {wide}: warm-up launches {got}, "
                           f"want {want}")
        graphs = len(tr._graphs)
        norms.reset_launches()
        tr.iterations = conf["ratio_disc_gen"] - 1
        x_a, x_b, m_a, m_b = batch
        tr.dis_gen_update(x_a, x_b, m_a, m_b)
        fused = launches_by_design(norms)
        fused_want = designs_of_calls(norms, step_launches(conf)["fused"],
                                      HD_DESIGN_SHARE)
        check(fused == fused_want, f"config_HD wide {wide}: a replayed fused "
                                   f"step's launches {fused}, want "
                                   f"{fused_want}")
        timed = range(warm, warm + HD_TIME_ITERS)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        captured_ms, rounds = host_ms(
            lambda: train_steps(tr, *batch, timed), HD_TIME_ROUNDS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        it = conf["adaptation"]["classif_frequency"] - 1
        steps = {}
        for kind in ("dis", "dis_gen", "classifier_sr"):
            tr.iterations = it
            steps[kind], _ = host_ms(lambda: cadence_step(
                tr, conf, kind, *batch), 5)
        check(len(tr._graphs) == graphs, f"config_HD wide {wide}: a step "
                                         "was captured on the clock")
        out[wide] = {"ms": captured_ms / HD_TIME_ITERS, "launches": got,
                     "fused_launches": fused}
        emit(phase="hd_time", config="config_HD", batch=1, wide=wide,
             numerics="bf16",
             ms_per_iteration_captured=captured_ms / HD_TIME_ITERS,
             captured_rounds_ms=[r / HD_TIME_ITERS for r in rounds],
             images_per_s=HD_TIME_ITERS / (captured_ms / 1e3),
             step_ms_captured=steps, peak_memory_gb=peak,
             graph_pool_gb=tr._graphs.pool_bytes() / 2**30,
             live_gb=torch.cuda.memory_allocated() / 2**30, graphs=graphs,
             capture_seconds={step_label(k): v for k, v in
                              tr._graphs.capture_seconds.items()},
             warmup_iterations=warm, warmup_seconds=warm_s,
             warmup_launches_by_design=got,
             fused_step_launches_by_design=fused,
             note="host clock, each round ending in a synchronise; "
                  "captured: replays only; step_ms: one step of each kind "
                  "of iteration 14, replayed; peak_memory_gb: the most "
                  "allocated during the captured rounds; every HD norm "
                  "call on the grid design")
        del tr, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def hd_parity_phase(MUNITTrainer, validate):
    """15(b): config_HD's fused step at full width, batch 1, narrow, in
    parity numerics (TF32 off, cuDNN deterministic), on the card and on the
    CPU from one state: every loss within SIM_LOSS_RTOL relative."""
    conf = validate(vanilla_raw(HD_CONFIG, {}))
    set_numerics("tf32_off")
    torch.backends.cudnn.deterministic = True
    trs = {}
    try:
        trs = {d: cli_trainer(MUNITTrainer, conf, d) for d in ("cpu", "cuda")}
        trs["cuda"].load_state_dict(without_styles(trs["cpu"].state_dict()))
        batch = train_inputs(1, SEED + 152, HD_CROP)
        out, cpu_s = {}, 0.0
        for dev, tr in trs.items():
            tr.iterations = conf["ratio_disc_gen"] - 1
            t0 = time.perf_counter()
            m = tr.dis_gen_update(*(t.to(dev) for t in batch))
            out[dev] = {k: float(v) for k, v in m.items() if k != "lr"}
            if dev == "cpu":
                cpu_s = time.perf_counter() - t0
        errs = {k: abs(out["cuda"][k] - w) / abs(w) if w else
                abs(out["cuda"][k]) for k, w in out["cpu"].items()}
        worst = max(errs, key=errs.get)
        emit(phase="hd_card_vs_cpu", config="config_HD", batch=1, wide=0,
             width="full (512², gen dim 64, 3-scale discriminators)",
             numerics="tf32_off", losses=len(errs), worst=worst,
             rel_err=errs[worst], tol=SIM_LOSS_RTOL, cpu=out["cpu"],
             card=out["cuda"], cpu_seconds=cpu_s,
             note="one fused step from the CPU trainer's state, loaded into "
                  "the card's; every loss it logs, relative to the CPU's")
        check(errs[worst] <= SIM_LOSS_RTOL,
              f"config_HD card against CPU: {worst} {errs[worst]}")
        check(out["cpu"]["loss_sem_seg"] > 0, "config_HD: no semantic loss")
    finally:
        torch.backends.cudnn.deterministic = False
        del trs
        gc.collect()
        torch.cuda.empty_cache()


def hd_cli_start(tmp: Path):
    """15(b): `python -m munit_tpu_torch train` on config_HD as shipped
    (bf16, batch 1, display_size 8) but for HD_CLI_KEYS and the data keys,
    over 16 seeded 600x600 JPEGs per domain with PNG masks, in a
    subprocess; returns (config path, counts file, process)."""
    import yaml
    data = write_train_data(tmp / "hd_data", HD_DATA_SIZE)
    cfg = tmp / "hd" / "config_HD.yaml"
    cfg.parent.mkdir(parents=True, exist_ok=True)
    cfg.write_text(yaml.safe_dump({**vanilla_raw(HD_CONFIG, {}), **data,
                                   **HD_CLI_KEYS}))
    counts_file = tmp / "hd_counts.json"
    proc = subprocess.Popen(
        [sys.executable, "-c", SIM_RUNNER, str(counts_file), "train",
         "--config", str(cfg), "--output_path", str(tmp / "hd")],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    return cfg, counts_file, proc, time.perf_counter()


def hd_cli_check(norms, get_config, step_variants, started, tmp: Path):
    """Waits for the HD train CLI: every logged loss finite, the semantic
    loss above 0, snapshots at 10 and 20, the display_size-8 grids written,
    every step variant that ran twice captured and replayed, the norm
    launches of its steps and sample grids by design (all grid)."""
    cfg, counts_file, proc, t0 = started
    _, errs = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"config_HD train CLI exit {proc.returncode}: {errs[-3000:]}")
    conf = get_config(str(cfg))
    counts = json.loads(counts_file.read_text())
    run = tmp / "hd" / "outputs" / "config_HD"
    lines = [json.loads(ln) for ln in (run / "metrics.jsonl").open()]
    losses = {m["step"]: m for m in lines if "loss_dis_total" in m}
    finite = all(np.isfinite(v) for m in losses.values()
                 for k, v in m.items() if k != "step")
    variants = Counter(step_variants(conf, range(CLI_ITERS)))
    norm_steps = Counter()
    for (kind, *_), n in variants.items():
        norm_steps[SIM_STEP_NORMS[kind]] += n
    norm_steps["sample"] = sample_calls(conf, CLI_ITERS)
    want = designs_of_calls(norms, expected_launches(norms, conf, norm_steps),
                            HD_DESIGN_SHARE)
    want_graphs = {variant_label(*v): n - 1 for v, n in variants.items()
                   if n >= 2}
    got_graphs = {variant_label(k, e, h): n
                  for k, e, h, n in counts["graphs"]}
    from munit_tpu_torch.io import checkpoint
    snapshots = checkpoint.steps(str(run / "checkpoints"))
    images = sorted(p.name for p in (run / "images").iterdir())
    sem = [m["loss_sem_seg"] for m in losses.values() if "loss_sem_seg" in m]
    emit(phase="hd_cli", config="config_HD", batch=conf["batch_size"],
         display_size=conf["display_size"], crop=conf["crop_image_height"],
         new_size=conf["new_size"], numerics="bf16",
         seconds_incl_start=wall, iterations=CLI_ITERS,
         logged_steps=sorted(losses), finite=finite, loss_sem_seg=sem,
         graphs=got_graphs, expected_graphs=want_graphs,
         launches_by_design=counts["launches_by_design"],
         expected_by_design=want, images=images, snapshots=snapshots,
         losses_last=losses.get(CLI_ITERS),
         note="seconds from the subprocess's start; the launches include "
              "the 8 sample grids' (display_size 8 at 512²)")
    check(sorted(losses) == list(range(1, CLI_ITERS + 1)),
          f"config_HD CLI: logged steps {sorted(losses)}")
    check(finite and sem and all(v > 0 for v in sem),
          f"config_HD CLI: losses finite {finite}, loss_sem_seg {sem}")
    check(got_graphs == want_graphs,
          f"config_HD CLI: graphs {got_graphs}, want {want_graphs}")
    check(counts["launches_by_design"] == want,
          f"config_HD CLI: launches {counts['launches_by_design']}, want "
          f"{want}")
    check(snapshots == [10, 20], f"config_HD CLI: snapshots {snapshots}")
    check("gen_a2b_test_00000020.jpg" in images,
          f"config_HD CLI: images {images}")
    return counts["launches_by_design"]


def fused_losses_close(tr, batch, label):
    """K > 1: the fused step captured (replayed) and eager from one state,
    every loss within SIM_LOSS_RTOL relative: graph-replay fidelity, the
    port against itself (K = 2's correctness rests on the CPU lockstep
    with the JAX trainer)."""
    from munit_tpu_torch.io import checkpoint
    x_a, x_b, m_a, m_b = batch
    state = checkpoint.to_host(tr.state_dict())
    out = {}
    for mode, capture in (("captured", True), ("eager", False)):
        tr.load_state_dict(state)
        tr._capture, tr.iterations = capture, 4
        out[mode] = {k: float(v) for k, v in tr.dis_gen_update(
            x_a, x_b, m_a, m_b).items() if k != "lr"}
    tr._capture = True
    errs = {k: abs(out["captured"][k] - w) / abs(w) if w else
            abs(out["captured"][k]) for k, w in out["eager"].items()}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= SIM_LOSS_RTOL,
          f"{label}: captured fused step against eager: {worst} "
          f"{errs[worst]}")
    return {"worst": worst, "rel_err": errs[worst], "tol": SIM_LOSS_RTOL}


def accum_phase(MUNITTrainer, validate):
    """15(c): grad_accum at full width, bf16, on tensors already on the
    card: config_256 at batch 8 with K = 1, 2, 4 and config_HD at batch 8
    (narrow) with K = 1, 2. Each: one eager cycle (4 dis steps, a fused
    step) for its peak allocated; capture_warmup iterations (the eager
    cache emptied after each, before any capture); ms per captured
    iteration over rounds of bench.py's 15-iteration cycle, images/s as
    bench.py counts them, the graphs' pool and what is live; at K = 2 the
    captured fused step against the eager one from one state. The pool
    must fall as K rises."""
    from munit_tpu_torch.train.trainer import capture_warmup, train_steps
    set_numerics("bf16")
    out = {}
    for name, base, size, ks in ACCUM_RUNS:
        pools = []
        for k in ks:
            conf = validate(vanilla_raw(base, {"batch_size": ACCUM_BATCH,
                                               "grad_accum": k}))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)   # adv_lambda
                tr = new_trainer(MUNITTrainer, conf, "cuda")
            check(tr.grad_accum == k, f"{name} K={k}: {tr.grad_accum}")
            batch = numerics_inputs(train_inputs(ACCUM_BATCH, SEED + 151,
                                                 size), "bf16")
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tr._capture = False
            t0 = time.perf_counter()
            train_steps(tr, *batch, range(conf["ratio_disc_gen"]))
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
            eager_peak = torch.cuda.max_memory_allocated() / 2**30
            tr._capture = True
            warm = capture_warmup(conf)
            t0 = time.perf_counter()
            for it in range(warm):
                train_steps(tr, *batch, [it])
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            warm_s = time.perf_counter() - t0
            graphs = len(tr._graphs)
            timed = range(warm, warm + ACCUM_ITERS)
            torch.cuda.reset_peak_memory_stats()
            ms, rounds = host_ms(lambda: train_steps(tr, *batch, timed),
                                 ACCUM_ROUNDS)
            check(len(tr._graphs) == graphs,
                  f"{name} K={k}: a step was captured on the clock")
            pool = tr._graphs.pool_bytes() / 2**30
            live = torch.cuda.memory_allocated() / 2**30
            row = {"config": name, "batch": ACCUM_BATCH, "grad_accum": k,
                   "crop": size, "wide": tr.wide, "numerics": "bf16",
                   "ms_per_iteration": ms / ACCUM_ITERS,
                   "rounds_ms": [r / ACCUM_ITERS for r in rounds],
                   "images_per_s": ACCUM_BATCH * ACCUM_ITERS / (ms / 1e3),
                   "peak_allocated_eager_gb": eager_peak,
                   "peak_allocated_captured_gb":
                       torch.cuda.max_memory_allocated() / 2**30,
                   "graph_pool_gb": pool, "live_gb": live,
                   "pool_plus_live_gb": pool + live, "graphs": graphs,
                   "capture_seconds": {step_label(key): v for key, v in
                                       tr._graphs.capture_seconds.items()},
                   "eager_cycle_seconds": eager_s, "warmup_iterations": warm,
                   "warmup_seconds": warm_s}
            if k == 2:
                row["captured_vs_eager"] = fused_losses_close(
                    tr, batch, f"{name} K=2")
            emit(phase="grad_accum", **row,
                 note="host clock, each round of bench.py's cycle (12 dis, "
                      "3 fused, 1 classifier_sr step) ending in a "
                      "synchronise; images/s: batch x iterations / seconds "
                      "(bench.py's count); peak_allocated_eager_gb: one "
                      "eager cycle of 4 dis steps and a fused step; "
                      "graph_pool_gb: what the graphs' one pool holds; "
                      "live_gb: allocated after the rounds")
            pools.append(pool)
            out[(name, k)] = row
            del tr, batch
            gc.collect()
            torch.cuda.empty_cache()
        check(all(p > q for p, q in zip(pools, pools[1:])),
              f"{name}: the graphs' pool {pools} GB does not fall with K "
              f"{ks}")
    return out


def hd_phase(norms, get_config, validate, tmp: Path):
    """Phase 15: config_HD and grad_accum (ROADMAP 13, 13b): the plans and
    the norm kernels forward and backward at the HD shapes (15a: phases 2
    and 6's checks and timings, every call on the grid design), config_HD
    at batch 1 narrow and wide (timing, launches, card against CPU while
    its train CLI runs), and grad_accum's memory and time at batch 8.
    Returns the kernels' errors and times (forward, backward), the batch-1
    runs and the CLI's launches by design."""
    from munit_tpu_torch.train.trainer import MUNITTrainer, step_variants
    t0 = time.perf_counter()
    parity_mode(True)
    plan_phase(norms, HD_SHAPES, HD_BATCHES, None, "hd_plan")
    err, times = kernel_phase(norms, hd_cases(), SEED + 15, "hd_kernel")
    bwd_err, bwd_times = backward_phase(norms, HD_BWD_CALLS, HD_BATCHES,
                                        SEED + 16, "hd_backward_kernel")
    runs = hd_time_phase(norms, MUNITTrainer, validate)
    started = hd_cli_start(tmp)
    hd_parity_phase(MUNITTrainer, validate)
    cli = hd_cli_check(norms, get_config, step_variants, started, tmp)
    accum_phase(MUNITTrainer, validate)
    emit(phase="hd_seconds", seconds=time.perf_counter() - t0)
    return {"err": err, "times": times, "bwd_err": bwd_err,
            "bwd_times": bwd_times, "runs": runs, "cli": cli}


def hd_alone() -> int:
    """``python3 chip_smoke.py --hd``: the build and phase 15 alone, for
    working on it; the kernel line and status line are the full run's."""
    from munit_tpu_torch.config import get_config, validate
    from munit_tpu_torch.kernels import build, norms
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        hd_phase(norms, get_config, validate, Path(tmp))
    return 0


# ---------------------------------------------------------------- phase 16

EVAL_PAIRS = 32            # seeded JPEG pairs at config_256's new_size
EVAL_BATCH = 8             # the translated pools compared card against CPU
EVAL_TIME_BATCHES = (8, 32)
EVAL_STYLES, EVAL_IS_IMAGES = 3, 2     # translate_batch --compute_IS
EVAL_FID_PAIRS = 4         # the training run's FID set
# the first fused step (iteration 4) falls between the two snapshots
EVAL_TRAIN_ITERS, EVAL_SNAPSHOT = 6, 3
# the CPU side's threads ("fid" translates 32 pairs), so that the card's
# host work and the train CLIs keep some of the host's cores
EVAL_CPU_THREADS = {"fid": 4, "side": 2}
# Card against CPU: pools of the same real images, of their largest
# magnitude (float32 convolutions, TF32 off, summed in another order); of
# translations, which differ by up to phase 4's 1e-3; FID, KID, IS, CIS
EVAL_POOL_TOL, EVAL_FAKE_TOL, EVAL_SCORE_RTOL = 1e-4, 1e-3, 1e-3
EVAL_SELF_TOL = 1e-4       # a set's FID against its own moments, of tr(sigma)
# eval_fid 1 against eval_fid 0 on the card, every loss after the first
# iteration: no two card runs are bitwise (the reflect pad's backward adds
# with atomics; two eval_fid 0 runs part by ~1e-6 relative here), so the
# hook's neutrality is checked bit for bit on the state around it instead
EVAL_LOSS_RTOL = 1e-5
EVAL_NS_RTOL = 1e-3        # Newton-Schulz FID against scipy's, one set
NS_DIM = 2048
# The CPU side, in two processes beside the card's work: "fid" runs
# evaluate fid --kid --device cpu; "side" runs compute_moments and
# translate_batch --compute_IS --compute_CIS with --device cpu, then the
# pools of the first EVAL_BATCH pairs' translations (evaluate.fid_pools).
# Each prints one JSON line last.
EVAL_CPU_RUNNER = """
import contextlib, io, json, sys
import numpy as np
from munit_tpu_torch.cli import compute_moments, evaluate, translate_batch
from munit_tpu_torch.cli.translate import load_generator
from munit_tpu_torch.config import get_config
from munit_tpu_torch.data.api import get_fid_data_loader
from munit_tpu_torch.dist.mesh import Replicas
from munit_tpu_torch.eval.inception import load_inception
mode, out, cfg, images, incep, gen, folder, styles, batch = sys.argv[1:10]
cpu = ["--device", "cpu"]
if mode == "fid":
    print(json.dumps(evaluate.main(["fid", "--config", cfg, "--checkpoint",
                                    gen, "--inception_ckpt", incep, "--kid"]
                                   + cpu)))
    sys.exit(0)
compute_moments.main(["--images", images, "--inception_ckpt", incep,
                      "--out", out + ".npz"] + cpu)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    outs = translate_batch.main(["--config", cfg, "--checkpoint", gen,
        "--input_folder", folder, "--output_folder", out + "_tb",
        "--num_style", styles, "--compute_IS", "--compute_CIS",
        "--inception_ckpt", incep] + cpu)
conf = get_config(cfg)
g = load_generator(gen, conf, "cpu")
loader = get_fid_data_loader(conf["data_list_fid_a"], conf["data_list_fid_b"],
                             int(batch), new_size=conf["new_size"])
fakes = evaluate.fid_pools(Replicas(["cpu"]), [g],
                           [load_inception(incep, "cpu")],
                           [next(iter(loader.batches()))])
np.savez(out + "_arrays.npz", outs=np.stack(outs), fakes=fakes)
print(json.dumps({"printed": buf.getvalue()}))
"""


# Put before SIM_RUNNER for phase 16(c): wraps the metric function that
# the train CLI attaches (cli/train.py::attach_fid_metrics) so that each
# FID at a snapshot is taken between two copies of what the training steps
# read (the trainer's state_dict: nets, optimizers, iterations, the style
# stream; the step scalars; every captured graph's input buffers), which
# must be equal bit for bit; the result goes to <counts file>.hook.json.
FID_HOOK_SPY = """
import json as _json, sys as _sys, torch as _torch
from munit_tpu_torch.cli import train as _cli
_hook_out, _attach = _sys.argv[1] + ".hook.json", _cli.attach_fid_metrics
_hook = {"calls": 0, "compared": 0, "changed": []}
def _snapshot(tr):
    flat = {}
    def walk(v, key):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(x, key + "/" + str(k))
        else:
            flat[key] = (v.detach().clone() if isinstance(v, _torch.Tensor)
                         else v)
    walk(tr.state_dict(), "state")
    flat["scalars"] = tr._scalars.clone()
    for key, step in tr._graphs._steps.items():
        for i, buf in enumerate(step.inputs):
            if buf is not None:
                flat["graph/" + str(key) + "/" + str(i)] = buf.clone()
    return flat
def _same(a, b):
    if isinstance(a, _torch.Tensor):
        return isinstance(b, _torch.Tensor) and _torch.equal(a, b)
    return a == b
def _spy_attach(conf, loaders, device, **kw):
    _attach(conf, loaders, device, **kw)
    metric = loaders.get("fid_metrics")
    if metric is None:
        return
    def watched(trainer, loader):
        before = _snapshot(trainer)
        fid = metric(trainer, loader)
        after = _snapshot(trainer)
        _hook["calls"] += 1
        _hook["compared"] += len(before)
        _hook["changed"] += [k for k, v in before.items()
                             if not _same(v, after.get(k))]
        with open(_hook_out, "w") as f:
            _json.dump(_hook, f)
        return fid
    loaders["fid_metrics"] = watched
_cli.attach_fid_metrics = _spy_attach
"""


def write_eval_data(root: Path) -> dict:
    """EVAL_PAIRS seeded DATA_SIZE² JPEGs a domain and their lists (all,
    the first EVAL_FID_PAIRS), and a folder of the first EVAL_IS_IMAGES of
    domain A."""
    from PIL import Image
    rng = np.random.RandomState(SEED + 16)
    (root / "is_in").mkdir(parents=True)
    lists = {}
    for dom in ("a", "b"):
        paths = []
        for i in range(EVAL_PAIRS):
            p = root / f"{dom}{i:02d}.jpg"
            img = Image.fromarray(rng.randint(0, 256, (DATA_SIZE, DATA_SIZE,
                                                       3), np.uint8))
            img.save(p, quality=90)
            if dom == "a" and i < EVAL_IS_IMAGES:
                img.save(root / "is_in" / f"x{i}.jpg", quality=90)
            paths.append(str(p))
        for name, part in ((dom, paths), (f"{dom}_few",
                                          paths[:EVAL_FID_PAIRS])):
            (root / f"{name}.txt").write_text("\n".join(part) + "\n")
            lists[name] = str(root / f"{name}.txt")
    lists["is_in"] = str(root / "is_in")
    return lists


def per_image_launches(conf) -> dict:
    """Norm launches of one guided a→b translation: a content encode (1 +
    n_downsample + 2 n_res IN) and a decode (2 n_res AdaIN, n_downsample
    LN); the style encoder runs none."""
    g = conf["gen"]
    return {"instance_norm": 1 + g["n_downsample"] + 2 * g["n_res"],
            "adain": 2 * g["n_res"], "whole_layer_norm": g["n_downsample"]}


def counts_of(norms) -> dict:
    return {k: v for k, v in norms.launches.items() if v}


def rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def eval_time_phase(gen, net, guided_a2b, pool_and_logits):
    """Translate+pool ms an image at EVAL_TIME_BATCHES (one batch, CUDA
    events, median of 5 after 2 warm-ups, the card otherwise idle) and the
    peak memory of the largest."""
    gen_rng = torch.Generator(device="cuda").manual_seed(SEED + 16)
    out = {}
    for b in EVAL_TIME_BATCHES:
        x_a, x_b = (torch.rand((b, 256, 256, 3), generator=gen_rng,
                               device="cuda") * 2 - 1 for _ in range(2))

        def step():
            with torch.no_grad():
                return pool_and_logits(net, guided_a2b(gen, x_a, x_b))[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated() / 2**30
        times = []
        for i in range(7):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            end.synchronize()
            if i >= 2:
                times.append(start.elapsed_time(end))
        out[b] = {"ms_per_image": float(np.median(times)) / b,
                  "ms_per_batch": float(np.median(times)),
                  "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
                  "live_gb_before": live}
        del x_a, x_b
    emit(phase="eval_time", by_batch={str(b): v for b, v in out.items()},
         numerics="f32, TF32 off (the evaluate CLI's)",
         note="one guided a→b translation of config_256 (seeded weights) "
              "and its InceptionV3 pool per image, batched; CUDA events "
              "around the whole batch; peak_gb: max_memory_allocated in "
              "its rounds (cuDNN's workspaces included), live_gb_before: "
              "what was allocated before them")
    return out


def timed(fn, *args):
    t0 = time.perf_counter()
    return fn(*args), time.perf_counter() - t0


def ns_phase(fid, pool):
    """Newton-Schulz's 400 iterations at 2048² on the card, timed, and its
    FID against scipy's on the same full-rank moments (4096 seeded
    samples a set, where the iteration converges); scipy runs in ``pool``
    on the host. Returns a function that waits for it, emits and checks,
    and returns the ms of one call."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    x1 = torch.randn((2 * NS_DIM, NS_DIM), generator=g, device="cuda")
    x2 = torch.randn((2 * NS_DIM, NS_DIM), generator=g, device="cuda") * 1.1 \
        + 0.2
    mu1, s1, mu2, s2 = x1.mean(0), fid.cov(x1), x2.mean(0), fid.cov(x2)
    prod = s1 @ s2
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fid.sqrt_newton_schulz(prod)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    got = fid.frechet_distance(mu1, s1, mu2, s2)
    want = pool.submit(timed, fid.frechet_distance_scipy,
                       *(t.double().cpu().numpy() for t in (mu1, s1, mu2, s2)))

    def finish():
        value, scipy_s = want.result()
        emit(phase="eval_newton_schulz", dim=NS_DIM, iterations=400,
             ms=times[1:], fid_newton_schulz=got, fid_scipy=value,
             rel_err=rel(got, value), tol=EVAL_NS_RTOL, scipy_seconds=scipy_s,
             note="ms: 400 iterations (800 matmuls, float32, TF32 off) of "
                  "one call after a first; scipy: sqrtm on the host, beside "
                  "the card's work")
        check(np.isfinite(got) and rel(got, value) <= EVAL_NS_RTOL,
              f"Newton-Schulz FID {got} against scipy {value}")
        return times[-1]
    return finish


def eval_cli_runs(lists, cfg_of, data, tmp: Path):
    """Phase 16(c)'s train CLIs, started: config_256 in parity (f32, TF32
    off) for EVAL_TRAIN_ITERS iterations, a snapshot every EVAL_SNAPSHOT,
    with eval_fid 1 and twice with eval_fid 0, in three processes side by
    side (SIM_RUNNER: launches and replays)."""
    runs = {}
    for name, eval_fid in (("fid", 1), ("plain", 0), ("plain_again", 0)):
        cfg = write_config(tmp / "eval_train" / name / "config_256.yaml", data,
                           {"max_iter": EVAL_TRAIN_ITERS, "log_iter": 1,
                            "snapshot_save_iter": EVAL_SNAPSHOT,
                            "image_save_iter": 1000,
                            "image_display_iter": 1000, "num_workers": 2,
                            "precision": "parity", "eval_fid": eval_fid,
                            **cfg_of(lists["a_few"], lists["b_few"])})
        counts = cfg.parent / "counts.json"
        proc = subprocess.Popen(
            [sys.executable, "-c", FID_HOOK_SPY + SIM_RUNNER, str(counts),
             "train", "--config", str(cfg), "--output_path",
             str(cfg.parent)],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
        runs[name] = (cfg, counts, proc)
    return runs


def eval_cli_wait(runs) -> dict:
    """Waits for 16(c)'s train CLIs; their launches, replays, losses and
    logged FID."""
    out = {}
    for name, (cfg, counts_file, proc) in runs.items():
        _, err = proc.communicate(timeout=600)
        check(proc.returncode == 0,
              f"eval train {name}: exit {proc.returncode}: {err[-3000:]}")
        run = cfg.parent / "outputs" / "config_256"
        lines = [json.loads(ln) for ln in (run / "metrics.jsonl").open()]
        hook = Path(f"{counts_file}.hook.json")
        out[name] = {
            "hook": json.loads(hook.read_text()) if hook.exists() else None,
            "counts": json.loads(counts_file.read_text()),
            "losses": {m["step"]: {k: v for k, v in m.items() if k != "step"}
                       for m in lines if "loss_dis_total" in m},
            "fid": {m["step"]: m["FID"] for m in lines if "FID" in m},
            "cfg": cfg, "run": run}
    return out


def eval_cli_check(out, evaluated, per_image):
    """16(c): FID logged at each snapshot, each taken between two copies
    of what the steps read that are equal bit for bit (FID_HOOK_SPY); the
    captured steps' replays as with eval_fid 0, and the launches those of
    eval_fid 0 plus one translation per FID pair and snapshot; the first
    iteration's losses bit for bit, every later one within EVAL_LOSS_RTOL
    of eval_fid 0's, beside two eval_fid 0 runs' own difference; the
    logged FID equal to ``evaluated``, `evaluate fid` on the last
    snapshot."""
    fid, plain, again = out["fid"], out["plain"], out["plain_again"]
    snaps = list(range(EVAL_SNAPSHOT, EVAL_TRAIN_ITERS + 1, EVAL_SNAPSHOT))
    extra = {k: len(snaps) * EVAL_FID_PAIRS * n for k, n in per_image.items()}
    want = {k: v + extra.get(k, 0)
            for k, v in plain["counts"]["launches"].items()}
    graphs = {name: sorted((kind, phase, tuple(flags), n)
                           for kind, phase, flags, n in r["counts"]["graphs"])
              for name, r in out.items()}
    pairs = [(step, k, v, plain["losses"][step][k], again["losses"][step][k])
             for step, m in fid["losses"].items() for k, v in m.items()]
    worst = max(rel(v, p) for _, _, v, p, _ in pairs)
    noise = max(rel(q, p) for _, _, _, p, q in pairs)
    unequal = [x for x in pairs
               if (x[0] == 1 and not x[2] == x[3] == x[4])
               or rel(x[2], x[3]) > EVAL_LOSS_RTOL]
    hook = fid["hook"] or {}
    emit(phase="eval_train_fid", iterations=EVAL_TRAIN_ITERS,
         snapshots=snaps, fid=fid["fid"], evaluate_fid_last=evaluated,
         hook=hook, launches=fid["counts"]["launches"], expected=want,
         graphs=graphs["fid"], graphs_without=graphs["plain"],
         losses_max_rel_diff=worst, eval_fid0_pair_max_rel_diff=noise,
         losses_unequal=unequal[:10], tol=EVAL_LOSS_RTOL,
         note="config_256, precision parity, batch 1, FID over "
              f"{EVAL_FID_PAIRS} pairs; hook: the FID calls, the tensors "
              "and values compared around them, those that changed; "
              "losses: eval_fid 1 against 0, beside two eval_fid 0 runs")
    check(sorted(fid["fid"]) == snaps and all(np.isfinite(v) for v in
                                              fid["fid"].values()),
          f"logged FID {fid['fid']}")
    check(hook.get("calls") == len(snaps) and hook.get("compared", 0) > 0
          and not hook.get("changed"), f"the FID hook touched {hook}")
    check(not plain["fid"] and not again["fid"], "eval_fid 0 logged FID")
    check(sorted(fid["losses"]) == list(range(1, EVAL_TRAIN_ITERS + 1)),
          f"logged steps {sorted(fid['losses'])}")
    check(graphs["fid"] == graphs["plain"],
          f"replays {graphs['fid']} against {graphs['plain']}")
    check(fid["counts"]["launches"] == want,
          f"launches {fid['counts']['launches']}, want {want}")
    check(not unequal, f"losses differ: {unequal[:5]}")
    check(rel(fid["fid"][snaps[-1]], evaluated) <= 1e-6,
          f"logged FID {fid['fid'][snaps[-1]]} against evaluate's "
          f"{evaluated}")


def eval_tools_phase(gen_sd, conf_path, tmp: Path):
    """16(d): checkpoint_tools import → export → pack on the card: the
    reference .pt back bit for bit, the optimizers fresh, the packed file
    the bfloat16 rounding of each weight."""
    from munit_tpu_torch.cli import checkpoint_tools
    from munit_tpu_torch.config import get_config
    from munit_tpu_torch.io import checkpoint
    from munit_tpu_torch.io.weights import (load_reference_checkpoint,
                                            reference_gen_blob)
    from munit_tpu_torch.nn import discriminator
    t0 = time.perf_counter()
    root = tmp / "tools"
    root.mkdir()
    torch.save(reference_gen_blob(gen_sd, 1), root / "gen.pt")
    conf = get_config(str(conf_path))
    g = torch.Generator().manual_seed(SEED + 18)
    dis = {}
    for d in "ab":
        net = discriminator.build(conf, "cpu")
        net.init(g)
        dis[d] = net.state_dict()
    torch.save(dis, root / "dis.pt")
    step = 370000
    checkpoint_tools.main(["import", "--config", str(conf_path), "--gen",
                           str(root / "gen.pt"), "--dis", str(root / "dis.pt"),
                           "--out", str(root / "ckpt"), "--step", str(step)])
    checkpoint_tools.main(["export", "--config", str(conf_path), "--ckpt",
                           str(root / "ckpt"), "--out", str(root / "out.pt")])
    checkpoint_tools.main(["pack", "--config", str(conf_path), "--ckpt",
                           str(root / "ckpt"), "--out", str(root / "gen.npz")])
    want = torch.load(root / "gen.pt", weights_only=True)["2"]
    got = torch.load(root / "out.pt", weights_only=True)["2"]
    state, at = checkpoint.restore_checkpoint(str(root / "ckpt"))
    packed = load_reference_checkpoint(str(root / "gen.npz"))
    bad_pack = [k for k, v in gen_sd.items()
                if not torch.equal(packed[k], torch.from_numpy(
                    ((bf16_bits(v.cpu().numpy()).astype(np.uint32) << 16)
                     .view(np.float32)) if v.ndim >= 2 else v.cpu().numpy()))]
    same = set(got) == set(want) and all(torch.equal(got[k], want[k])
                                         for k in want)
    dis_same = all(torch.equal(state["nets"][f"dis_{d}"][k], v)
                   for d in "ab" for k, v in dis[d].items())
    fresh = all(int(o["count"]) == 0 and not any(t.any() for t in
                                                 o["mu"].values())
                for o in state["opt"].values())
    emit(phase="eval_checkpoint_tools", seconds=time.perf_counter() - t0,
         step=at, export_bitwise=same, dis_bitwise=dis_same,
         fresh_optimizers=fresh, pack_bytes=(root / "gen.npz").stat().st_size,
         pack_not_bf16=bad_pack[:5])
    check(at == step == state["iterations"], f"imported step {at}")
    check(same and dis_same, "import → export is not bit for bit")
    check(fresh, "imported optimizers are not fresh")
    check(not bad_pack, f"packed weights not their bf16 rounding: {bad_pack}")


def eval_hd_phase(norms, get_config, net, guided_a2b, inception_preprocess,
                  pool_and_logits):
    """16(e): one config_HD translation (seeded weights, 512²) on the card
    through inception_preprocess's 512 → 299 downscale and InceptionV3,
    against the same translation's on the CPU."""
    from munit_tpu_torch.nn.generator import GenBundle
    conf = get_config(str(HD_CONFIG))
    per_image = per_image_launches(conf)
    gen = GenBundle(conf, "cuda")
    gen.init(torch.Generator().manual_seed(SEED + 19))
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    x_a, x_b = (torch.rand((1, HD_CROP, HD_CROP, 3), generator=g,
                           device="cuda") * 2 - 1 for _ in range(2))
    cpu_net = type(net)()
    cpu_net.load_state_dict(net.state_dict())
    cpu_net = cpu_net.frozen_on("cpu")
    norms.reset_launches()
    with torch.no_grad():
        fake = guided_a2b(gen, x_a, x_b)
        launches = counts_of(norms)
        pre = inception_preprocess(fake)
        pool = pool_and_logits(net, fake)[0]
        pre_cpu = inception_preprocess(fake.cpu())
        pool_cpu = pool_and_logits(cpu_net, fake.cpu())[0]
    e_pre = float((pre.cpu() - pre_cpu).abs().max() / pre_cpu.abs().max())
    e_pool = float((pool.cpu() - pool_cpu).abs().max()
                   / pool_cpu.abs().max())
    emit(phase="eval_hd", fake_shape=list(fake.shape),
         preprocessed_shape=list(pre.shape), launches=launches,
         expected=per_image, preprocess_rel_err=e_pre, pool_rel_err=e_pool,
         tol=EVAL_POOL_TOL)
    check(tuple(pre.shape) == (1, 299, 299, 3), f"HD preprocess {pre.shape}")
    check(launches == per_image, f"HD launches {launches}, want {per_image}")
    check(e_pre <= 1e-6 and e_pool <= EVAL_POOL_TOL,
          f"HD preprocess/pool card against CPU {e_pre}, {e_pool}")


def eval_phase(norms, get_config, tmp: Path):
    """Phase 16: evaluation (ROADMAP item 14) at config_256's full width:
    (a) compute_moments and evaluate fid --kid on the card over 32 seeded
    pairs, the same commands on the CPU, the real pools card against CPU,
    a set's FID against its own moments, Newton-Schulz against scipy, the
    norm launches per scored image, translate+pool ms and peak memory;
    (b) translate_batch --compute_IS --compute_CIS, card against CPU; (c)
    the train CLI with eval_fid 1 against eval_fid 0; (d) checkpoint_tools
    import → export → pack; (e) a config_HD image through the 512 → 299
    preprocessing. The CPU side and the train CLIs run in processes, and
    scipy's sqrtm in threads, beside the card's work after the timings.
    Returns the evaluate run's norm launches by design."""
    import contextlib
    import io
    from concurrent.futures import ThreadPoolExecutor
    from munit_tpu_torch.cli import compute_moments, evaluate, translate_batch
    from munit_tpu_torch.dist.mesh import Replicas
    from munit_tpu_torch.eval import fid
    from munit_tpu_torch.eval.fid import guided_a2b
    from munit_tpu_torch.eval.inception import (InceptionV3,
                                                inception_preprocess,
                                                load_inception,
                                                pool_and_logits)
    from munit_tpu_torch.data.api import get_fid_data_loader
    from munit_tpu_torch.nn.generator import GenBundle
    t0 = time.perf_counter()
    set_numerics("tf32_off")     # as a fresh evaluate process runs
    # the kernels at batch 32, the timing's
    plan_phase(norms, SHAPES, (32,), CLUSTER_SHAPE, "eval_plan")
    kernel_phase(norms, ((32, hwc, tuple(PATH_CALLS)) for hwc in SHAPES),
                 SEED + 16, "eval_kernel")
    root = tmp / "eval"
    lists = write_eval_data(root / "data")
    conf = get_config(str(CONFIG))
    per_image = per_image_launches(conf)
    gen = GenBundle(conf, "cuda")
    gen.init(torch.Generator().manual_seed(SEED))
    gen_pt = root / "gen.pt"
    torch.save({"2": gen.state_dict()}, gen_pt)
    incep = root / "inception.pth"
    torch.save(InceptionV3().init(torch.Generator().manual_seed(SEED))
               .state_dict(), incep)
    net = load_inception(str(incep), "cuda")
    moments = root / "moments.npz"

    def fid_keys(list_a, list_b):
        return {"data_list_fid_a": list_a, "data_list_fid_b": list_b,
                "inception_ckpt_path": str(incep),
                "inception_moment_path": str(moments)}
    # config_256's own batch_size_fid (1): one launch a wrapper call an image
    cfg = write_config(root / "eval.yaml", {},
                       {"num_workers": 8, **fid_keys(lists["a"], lists["b"])})
    timing = eval_time_phase(gen, net, guided_a2b, pool_and_logits)
    steps = {}

    def mark(name):
        steps[name] = time.perf_counter() - t0
    mark("timed")
    pool = ThreadPoolExecutor(3)
    ns_done = ns_phase(fid, pool)

    # (a) the card's moments; then the CPU side and the training runs
    real = compute_moments.main(["--images", lists["b"], "--inception_ckpt",
                                 str(incep), "--out", str(moments)])
    cpu_out = root / "cpu"
    cpu, train = {}, {}
    try:
        for mode in ("fid", "side"):
            cpu[mode] = subprocess.Popen(
                [sys.executable, "-c", EVAL_CPU_RUNNER, mode, str(cpu_out),
                 str(cfg), lists["b"], str(incep), str(gen_pt),
                 lists["is_in"], str(EVAL_STYLES), str(EVAL_BATCH)],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env={**os.environ, "OMP_NUM_THREADS":
                                str(EVAL_CPU_THREADS[mode])})
        train.update(eval_cli_runs(lists, fid_keys,
                                   write_train_data(root / "train"), root))
        self_fid = pool.submit(fid.compute_fid_from_pools, real["pool"],
                               real["mu"], real["sigma"], True, "cuda")
        loader = get_fid_data_loader(lists["a"], lists["b"], EVAL_BATCH,
                                     new_size=conf["new_size"])
        fakes = evaluate.fid_pools(Replicas(["cuda"]), [gen], [net],
                                   [next(iter(loader.batches()))])
        # (b) IS and CIS on the card
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            outs = translate_batch.main([
                "--config", str(cfg), "--checkpoint", str(gen_pt),
                "--input_folder", lists["is_in"], "--output_folder",
                str(root / "is_out"), "--num_style", str(EVAL_STYLES),
                "--compute_IS", "--compute_CIS", "--inception_ckpt",
                str(incep)])
        scores = parse_scores(buf.getvalue())
        mark("card_pools_and_scores")
        # (d), (e)
        eval_tools_phase(gen.state_dict(), CONFIG, root)
        eval_hd_phase(norms, get_config, net, guided_a2b, inception_preprocess,
                      pool_and_logits)
        mark("tools_and_hd")
        # (a) the card's evaluate, its launches alone
        norms.reset_launches()
        res = evaluate.main(["fid", "--config", str(cfg), "--checkpoint",
                             str(gen_pt), "--inception_ckpt", str(incep),
                             "--kid"])
        launches = counts_of(norms)
        by_design = launches_by_design(norms)
        want = {k: EVAL_PAIRS * n for k, n in per_image.items()}
        mark("card_evaluate")
        # (c) the last snapshot through evaluate, beside the CPU side
        trained = eval_cli_wait(train)
        mark("train_clis_waited")
        evaluated = pool.submit(evaluate.main, [
            "fid", "--config", str(trained["fid"]["cfg"]), "--checkpoint",
            str(trained["fid"]["run"] / "checkpoints"), "--inception_ckpt",
            str(incep)])
        done = {}
        for mode, proc in cpu.items():
            out, err = proc.communicate(timeout=900)
            check(proc.returncode == 0, f"CPU side ({mode}) exit "
                                        f"{proc.returncode}: {err[-3000:]}")
            done[mode] = json.loads(out.strip().splitlines()[-1])
        mark("cpu_side_waited")
        cpu_res = done["fid"]
        cpu_scores = parse_scores(done["side"]["printed"])
        with np.load(f"{cpu_out}.npz") as z:
            cpu_pool = z["pool"]
        with np.load(f"{cpu_out}_arrays.npz") as z:
            cpu_outs, cpu_fakes = z["outs"], z["fakes"]
        e_real = float(np.abs(real["pool"] - cpu_pool).max()
                       / np.abs(cpu_pool).max())
        e_fake = float(np.abs(fakes - cpu_fakes).max()
                       / np.abs(cpu_fakes).max())
        e_tb = float(np.abs(np.stack(outs) - cpu_outs).max())
        trace = float(np.trace(real["sigma"]))
        self_fid = self_fid.result()
        emit(phase="eval_fid", pairs=EVAL_PAIRS, card=res, cpu=cpu_res,
             fid_rel_err=rel(res["fid"], cpu_res["fid"]),
             kid_rel_err=rel(res["kid"], cpu_res["kid"]),
             real_pool_rel_err=e_real, fake_pool_rel_err=e_fake,
             fake_pool_batch=EVAL_BATCH, self_fid=self_fid, trace_sigma=trace,
             launches=launches, expected=want, launches_by_design=by_design,
             tol={"pool": EVAL_POOL_TOL, "fake_pool": EVAL_FAKE_TOL,
                  "scores": EVAL_SCORE_RTOL, "self": EVAL_SELF_TOL})
        emit(phase="eval_scores", card=scores, cpu=cpu_scores,
             images=EVAL_IS_IMAGES, styles=EVAL_STYLES,
             translate_batch_max_abs_err=e_tb)
        check(launches == want, f"evaluate launches {launches}, want {want}")
        check(e_real <= EVAL_POOL_TOL, f"real pools card against CPU {e_real}")
        check(e_fake <= EVAL_FAKE_TOL, f"fake pools card against CPU {e_fake}")
        check(e_tb <= 1e-3, f"translate_batch card against CPU {e_tb}")
        for key in ("fid", "kid"):
            check(rel(res[key], cpu_res[key]) <= EVAL_SCORE_RTOL,
                  f"{key} card {res[key]} against CPU {cpu_res[key]}")
        for key in ("IS", "CIS"):
            check(rel(scores[key], cpu_scores[key]) <= EVAL_SCORE_RTOL,
                  f"{key} card {scores[key]} against CPU {cpu_scores[key]}")
        check(abs(self_fid) <= EVAL_SELF_TOL * trace,
              f"FID of the set against its own moments {self_fid}")
        ns_ms = ns_done()
        eval_cli_check(trained, evaluated.result(), per_image)
    finally:
        # every process and thread of the phase ends with it
        for proc in [*cpu.values(), *(r[2] for r in train.values())]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        pool.shutdown(cancel_futures=True)
    emit(phase="eval_seconds", seconds=time.perf_counter() - t0,
         steps=steps, timing=timing, newton_schulz_ms=ns_ms,
         note="steps: seconds from the phase's start at which each stage "
              "of the card's thread ended")
    return by_design


def parse_scores(printed: str) -> dict:
    """IS and CIS from translate_batch's output."""
    out = {}
    for line in printed.splitlines():
        if line.startswith("Inception Score: "):
            out["IS"] = float(line.split(": ")[1])
        elif line.startswith("conditional Inception Score: "):
            out["CIS"] = float(line.split(": ")[1])
    check(set(out) == {"IS", "CIS"}, f"no scores in {printed[-500:]}")
    return out


def eval_alone() -> int:
    """``python3 chip_smoke.py --eval``: the build and phase 16 alone, for
    working on it; the kernel line and status line are the full run's."""
    from munit_tpu_torch.config import get_config
    from munit_tpu_torch.kernels import build, norms
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        eval_phase(norms, get_config, Path(tmp))
    return 0


def profiler_alone(args) -> int:
    """``python3 chip_smoke.py --profiler [N]``: how often torch.profiler
    loses device records. Each one_kernel_steps step profiled N times
    (default 25) with no idle at the window's ends and with PROFILE_PAD_S,
    twice each, interleaved; counts the profiles that lost records and
    those that show another kernel. No take is repeated."""
    from munit_tpu_torch.kernels import build, norms
    global PROFILE_PAD_S
    n = int(args[0]) if args else 25
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    build.build_all()
    parity_mode(True)
    pad = PROFILE_PAD_S
    counts = {p: {"profiles": 0, "lost": 0, "other_kernel": 0,
                  "lost_per_call": []} for p in (0.0, pad)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for p in (0.0, pad, 0.0, pad):
        PROFILE_PAD_S = p
        for *_, step, kernel in one_kernel_steps(norms, gen):
            for _ in range(n):
                rows, _ = device_profile(step, PROFILE_CALLS)
                c = counts[p]
                c["profiles"] += 1
                if records_lost(rows, kernel):
                    c["lost"] += 1
                    c["lost_per_call"].append(rows[0][2] if rows else 0)
                elif not (len(rows) == 1 and rows[0][2] == 1):
                    c["other_kernel"] += 1
    PROFILE_PAD_S = pad
    for p, c in counts.items():
        emit(phase="profiler_losses", pad_s=p, calls=PROFILE_CALLS, **c)
    return 0


# ---------------------------------------------------------------- phase 17

SERVE_MAX_BATCH = 8
SERVE_BUCKETS = (1, 2, 4, 8)
SERVE_REQUESTS = 64          # POSTs at each client count
SERVE_CLIENTS = (1, 16)
SERVE_CPU_IMAGES = 4         # translated by the CPU service as well
SERVE_TIME_REPS = 10
SERVE_INT8_ITERS = 15        # timed bf16 iterations, after the warm-up
INT8_INPUT_TOL = 0.05        # translate --quant int8 against f32, mean |d|
# norm launches of one dispatch, whatever its batch: a content encode (11
# IN) and a decode (8 AdaIN, 2 LN); the style encoder has no norm
SERVE_PER_DISPATCH = {"instance_norm": 11, "adain": 8,
                      "whole_layer_norm": 2}
# the conv sites the int8 shape rule takes at config_256: (padded input
# H, W, C), (kh, kw, cin, cout) of the res blocks' 3x3 and the first up
# stage's 5x5
INT8_SITES = {"res 3x3": ((66, 66, 256), (3, 3, 256, 256)),
              "up 5x5": ((132, 132, 256), (5, 5, 256, 128))}
INT8_OPS_PER_S = 1979e12     # H100 SXM int8 tensor cores, dense
# the CPU side: a direct (max_batch 1) service on the CPU over the same
# images, its uint8 outputs into an .npz
SERVE_CPU_RUNNER = """
import json, sys
import numpy as np, torch
from PIL import Image
from munit_tpu_torch.serve import server
out, images = sys.argv[1], sys.argv[2].split(",")
svc = server.build_service(server.parse_args(sys.argv[3:]))
np.savez(out, *[np.asarray(svc.translate(Image.open(p)))
                for p in images])
"""


def write_styles(folder: Path) -> list:
    """Two seeded 300x280 JPEG styles, smooth and noisy."""
    from PIL import Image
    rng = np.random.RandomState(SEED + 170)
    paths = []
    for i in range(2):
        low = (rng.rand(6, 6, 3) * 255).astype(np.uint8)
        img = np.asarray(Image.fromarray(low).resize((280, 300)), np.float32)
        img = np.clip(img + rng.randn(300, 280, 3) * 10, 0, 255)
        paths.append(folder / f"style{i}.jpg")
        Image.fromarray(img.astype(np.uint8)).save(paths[-1], quality=92)
    return paths


def serve_args(cfg, ckpt, styles, *extra):
    return ["--config", str(cfg), "--checkpoint", str(ckpt), "--style",
            str(styles[0]), "--style", f"wet={styles[1]}", *extra]


def start_server(tmp: Path, name, args):
    """``python -m munit_tpu_torch serve`` in a process of its own on a
    free port (through CLI_RUNNER, which writes its norm launches at
    exit): (process, counts file)."""
    counts = tmp / f"{name}_counts.json"
    proc = subprocess.Popen(
        [sys.executable, "-c", CLI_RUNNER, str(counts), "serve", *args,
         "--port", "0", "--max-batch", str(SERVE_MAX_BATCH)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, counts


def wait_ready(proc, timeout=300):
    """The port of a started server, once it answers /healthz."""
    import urllib.request
    t0 = time.perf_counter()
    line = proc.stdout.readline()
    check(line.startswith("serving on :"),
          f"server did not start: {line!r} {proc.stderr.read()[-3000:]}"
          if proc.poll() is not None else f"server said {line!r}")
    port = int(line.strip().rsplit(":", 1)[1])
    while time.perf_counter() - t0 < timeout:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                return port, json.loads(r.read())
        except OSError:
            time.sleep(0.2)
    raise RuntimeError("server did not answer /healthz")


def stop_server(proc, counts: Path) -> dict:
    """SIGINT, then the launch counts it wrote on its way out."""
    import signal
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return json.loads(counts.read_text()) if counts.exists() else {}


def http_load(port, bodies, clients):
    """SERVE_REQUESTS POSTs of ``bodies`` (JPEG bytes, in turn) from
    ``clients`` threads: each answer's status and size, the latencies, the
    wall time and /stats before and after."""
    import io
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor
    from PIL import Image
    base = f"http://127.0.0.1:{port}"

    def stats():
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            return json.loads(r.read())

    def post(i):
        req = urllib.request.Request(base + "/translate",
                                     data=bodies[i % len(bodies)],
                                     method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            data, status = r.read(), r.status
        ms = (time.perf_counter() - t0) * 1e3
        return status, Image.open(io.BytesIO(data)).size, ms

    before = stats()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        res = list(pool.map(post, range(SERVE_REQUESTS)))
    wall = time.perf_counter() - t0
    after = stats()
    ms = [r[2] for r in res]
    n = after["requests"] - before["requests"]
    b = after["batches"] - before["batches"]
    return {"clients": clients, "requests": len(res),
            "statuses": sorted({r[0] for r in res}),
            "sizes": sorted({r[1] for r in res}),
            "requests_per_s": len(res) / wall,
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "mean_batch": n / max(b, 1), "batches": b,
            "batch_hist": {k: after["batch_hist"].get(k, 0)
                           - before["batch_hist"].get(k, 0)
                           for k in after["batch_hist"]}}


def bucket_inputs(svc, paths, b):
    """The first b request images, prepped, and the default style, on the
    card: a bucket's batch."""
    from PIL import Image
    x = np.concatenate([svc._prep(Image.open(p))
                        for p in (paths * b)[:b]])
    s = np.repeat(svc.styles["default"], b, axis=0)
    return (torch.from_numpy(x).to(svc.device),
            torch.from_numpy(s).to(svc.device))


def serve_graph_phase(norms, svc, paths):
    """17(a): each bucket's replay against its eager call, bit for bit; the
    norm launches of one replay by design; ms per dispatch, captured
    (copy in, replay, copy out) and eager, median of SERVE_TIME_REPS."""
    out = {}
    with svc._on_device():
        for b in SERVE_BUCKETS:
            x, s = bucket_inputs(svc, paths, b)
            key = svc.graph_key(x, s)
            check(key in svc.graphs._steps, f"bucket {b} not captured")
            eager = svc._translate(x, s).clone()
            norms.reset_launches()
            replay = svc.dispatch(x, s)
            torch.cuda.synchronize()
            launches = counts_of(norms)
            by_design = launches_by_design(norms)
            diff = float((replay - eager).abs().max())
            cap_ms, _ = host_ms(lambda: svc.dispatch(x, s), SERVE_TIME_REPS)
            eager_ms, _ = host_ms(lambda: svc._translate(x, s),
                                  SERVE_TIME_REPS)
            out[b] = {"bitwise": bool(torch.equal(replay, eager)),
                      "max_abs_diff": diff, "launches": launches,
                      "launches_by_design": by_design,
                      "captured_ms": cap_ms, "eager_ms": eager_ms,
                      "captured_ms_per_image": cap_ms / b,
                      "eager_ms_per_image": eager_ms / b}
    return out


def serve_translate_many(svc, paths, n):
    """n requests (the images in turn, styles alternating) from n threads
    at once through the service: its outputs as uint8 arrays."""
    from concurrent.futures import ThreadPoolExecutor
    from PIL import Image
    imgs = [Image.open(p) for p in paths]
    with ThreadPoolExecutor(n) as pool:
        return [np.asarray(o, np.int16) for o in pool.map(
            lambda i: svc.translate(imgs[i % len(imgs)],
                                    ("default", "wet")[i % 2]), range(n))]


def int8_product_phase(ops):
    """17(c): at each int8 site of config_256 at batch 8, the int32 sums of
    seeded int8 operands on the card against the CPU, bit for bit; the
    whole int8 conv (quantize, gather, torch._int_mm, scale back) on the
    card against the CPU on one float input; ms of the sums alone and of
    the whole int8 conv, against F.conv2d in float32 (TF32 off) of the same
    conv, after an L2 flush; the bound of the int8 product."""
    flush = torch.empty(100 * 2**20 // 4, device="cuda")
    g = torch.Generator().manual_seed(SEED + 171)
    rows = {}
    b = SERVE_MAX_BATCH
    for name, ((h, w, c), (kh, kw, cin, cout)) in INT8_SITES.items():
        xq = torch.randint(-127, 128, (b, h, w, c), generator=g,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (cout, cin, kh, kw), generator=g,
                           dtype=torch.int8)
        want = ops.int8_conv_sums(xq, wq)
        got = ops.int8_conv_sums(xq.cuda(), wq.cuda())
        x = torch.randn((b, h, w, c), generator=g)
        wf = torch.randn((cout, cin, kh, kw), generator=g) * 0.02
        with ops.conv_quant(all_convs=True):
            y_cpu = ops.conv2d(x, wf)
            xc, wc = x.cuda(), wf.cuda()
            y_card = ops.conv2d(xc, wc)
            full_ms = time_ms(lambda: ops.conv2d(xc, wc), flush, 10)
        xqc, wqc = xq.cuda(), wq.cuda()
        sums_ms = time_ms(lambda: ops.int8_conv_sums(xqc, wqc), flush, 10)
        f32_ms = time_ms(lambda: ops.conv2d(xc, wc), flush, 10)
        ho, wo = h - kh + 1, w - kw + 1
        macs = b * ho * wo * kh * kw * cin * cout
        nbytes = xq.numel() + wq.numel() + 4 * b * ho * wo * cout
        t_ops = 2 * macs / INT8_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rows[name] = {
            "shape": [b, h, w, c], "kernel": [kh, kw, cin, cout],
            "sums_bitwise": bool(torch.equal(got.cpu(), want)),
            "conv_max_abs_err": float((y_card.cpu() - y_cpu).abs().max()),
            "sums_ms": sums_ms, "int8_conv_ms": full_ms,
            "f32_conv_ms": f32_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        check(rows[name]["sums_bitwise"],
              f"int8 sums of the {name} conv differ card against CPU")
    return rows


def int8_dis_phase(MUNITTrainer, train_steps, get_config):
    """17(c): config_256 at batch 1 in bf16, captured, with MUNIT_INT8_DIS
    off and on: capture_warmup iterations, then SERVE_INT8_ITERS timed (one
    cycle of the cadence: 15 dis steps, 3 fused, 1 classifier_sr); the
    losses finite, the dis steps replayed; ms an iteration (the cycle's
    mean, and the median iteration) and a dis step (median of 10)."""
    from munit_tpu_torch.train.trainer import capture_warmup
    conf = get_config(str(CONFIG))
    warm = capture_warmup(conf)
    out = {}
    for on in ("0", "1"):
        set_numerics("bf16")
        os.environ["MUNIT_INT8_DIS"] = on
        try:
            tr = new_trainer(MUNITTrainer, conf, "cuda")
        finally:
            del os.environ["MUNIT_INT8_DIS"]
        batch = numerics_inputs(train_inputs(1, SEED + 172), "bf16")
        train_steps(tr, *batch, range(warm))
        torch.cuda.synchronize()
        ms, metrics = [], []
        for it in range(warm, warm + SERVE_INT8_ITERS):
            t0 = time.perf_counter()
            metrics += train_steps(tr, *batch, [it])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        finite = all(np.isfinite(float(v)) for m in metrics
                     for v in m.values())
        dis_replays = sum(n for k, n in tr._graphs.replays.items()
                          if k[0] == "dis")
        dis_ms, _ = host_ms(lambda: tr.dis_update(*batch[:2]), 10)
        out[f"int8_dis {on}"] = {
            "int8_dis_fakes": tr.int8_dis_fakes, "finite": finite,
            "ms_per_iteration": float(np.mean(ms)),
            "iteration_ms_median": float(np.median(ms)),
            "dis_step_ms": dis_ms, "dis_replays": dis_replays,
            "loss_dis_total_last": float(metrics[-1]["loss_dis_total"])}
        check(tr.int8_dis_fakes == (on == "1"), "MUNIT_INT8_DIS not read")
        check(finite, f"MUNIT_INT8_DIS={on}: a loss is not finite")
        check(dis_replays > 0, f"MUNIT_INT8_DIS={on}: no dis step replayed")
        del tr
        torch.cuda.empty_cache()
    set_numerics("tf32_off")
    return out


def serve_phase(norms, get_config, data, tmp: Path):
    """17: serving config_256 at full width on the card (seeded generator,
    two seeded JPEG styles, phase 12's JPEGs as requests)."""
    from munit_tpu_torch.cli import translate
    from munit_tpu_torch.cli.translate import load_generator
    from munit_tpu_torch.core import ops
    from munit_tpu_torch.nn.generator import GenBundle
    from munit_tpu_torch.serve.server import TranslationService
    from munit_tpu_torch.train.trainer import MUNITTrainer, train_steps
    from PIL import Image
    t0 = time.perf_counter()
    root = tmp / "serve"
    root.mkdir()
    conf = get_config(str(CONFIG))
    gen = GenBundle(conf, "cpu")
    gen.init(torch.Generator().manual_seed(SEED + 170))
    ckpt = root / "gen.pt"
    torch.save({"2": gen.state_dict()}, ckpt)
    styles = write_styles(root)
    paths = Path(data["data_list_train_a"]).read_text().split()
    bodies = [Path(p).read_bytes() for p in paths]
    steps = {}

    def mark(name):
        steps[name] = time.perf_counter() - t0

    servers = {name: start_server(root, name, serve_args(CONFIG, ckpt,
                                                         styles, *extra))
               for name, extra in (("f32", ()),
                                   ("int8", ("--quant", "int8")))}
    cpu_out = root / "cpu.npz"
    cpu = subprocess.Popen(
        [sys.executable, "-c", SERVE_CPU_RUNNER, str(cpu_out),
         ",".join(paths[:SERVE_CPU_IMAGES]),
         *serve_args(CONFIG, ckpt, styles, "--device", "cpu",
                     "--max-batch", "1")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "4"})
    try:
        # (a) the in-process service: graphs against eager, batched against
        # direct, launches of the path
        ops.set_conv_compute(None)
        parity_mode(True)
        g = load_generator(str(ckpt), conf, "cuda")
        svc = TranslationService(conf, g, max_batch=SERVE_MAX_BATCH,
                                 mesh="off")
        direct = TranslationService(conf, g, max_batch=1, mesh="off")
        for s in (svc, direct):
            s.add_style("default", Image.open(
                styles[0]))
            s.add_style("wet", Image.open(styles[1]))
            s.warmup()
        mark("warmed")
        norms.reset_launches()
        batched = serve_translate_many(svc, paths, 16)
        launches = counts_of(norms)
        path_by_design = launches_by_design(norms)
        st = svc.batcher.stats_snapshot()
        want = {k: n * st["batches"] for k, n in SERVE_PER_DISPATCH.items()}
        want_design = designs_of_calls(
            norms, {**want, **{k + "_bwd": 0 for k in want}},
            PATH_DESIGN_SHARE)
        singles = [np.asarray(direct.translate(
            Image.open(paths[i % len(paths)]),
            ("default", "wet")[i % 2]), np.int16) for i in range(16)]
        step_err = max(int(np.abs(a - b).max())
                       for a, b in zip(batched, singles))
        graphs_res = serve_graph_phase(norms, svc, paths)
        mark("graphs")
        emit(phase="serve_graphs", buckets=graphs_res,
             graphs=len(svc.graphs), replays=sum(svc.graphs.replays.values()),
             note="per bucket: its replay against an eager call of the same "
                  "batch; launches of one replay; ms per dispatch (captured: "
                  "copy in, replay, copy out; eager: the model alone), "
                  "median of 10")
        emit(phase="serve_path", requests=16, batches=st["batches"],
             batch_hist=st["batch_hist"], launches=launches, expected=want,
             launches_by_design=path_by_design,
             expected_by_design=want_design,
             batched_vs_direct_max_uint8_step=step_err)
        for b, r in graphs_res.items():
            check(r["bitwise"], f"bucket {b}: replay against eager "
                                f"{r['max_abs_diff']}")
            check(r["launches"] == SERVE_PER_DISPATCH,
                  f"bucket {b} launches {r['launches']}")
        check(launches == want, f"serve launches {launches}, want {want}")
        check(path_by_design == want_design,
              f"serve launches by design {path_by_design}, "
              f"want {want_design}")
        check(step_err <= 1, f"batched against direct: {step_err} steps")
        # (b) HTTP against the f32 process, then int8's
        loads = {}
        port, health = wait_ready(servers["f32"][0])
        mark("f32_server_ready")
        for clients in SERVE_CLIENTS:
            loads[clients] = http_load(port, bodies, clients)
        mark("http_load")
        port8, health8 = wait_ready(servers["int8"][0])
        int8_load = http_load(port8, bodies, 4)
        mark("int8_http")
        counts = {name: stop_server(*pr) for name, pr in servers.items()}
        emit(phase="serve_http", health=health, loads=loads,
             int8=int8_load, launches={k: c.get("launches")
                                       for k, c in counts.items()},
             note="64 POSTs of phase 12's 286x286 JPEGs at each client "
                  "count; requests/s over the wall time; p50/p99 of each "
                  "request's latency; mean batch from /stats")
        for r in (*loads.values(), int8_load):
            check(r["statuses"] == [200] and r["sizes"] == [(256, 256)],
                  f"HTTP answers {r['statuses']} {r['sizes']}")
        check(loads[16]["mean_batch"] > 1,
              f"mean batch under 16 clients {loads[16]['mean_batch']}")
        for name, c in counts.items():
            n = loads[1]["batches"] + loads[16]["batches"] \
                if name == "f32" else int8_load["batches"]
            # warm-up: each bucket eager and captured; int8 also calibrates
            n += 2 * len(SERVE_BUCKETS) + (name == "int8")
            want_p = {k: v * n for k, v in SERVE_PER_DISPATCH.items()}
            got_p = {k: v for k, v in c.get("launches", {}).items() if v}
            check(got_p == want_p, f"{name} server launches {got_p}, "
                                   f"want {want_p}")
        # (c) int8
        product = int8_product_phase(ops)
        emit(phase="int8_product", sites=product,
             note="batch 8; sums: gather + torch._int_mm; int8 conv: "
                  "quantize, gather, _int_mm, scale back; f32: F.conv2d, "
                  "TF32 off; bound of the int8 product: int8 operations at "
                  "1979 TOP/s or its bytes at 3.35 TB/s")
        q8 = TranslationService(conf, g, max_batch=SERVE_MAX_BATCH,
                                quant="int8", mesh="off")
        q8.add_style("default", Image.open(styles[0]))
        q8.warmup()
        with q8._on_device():
            x, s = bucket_inputs(q8, paths, SERVE_MAX_BATCH)
            ms = {"int8_captured": host_ms(lambda: q8.dispatch(x, s),
                                           SERVE_TIME_REPS)[0],
                  "int8_eager": host_ms(lambda: q8._translate(x, s),
                                        SERVE_TIME_REPS)[0]}
        with svc._on_device():
            ms.update({"f32_captured": host_ms(lambda: svc.dispatch(x, s),
                                               SERVE_TIME_REPS)[0],
                       "f32_eager": host_ms(lambda: svc._translate(x, s),
                                            SERVE_TIME_REPS)[0]})
        cli = tmp / "serve_cli"
        cli.mkdir()
        for i, p in enumerate(paths[:4]):
            shutil.copy(p, cli / f"input{i}.jpg")
        args = ["--config", str(CONFIG), "--checkpoint", str(ckpt),
                "--input", str(cli), "--style", str(styles[0])]
        f32_out = translate.main(args + ["--output_folder",
                                         str(root / "t32")])
        int8_out = translate.main(args + ["--output_folder",
                                          str(root / "t8"),
                                          "--quant", "int8"])
        d8 = [float(np.abs(a - b).mean()) for a, b in zip(int8_out, f32_out)]
        emit(phase="serve_int8", ms_per_image={k: v / SERVE_MAX_BATCH
                                               for k, v in ms.items()},
             batch=SERVE_MAX_BATCH, sites=len(q8._scales),
             translate_int8_vs_f32_mean_abs=d8, tol=INT8_INPUT_TOL)
        check(max(d8) < INT8_INPUT_TOL, f"int8 translation off f32 by {d8}")
        mark("int8")
        dis = int8_dis_phase(MUNITTrainer, train_steps, get_config)
        emit(phase="serve_int8_dis", runs=dis)
        mark("int8_dis")
        # the CPU service, beside the card's work
        _, err = cpu.communicate(timeout=600)
        check(cpu.returncode == 0, f"CPU service exit {cpu.returncode}: "
                                   f"{err[-3000:]}")
        with np.load(cpu_out) as z:
            cpu_imgs = [z[f"arr_{i}"].astype(np.int16)
                        for i in range(SERVE_CPU_IMAGES)]
        card = [np.asarray(direct.translate(Image.open(
            p)), np.int16) for p in paths[:SERVE_CPU_IMAGES]]
        cpu_err = max(int(np.abs(a - b).max()) for a, b in zip(card, cpu_imgs))
        emit(phase="serve_cpu_vs_card", images=SERVE_CPU_IMAGES,
             max_uint8_step=cpu_err)
        check(cpu_err <= 1, f"serve card against CPU: {cpu_err} steps")
        svc.batcher.close()
        q8.batcher.close()
    finally:
        for proc in [cpu] + [pr[0] for pr in servers.values()]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    mark("cpu_waited")
    emit(phase="serve_seconds", seconds=time.perf_counter() - t0,
         steps=steps)
    return path_by_design


def serve_alone() -> int:
    """``python3 chip_smoke.py --serve``: the build and phase 17 alone."""
    from munit_tpu_torch.config import get_config
    from munit_tpu_torch.kernels import build, norms
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        data = write_train_data(Path(tmp) / "data")
        serve_phase(norms, get_config, data, Path(tmp))
    return 0


# ---------------------------------------------------------------- phase 18

# the three artifacts of phase 18: export-aot's arguments beyond the
# weights (int8's calibration folder and style are filled in)
AOT_KINDS = {"f32": ("--dtype", "f32"), "bf16": ("--dtype", "bf16"),
             "int8": ("--dtype", "f32", "--quant", "int8")}
AOT_BATCHES = (1, 8)
AOT_F32_TOL = 1e-5           # f32, TF32 off: the artifact against eager
UNIT_CPU_IMAGES = 2          # translated by the CPU as well
# UNIT's norm calls an image at config_256: a content encode (11 IN: 9 at
# 64², on the cluster design, 2 grid) and a decode (8 IN in its res blocks
# at 64², 2 LN)
UNIT_PER_IMAGE = {"instance_norm": {"cluster": 17, "grid": 2},
                  "whole_layer_norm": {"grid": 2}}
# a fresh process: load one artifact on the card, translate phase 4's
# images at each batch (the norm launches of each dispatch counted), its
# outputs into an .npz, and which of the port's modules it imported
AOT_RUNNER = """
import json, sys
import numpy as np, torch
from munit_tpu_torch.io import aot
from munit_tpu_torch.kernels import norms
art = aot.load_artifact(sys.argv[1], "cuda")
z = np.load(sys.argv[2])
s = art.encode_style(z["style"])
out, counts = {"s": s.cpu().numpy()}, {}
for b in [int(v) for v in sys.argv[4].split(",")]:
    norms.reset_launches()
    y = art.translate(z["x"][:b], s)
    torch.cuda.synchronize()
    counts[b] = {"launches": {k: norms.launches[k] for k in norms.NAMES},
                 "by_design": {k: dict(norms.design_launches[k])
                               for k in norms.NAMES}}
    out[f"y{b}"] = y.cpu().numpy()
np.savez(sys.argv[3], **out)
print(json.dumps({"modules": sorted(m for m in sys.modules
                                    if m.startswith("munit_tpu_torch")),
                  "counts": counts}))
"""
AOT_BANNED = ("munit_tpu_torch.nn", "munit_tpu_torch.config",
              "munit_tpu_torch.cli", "munit_tpu_torch.train")
# the CPU side of UNIT: translate_batch --trainer UNIT on the CPU, its
# returned translations into an .npz
UNIT_CPU_RUNNER = """
import sys
import numpy as np
from munit_tpu_torch.cli import translate_batch
np.savez(sys.argv[1], *translate_batch.main(sys.argv[2:]))
"""


def vae_state(seed):
    """Seeded weights of UNIT's VAEGen at config_256's widths, in the
    reference layout: kaiming-scaled conv weights, small biases, U[0,1)
    LayerNorm gammas."""
    from munit_tpu_torch.nn.generator import VAEGen
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in VAEGen(3, 64, 2, 4).state_dict().items():
        if k.endswith("norm.gamma"):
            out[k] = torch.rand(v.shape, generator=g)
        elif k.endswith("weight"):
            fan_in = int(np.prod(v.shape[1:]))
            out[k] = torch.randn(v.shape, generator=g) * (2.0 / fan_in) ** 0.5
        else:
            out[k] = torch.randn(v.shape, generator=g) * 0.1
    return out


def to_u8(y):
    """A translation in [-1, 1] → uint8 as the CLIs save it (min-max
    normalized, rounded), as int16 for differences."""
    a = (y + 1.0) / 2.0
    a = (a - a.min()) / max(a.max() - a.min(), 1e-5)
    return (a * 255).round().astype(np.int16)


def aot_exports(out: dict, root: Path, ckpt: Path, calib: Path,
                style: Path):
    """18(a): export-aot of config_256 on the card, f32, bf16 and int8 (its
    calibration phase 4's images and style); each artifact's fresh process
    started as soon as it is written. Fills ``out``: {kind: (path,
    seconds, programs, (process, output))}."""
    from munit_tpu_torch.cli import checkpoint_tools
    batches = ",".join(str(b) for b in AOT_BATCHES)
    for kind, extra in AOT_KINDS.items():
        if kind == "int8":
            extra += ("--calib-dir", str(calib), "--calib-style", str(style))
        path = root / f"{kind}.pt2.zip"
        t0 = time.perf_counter()
        programs = checkpoint_tools.main(
            ["export-aot", "--config", str(CONFIG), "--ckpt", str(ckpt),
             "--out", str(path), *extra])
        seconds = time.perf_counter() - t0
        res = root / f"{kind}_fresh.npz"
        proc = subprocess.Popen(
            [sys.executable, "-c", AOT_RUNNER, str(path),
             str(root / "inputs.npz"), str(res), batches],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        out[kind] = (path, seconds, programs["cuda"], (proc, res))


def aot_eager(gen, x, style, kind, scales):
    """The eager translation of ``kind``'s numerics on the card, at each
    AOT_BATCHES: {batch: output}, the style code."""
    from munit_tpu_torch.core import ops
    ops.set_conv_compute(torch.bfloat16 if kind == "bf16" else None)
    try:
        ys = {}
        with torch.no_grad():
            s = gen.encode_style(style, 2)
            for b in AOT_BATCHES:   # the static scales count sites a call
                with ops.conv_quant(scales is not None, scales=scales):
                    ys[b] = gen.decode(gen.encode_content(x[:b], 1),
                                       s.expand(b, -1), 2).cpu().numpy()
    finally:
        ops.set_conv_compute(None)
    return ys, s.cpu().numpy()


def aot_fresh_check(norms, kind, started, want, programs):
    """18(b, c): a fresh process's outputs against eager, its imports, and
    the launches of each dispatch against the traced graph's nodes."""
    from munit_tpu_torch.io import aot
    (proc, res) = started
    stdout, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"{kind} artifact in a fresh process: "
                                f"{err[-3000:]}")
    got = json.loads(stdout.strip().splitlines()[-1])
    bad = [m for m in got["modules"] for p in AOT_BANNED
           if m == p or m.startswith(p + ".")]
    ops_count = aot.graph_ops(programs["translate"])
    graph = {k.split(".")[1]: n for k, n in ops_count.items()
             if k.startswith("munit_tpu_torch.")}
    ys, s = want
    with np.load(res) as z:
        diffs = {b: float(np.abs(z[f"y{b}"] - ys[b]).max())
                 for b in AOT_BATCHES}
        bitwise = {b: bool(np.array_equal(z[f"y{b}"], ys[b]))
                   for b in AOT_BATCHES}
        style_bitwise = bool(np.array_equal(z["s"], s))
        finite = all(np.isfinite(z[f"y{b}"]).all() for b in AOT_BATCHES)
    counts = {int(b): c for b, c in got["counts"].items()}
    row = {"max_abs_diff": diffs, "bitwise": bitwise,
           "style_bitwise": style_bitwise, "finite": finite,
           "banned_modules": bad, "modules": got["modules"],
           "launches": {b: c["launches"] for b, c in counts.items()},
           "graph_nodes": graph,
           "graph_int8_products": ops_count.get("aten._int_mm.default", 0),
           "graph_convs": ops_count.get("aten.conv2d.default", 0)}
    check(not bad, f"{kind} artifact imported {bad}")
    check(finite, f"{kind} artifact: outputs not finite")
    for b, c in counts.items():
        check(c["launches"] == SERVE_PER_DISPATCH,
              f"{kind} artifact, batch {b}: launches {c['launches']}")
    check(graph == SERVE_PER_DISPATCH, f"{kind} graph nodes {graph}")
    if kind == "f32":
        check(max(diffs.values()) <= AOT_F32_TOL,
              f"f32 artifact against eager: {diffs}")
    else:
        check(all(bitwise.values()) and style_bitwise,
              f"{kind} artifact against eager: {diffs}")
    check((row["graph_int8_products"] > 0) == (kind == "int8"),
          f"{kind}: {row['graph_int8_products']} int8 products in the graph")
    return row, counts


def aot_serve_phase(norms, conf, gen, path, style, paths):
    """18(d): serve --artifact (f32) for buckets 1-8 beside the
    config-built service on the same weights: each bucket's replay against
    its eager call bit for bit, the launches of one replay, the artifact's
    replay against the config-built one, ms a dispatch captured and eager
    (median of SERVE_TIME_REPS) of both."""
    from munit_tpu_torch.serve.server import TranslationService
    from PIL import Image
    art = TranslationService(artifact=str(path), device="cuda",
                             max_batch=SERVE_MAX_BATCH, mesh="off")
    ref = TranslationService(conf, gen, max_batch=SERVE_MAX_BATCH,
                             mesh="off")
    for svc in (art, ref):
        svc.add_style("default", Image.open(style))
        svc.warmup()
    out = {}
    try:
        for b in SERVE_BUCKETS:
            row = {}
            for name, svc in (("artifact", art), ("config", ref)):
                with svc._on_device():
                    x, s = bucket_inputs(svc, paths, b)
                    check(svc.graph_key(x, s) in svc.graphs._steps,
                          f"{name} bucket {b} not captured")
                    eager = svc._translate(x, s).clone()
                    norms.reset_launches()
                    replay = svc.dispatch(x, s)
                    torch.cuda.synchronize()
                    row[name] = {
                        "bitwise": bool(torch.equal(replay, eager)),
                        "launches": counts_of(norms),
                        "captured_ms": host_ms(lambda: svc.dispatch(x, s),
                                               SERVE_TIME_REPS)[0],
                        "eager_ms": host_ms(lambda: svc._translate(x, s),
                                            SERVE_TIME_REPS)[0],
                        "out": replay.cpu()}
            a, c = row["artifact"].pop("out"), row["config"].pop("out")
            row["artifact_vs_config_max_abs_diff"] = float(
                (a - c).abs().max())
            out[b] = row
            for name in ("artifact", "config"):
                check(row[name]["bitwise"],
                      f"{name} bucket {b}: replay against eager")
                check(row[name]["launches"] == SERVE_PER_DISPATCH,
                      f"{name} bucket {b} launches {row[name]['launches']}")
            check(row["artifact_vs_config_max_abs_diff"] <= AOT_F32_TOL,
                  f"bucket {b}: artifact against config service "
                  f"{row['artifact_vs_config_max_abs_diff']}")
    finally:
        art.batcher.close()
        ref.batcher.close()
    return out


def unit_phase(norms, root: Path, cpu_started):
    """18(e): translate_batch --trainer UNIT on config_256 at full width
    (seeded VAE weights, slots a and b) over phase 12's 16 JPEGs on the
    card: its launches by design, ms an image (the command, and the model
    alone at batch 1); the card's translations of the first
    UNIT_CPU_IMAGES against the CPU's (started beside the card's work),
    within 1 uint8 step."""
    from munit_tpu_torch.cli import translate_batch
    from munit_tpu_torch.cli.translate import load_image
    from munit_tpu_torch.config import get_config
    proc, cpu_out, args, folder = cpu_started
    norms.reset_launches()
    t0 = time.perf_counter()
    outs = translate_batch.main(args + ["--input_folder", str(folder),
                                        "--output_folder",
                                        str(root / "unit_card")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts_of(norms)
    by_design = {k: {d: n for d, n in v.items() if n}
                 for k, v in launches_by_design(norms).items()
                 if any(v.values())}
    n = len(outs)
    want = {k: {d: c * n for d, c in v.items()}
            for k, v in UNIT_PER_IMAGE.items()}
    opts = translate_batch.parse_args(args + ["--input_folder", str(folder),
                                              "--output_folder", "-"])
    tr = translate_batch.unit_translator(opts, get_config(str(CONFIG)),
                                         torch.device("cuda"))
    x = load_image(str(sorted(folder.iterdir())[0]), 256, "cuda")
    with torch.inference_mode():
        model_ms, _ = host_ms(lambda: tr(x, None), SERVE_TIME_REPS)
    stdout, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"UNIT on the CPU: {err[-3000:]}")
    with np.load(cpu_out) as z:
        cpu = [z[f"arr_{i}"] for i in range(UNIT_CPU_IMAGES)]
    steps = max(int(np.abs(to_u8(a[0]) - to_u8(b[0])).max())
                for a, b in zip(outs, cpu))
    finite = all(np.isfinite(o).all() for o in outs)
    row = {"images": n, "seconds": wall, "ms_per_image": wall * 1e3 / n,
           "model_ms_per_image": model_ms, "launches": launches,
           "launches_by_design": by_design, "expected_by_design": want,
           "card_vs_cpu_max_uint8_step": steps,
           "card_vs_cpu_max_abs_diff": max(float(np.abs(a - b).max())
                                           for a, b in zip(outs, cpu)),
           "finite": finite, "shapes": sorted({tuple(o.shape) for o in outs})}
    check(finite and row["shapes"] == [(1, 256, 256, 3)],
          f"UNIT outputs {row['shapes']}")
    check(by_design == want, f"UNIT launches by design {by_design}, "
                             f"want {want}")
    check(steps <= 1, f"UNIT card against CPU: {steps} uint8 steps")
    return row, by_design


def aot_phase(norms, get_config, data, tmp: Path):
    """18: the deployment artifact and UNIT at config_256's full width
    (phase 4's seeded generator and images; seeded VAE weights)."""
    from munit_tpu_torch.cli.translate import load_generator, load_image
    from munit_tpu_torch.nn.generator import GenBundle
    t0 = time.perf_counter()
    steps = {}

    def mark(name):
        steps[name] = time.perf_counter() - t0

    root = tmp / "aot"
    root.mkdir()
    conf = get_config(str(CONFIG))
    gen_cpu = GenBundle(conf, "cpu")
    gen_cpu.init(torch.Generator().manual_seed(SEED))
    ckpt = root / "gen.pt"
    torch.save({"2": gen_cpu.state_dict()}, ckpt)
    write_images(root, np.random.RandomState(SEED))
    inputs = sorted((root / "input").iterdir())
    x = torch.cat([load_image(str(p), 256, "cpu") for p in inputs])
    x = x.repeat(-(-max(AOT_BATCHES) // len(inputs)), 1, 1, 1)
    style = load_image(str(root / "style.png"), 256, "cpu")
    np.savez(root / "inputs.npz", x=x.numpy(), style=style.numpy())
    # UNIT's CPU side first, beside everything on the card
    torch.save({"a": vae_state(SEED + 180), "b": vae_state(SEED + 181)},
               root / "unit.pt")
    paths = Path(data["data_list_train_a"]).read_text().split()
    unit_in, few = root / "unit_in", root / "unit_in_cpu"
    for folder, chosen in ((unit_in, sorted(paths)),
                           (few, sorted(paths)[:UNIT_CPU_IMAGES])):
        folder.mkdir()
        for p in chosen:
            shutil.copy(p, folder / Path(p).name)
    unit_args = ["--config", str(CONFIG), "--checkpoint",
                 str(root / "unit.pt"), "--trainer", "UNIT"]
    unit_cpu = root / "unit_cpu.npz"
    cpu = subprocess.Popen(
        [sys.executable, "-c", UNIT_CPU_RUNNER, str(unit_cpu), *unit_args,
         "--input_folder", str(few), "--output_folder",
         str(root / "unit_cpu"), "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "4"})
    exports = {}
    try:
        parity_mode(True)
        aot_exports(exports, root, ckpt, root / "input", root / "style.png")
        mark("exported")
        gen = load_generator(str(ckpt), conf, "cuda")
        xc, sc = x.cuda(), style.cuda()
        fresh = {}
        for kind, (path, seconds, programs, started) in exports.items():
            with zipfile.ZipFile(path) as z:
                meta = json.loads(z.read("meta.json"))
            want = aot_eager(gen, xc, sc, kind, meta["quant_scales"])
            row, counts = aot_fresh_check(norms, kind, started, want,
                                          programs)
            fresh[kind] = (counts, row)
            emit(phase="aot_artifact", kind=kind, export_seconds=seconds,
                 megabytes=path.stat().st_size / 1e6,
                 conv_dtype=meta["conv_dtype"], quant=meta["quant"],
                 int8_sites=len(meta["quant_scales"] or ()),
                 batches=list(AOT_BATCHES), per_dispatch=SERVE_PER_DISPATCH,
                 **row, note="the artifact in a fresh process against the "
                             "eager translation of the same numerics on "
                             "the card (TF32 off); launches per dispatch "
                             "beside the traced graph's operator nodes")
        mark("fresh")
        served = aot_serve_phase(norms, conf, gen, exports["f32"][0],
                                 root / "style.png", paths)
        emit(phase="aot_serve", buckets=served,
             note="serve --artifact (f32) beside the config-built service "
                  "on the same weights: each bucket's replay against its "
                  "eager call, launches of one replay, ms a dispatch "
                  "(captured: copy in, replay, copy out; eager: the model "
                  "alone), median of 10")
        mark("served")
        unit, unit_by_design = unit_phase(
            norms, root, (cpu, unit_cpu, unit_args, unit_in))
        emit(phase="aot_unit", **unit,
             note="translate_batch --trainer UNIT over phase 12's 16 JPEGs "
                  "on the card (ms an image: the command; the model alone "
                  "at batch 1, median of 10); the first 2 against the CPU")
        mark("unit")
    finally:
        for proc in [cpu] + [e[3][0] for e in exports.values()]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    # the artifact's launches: its dispatches in the fresh processes
    aot_by_design = {}
    for counts, _ in fresh.values():
        for c in counts.values():
            for k, v in c["by_design"].items():
                for d, n in v.items():
                    aot_by_design.setdefault(k, Counter())[d] += n
    emit(phase="aot_seconds", seconds=time.perf_counter() - t0, steps=steps)
    return ({k: dict(v) for k, v in aot_by_design.items()}, unit_by_design)


def aot_alone() -> int:
    """``python3 chip_smoke.py --aot``: the build and phase 18 alone."""
    from munit_tpu_torch.config import get_config
    from munit_tpu_torch.kernels import build, norms
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        data = write_train_data(Path(tmp) / "data")
        aot_phase(norms, get_config, data, Path(tmp))
    return 0


# ---------------------------------------------------------------- phase 19

DIST_BATCH = 8          # 19(a) and the global batch of 19(b)
DIST_WORLD = 2          # 19(b): gloo ranks on the one card
DIST_LOCKSTEP = 15      # 19(a): iterations in lockstep, as 8c
DIST_WARM = 45          # 19(a): iterations before the timed windows
DIST_TIMED = 15         # 19(a): iterations a timed window
# 19(a): iterations profiled after the timed windows, each a replay: a
# dis step, a fused step, a fused and a classifier_sr step
DIST_PROFILED = {"dis": 75, "fused": 79, "fused+classifier_sr": 89}
DIST_B_STEPS = ("dis", "dis_gen", "classifier_sr")
# 19(c): the CLI's outputs, checkpoints and resume under --dist on
# config_256 as it is (full width, semantic_w 3, batch 1)
DIST_CLI_KEYS = {"snapshot_save_iter": 2, "image_save_iter": 2,
                 "image_display_iter": 1000, "log_iter": 1,
                 "display_size": 2, "num_workers": 4}
DIST_CLI_SPLIT, DIST_CLI_ITERS = 4, 6
DIST_STYLES = 10        # 19(d): translate_batch's styles, 5 a replica
UPDATE_SHARE_MAX = 0.01  # 19(b): weights past 1e-2 lr, per updated net
# 19(a) in bf16 at batch 8: the losses a fused step takes after D's update
# part between two plain trainers by up to ~1.6e-4 on an H100 (the reflect
# pad's backward atomics through bf16 rounding), so 8c's
# 1e-4 is held in 8c's own numerics (f32, TF32 off, batch 1) and the bf16
# leg's post-update losses to ten times it; its pre-update losses stay bit
# for bit and its state within twice the plain pair's difference
DIST_BF16_POST_RTOL = 1e-3
# `python -m chip_smoke`-free runner of a phase-19 function in a process of
# its own: dist_<mode>(*args) → JSON into the file named first
DIST_RUNNER = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke as c
out, mode, args = sys.argv[1], sys.argv[2], sys.argv[3:]
res = getattr(c, "dist_" + mode)(*args)
with open(out, "w") as f:
    json.dump(res, f)
"""


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_dist(mode, out: Path, *args, env=None):
    return subprocess.Popen(
        [sys.executable, "-c", DIST_RUNNER, str(out), mode, *map(str, args)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)


def wait_dist(proc, out: Path, label, timeout=600):
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    check(proc.returncode == 0,
          f"{label}: exit {proc.returncode}: {stderr[-3000:]}")
    return json.loads(out.read_text()), stdout


class outside_group:
    """No data-parallel group for the block: the plain trainers of 19(a)
    run in the process that holds the world-1 group."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self.saved, self.mesh._group = self.mesh._group, None

    def __exit__(self, *exc):
        self.mesh._group = self.saved


def nccl_kernels(rows):
    """(launches, names) of the NCCL kernels in a device profile's rows."""
    mine = [(n, key) for _, key, n in rows
            if "nccl" in key.lower() or "onerank" in key.lower()]
    return sum(n for n, _ in mine), sorted({k for _, k in mine})


def dist_trainers(conf):
    """19(a)'s three seeded trainers: the group's and two plain ones."""
    from munit_tpu_torch.train.trainer import MUNITTrainer
    device = torch.device("cuda", torch.cuda.current_device())
    return {name: new_trainer(MUNITTrainer, conf, device)
            for name in ("plain", "plain_again", "group")}


def dist_lockstep(trainers, conf, numerics, b, mesh):
    """DIST_LOCKSTEP iterations of ``trainers`` (dist_trainers): the one in
    the world-1 group and the two plain ones (outside the group), all
    captured, in 8c's lockstep: each iteration from the first plain
    trainer's state. Returns their run function, 8c's statistics and the
    launches (the group's by design)."""
    from munit_tpu_torch.kernels import norms
    from munit_tpu_torch.train.trainer import (cadence_iteration,
                                               cadence_steps)
    set_numerics(numerics)
    torch.backends.cudnn.deterministic = True
    batch = numerics_inputs(train_inputs(b, SEED + 19), numerics)
    plain = trainers["plain"]

    def run(name, it):
        tr = trainers[name]
        tr.iterations = it
        if name == "group":
            return cadence_iteration(tr, conf, it, *batch)
        with outside_group(mesh):
            return cadence_iteration(tr, conf, it, *batch)

    stats = {k: {"max_abs_leaf_diff": 0.0, "mean_abs_diff_sum": 0.0,
                 "bitwise_leaf_iterations": 0, "pre_update_losses": 0,
                 "pre_update_losses_differing": 0,
                 "post_update_max_rel_diff": 0.0}
             for k in ("group", "plain_again")}
    launches = {}
    by_design = {}
    for it in range(DIST_LOCKSTEP):
        for name in ("plain_again", "group"):
            trainers[name].load_state_dict(plain.state_dict())
        out = {}
        for name in trainers:
            norms.reset_launches()
            out[name] = run(name, it)
            launches.setdefault(name, Counter()).update(norms.launches)
            if name == "group":
                for k, d in norms.design_launches.items():
                    for design, n in d.items():
                        by_design.setdefault(k, Counter())[design] += n
        torch.cuda.synchronize()
        ref = state_leaves(plain)
        late = post_update(conf, cadence_steps, it)
        for name in ("group", "plain_again"):
            st, m, w = stats[name], out[name], out["plain"]
            state = state_leaves(trainers[name])
            leaf = largest_difference(state, ref)
            st["max_abs_leaf_diff"] = max(st["max_abs_leaf_diff"], leaf)
            st["mean_abs_diff_sum"] += (
                sum((v - ref[0][k]).abs().sum().item()
                    for k, v in state[0].items())
                / sum(v.numel() for v in ref[0].values()))
            st["bitwise_leaf_iterations"] += leaf == 0
            for k in w:
                if k == "lr":
                    continue
                if k in late:
                    st["post_update_max_rel_diff"] = max(
                        st["post_update_max_rel_diff"],
                        abs(float(m[k]) - float(w[k])) / abs(float(w[k])))
                else:
                    st["pre_update_losses"] += 1
                    st["pre_update_losses_differing"] += not torch.equal(
                        m[k], w[k])
    torch.backends.cudnn.deterministic = False
    return run, stats, {
        "launches": {k: dict(v) for k, v in launches.items()},
        "launches_by_design": {k: dict(v) for k, v in by_design.items()}}


def wait_for(path, what):
    deadline = time.monotonic() + 900
    while not Path(path).exists():
        check(time.monotonic() < deadline, f"19(a): no {what} from the phase")
        time.sleep(0.05)


def dist_world1(port, go_batch8, go_timed):
    """19(a), in a process of its own, a trainer in a world-1 group over
    NCCL, captured, against two plain captured trainers of config_256: 8c's
    lockstep test in 8c's numerics and batch (f32, TF32 off, batch 1),
    beside 19(b), (c) and (d); once the file ``go_batch8`` exists (19(b)'s
    processes and reference are done), the lockstep at batch 8 in bf16
    with the group trainer's norm launches and the iterations up to the
    timed windows, beside (c); once ``go_timed`` exists (the card is this
    process's alone), ms an iteration of each in turns and a profile of a
    replayed iteration of each step kind with the NCCL kernels in it."""
    from munit_tpu_torch.config import get_config
    from munit_tpu_torch.dist import mesh
    from munit_tpu_torch.kernels import build, norms
    from munit_tpu_torch.train.trainer import cadence_steps
    t0 = time.perf_counter()
    build.build_all()
    conf = get_config(str(CONFIG))
    mesh.init_group(f"localhost:{port},1,0", "cuda")
    _, stats_8c, _ = dist_lockstep(dist_trainers(conf), conf, "tf32_off", 1,
                                   mesh)
    gc.collect()
    torch.cuda.empty_cache()
    set_numerics("bf16")
    trainers = dist_trainers(conf)
    beside = time.perf_counter() - t0
    wait_for(go_batch8, "go at batch 8")
    t0 = time.perf_counter()
    run, stats, counted = dist_lockstep(trainers, conf, "bf16", DIST_BATCH,
                                        mesh)
    steps = cadence(conf, DIST_LOCKSTEP)
    want = expected_launches(norms, conf, steps)
    for it in range(DIST_LOCKSTEP, DIST_WARM):
        for name in ("plain", "group"):
            run(name, it)
    torch.cuda.synchronize()
    batch8 = time.perf_counter() - t0
    wait_for(go_timed, "go to time")
    t_alone = time.perf_counter()
    ms = {"plain": [], "group": []}
    start = DIST_WARM
    for name in ("plain", "group", "group", "plain"):
        first = start + DIST_TIMED * (len(ms[name]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for it in range(first, first + DIST_TIMED):
            run(name, it)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3 / DIST_TIMED)
    tr = trainers["group"]
    at = DIST_WARM + 2 * DIST_TIMED
    profiled = {}
    for kind, it in DIST_PROFILED.items():
        for skip in range(at, it):
            run("group", skip)
        before = sum(tr._graphs.replays.values())
        rows, _ = device_profile(lambda it=it: run("group", it), 1)
        n, names = nccl_kernels(rows)
        profiled[kind] = {"iteration": it, "nccl_kernels": n,
                          "nccl_kernel_names": names,
                          "replays": sum(tr._graphs.replays.values())
                          - before,
                          "steps": len(cadence_steps(conf, it))}
        at = it + 1
    return {"stats_8c": stats_8c, "stats": stats, **counted,
            "expected": want, "ms_per_iteration": ms, "profiled": profiled,
            "seconds_batch1": beside, "seconds_batch8": batch8,
            "seconds_alone": time.perf_counter() - t_alone,
            "graphs": {k: len(t._graphs) for k, t in trainers.items()},
            "world": mesh.world(), "backend": mesh.backend()}


def dist_b_steps(tr, conf, batch):
    """19(b)'s steps, each from the trainer's state now: {step: (metrics,
    the nets it updates on the host)}."""
    from munit_tpu_torch.io.checkpoint import to_host
    start = to_host(tr.state_dict())
    nets = {"dis": ("dis_a", "dis_b"), "dis_gen": ("gen", "dis_a", "dis_b"),
            "classifier_sr": ("classifier_sr_a", "classifier_sr_b")}
    out = {}
    x_a, x_b, m_a, m_b = batch
    for step in DIST_B_STEPS:
        tr.load_state_dict(start)
        tr.iterations = 0
        if step == "dis":
            m = tr.dis_update(x_a, x_b)
        elif step == "dis_gen":
            m = tr.dis_gen_update(x_a, x_b, m_a, m_b)
        else:
            m = tr.domain_classifier_sr_update(
                x_a, x_b, domain_synth=False,
                lamb=conf["adaptation"]["dfeat_lambda"])
        state = to_host(tr.state_dict())["nets"]
        out[step] = ({k: float(v) for k, v in m.items()},
                     {k: state[k] for k in nets[step]})
    return out, to_host(start)["nets"]


def dist_rank(rank, port, out):
    """19(b), one of two processes on the one card in a gloo group, eager:
    config_256 in parity numerics on its 4 rows of the global batch of 8;
    its steps' metrics and nets into ``out`` (torch.save)."""
    from munit_tpu_torch.config import get_config
    from munit_tpu_torch.dist import mesh
    from munit_tpu_torch.train.trainer import MUNITTrainer
    conf = get_config(str(CONFIG))
    device = mesh.init_group(f"localhost:{port},{DIST_WORLD},{rank}",
                             "cuda", _backend="gloo")
    set_numerics("tf32_off")
    torch.backends.cudnn.deterministic = True
    per = DIST_BATCH // DIST_WORLD
    r = int(rank)
    batch = [t[r * per:(r + 1) * per] for t in
             train_inputs(DIST_BATCH, SEED + 20)]
    tr = MUNITTrainer(conf, device, _capture=False)
    tr.init(torch.Generator().manual_seed(SEED))
    t0 = time.perf_counter()
    res, _ = dist_b_steps(tr, conf, batch)
    seconds = time.perf_counter() - t0
    torch.save(res, out)
    mesh.shutdown()
    return {"rank": r, "seconds": seconds}


def update_share(before, want, got, lr):
    """The share of a net's weights whose update parts from ``want``'s by
    more than 1e-2 lr plus an ulp (``tests/torch_port_util.update_errors``'
    rule), and the running statistics' largest |diff| over each vector's
    largest."""
    past, total, stats = 0, 0, 0.0
    for k, w in want.items():
        g, b = got[k].double(), before[k].double()
        if "running" in k:
            stats = max(stats, ((g - w.double()).abs().max()
                                / w.double().abs().max()).item())
            continue
        gap = ((g - b) - (w.double() - b)).abs()
        ulp = torch.maximum(b.abs(), w.double().abs()) * 2.0 ** -23
        past += int((gap > 1e-2 * lr + ulp).sum())
        total += gap.numel()
    return {"share": past / max(total, 1), "stats_rel": stats}


def dist_cli(cfg: Path, out: Path, counts: Path, *extra):
    port = free_port()
    return subprocess.Popen(
        [sys.executable, "-c", CLI_RUNNER, str(counts), "train", "--config",
         str(cfg), "--output_path", str(out), "--dist",
         f"localhost:{port},1,0", *extra],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def dist_replicas_phase(norms, get_config, tmp: Path):
    """19(d): translate_batch's decodes and the service's dispatch through
    ``Replicas([cuda:0, cuda:0])`` against one replica on the same parts,
    bit for bit; the launches of the two-replica dispatch."""
    from types import SimpleNamespace
    from munit_tpu_torch.cli import translate_batch
    from munit_tpu_torch.core import ops
    from munit_tpu_torch.nn.generator import GenBundle
    from munit_tpu_torch.serve import server
    conf = get_config(str(CONFIG))
    ops.set_conv_compute(None)
    parity_mode(True)
    gen = GenBundle(conf, "cuda")
    gen.init(torch.Generator().manual_seed(SEED + 21))
    ckpt = tmp / "dist_gen.pt"
    torch.save({"2": {k: v.cpu() for k, v in gen.state_dict().items()}},
               ckpt)
    two = [torch.device("cuda", 0)] * 2
    g = torch.Generator().manual_seed(SEED + 22)
    x = (torch.rand((1, 256, 256, 3), generator=g) * 2 - 1).cuda()
    styles = torch.randn((DIST_STYLES, conf["gen"]["style_dim"]),
                         generator=g)
    def opts(num_style, mesh):
        return SimpleNamespace(checkpoint=str(ckpt), a2b=1,
                               num_style=num_style, mesh=mesh)
    saved = translate_batch.mesh_devices
    try:
        translate_batch.mesh_devices = lambda mesh, device: two
        pair = translate_batch.munit_translator(opts(DIST_STYLES, "auto"),
                                                conf, "cuda")
        with torch.inference_mode():
            norms.reset_launches()
            got = pair(x, styles)
            torch.cuda.synchronize()
            tb_launches = dict(norms.launches)
    finally:
        translate_batch.mesh_devices = saved
    one = translate_batch.munit_translator(opts(DIST_STYLES // 2, "off"),
                                           conf, "cuda")
    whole = translate_batch.munit_translator(opts(DIST_STYLES, "off"), conf,
                                             "cuda")
    with torch.inference_mode():
        half = DIST_STYLES // 2
        want = torch.cat([one(x, styles[:half]), one(x, styles[half:])])
        whole_out = whole(x, styles)
    tb_bitwise = torch.equal(got, want)
    tb_whole_diff = (got - whole_out).abs().max().item()

    saved = server.mesh_devices
    try:
        server.mesh_devices = lambda mesh, device: two
        svc2 = server.TranslationService(conf, gen, max_batch=8, mesh="auto")
    finally:
        server.mesh_devices = saved
    svc1 = server.TranslationService(conf, gen, max_batch=8, mesh="off")
    style = np.zeros((1, conf["gen"]["style_dim"]), np.float32)
    for svc in (svc1, svc2):
        svc.styles["default"] = style
        svc.warmup()
    rng = np.random.RandomState(SEED + 23)
    xs = rng.uniform(-1, 1, (8, 256, 256, 3)).astype(np.float32)
    ss = rng.randn(8, conf["gen"]["style_dim"]).astype(np.float32)
    norms.reset_launches()
    out2 = svc2._run_padded(xs, ss)
    serve_launches = dict(norms.launches)
    out1 = np.concatenate([svc1._run_padded(xs[:4], ss[:4]),
                           svc1._run_padded(xs[4:], ss[4:])])
    whole1 = svc1._run_padded(xs, ss)
    graphs = [len(gr) for gr in svc2._graphs]
    for svc in (svc1, svc2):
        svc.batcher.close()
    res = {"translate_batch_bitwise": tb_bitwise,
           "translate_batch_vs_one_call_max_abs": tb_whole_diff,
           "translate_batch_launches": tb_launches,
           "serve_bitwise": bool(np.array_equal(out2, out1)),
           "serve_vs_one_call_max_abs": float(np.abs(out2 - whole1).max()),
           "serve_buckets": svc2.batcher.buckets,
           "serve_min_batch": svc2.batcher.min_batch,
           "serve_graphs_per_replica": graphs,
           "serve_launches": serve_launches}
    emit(phase="dist_replicas", devices=[str(d) for d in two], **res)
    check(tb_bitwise, f"translate_batch on two replicas: {res}")
    check(res["serve_bitwise"], f"serve on two replicas: {res}")
    check(graphs == [3, 3] and res["serve_min_batch"] == 2
          and res["serve_buckets"] == [2, 4, 8],
          f"two-replica service's buckets and graphs: {res}")
    # translate_batch: one content encode (11 IN), a decode a replica (8
    # AdaIN, 2 LN each); the service: an encode and a decode a replica
    want_tb = {"instance_norm": 11, "adain": 16, "whole_layer_norm": 4}
    want_serve = {"instance_norm": 22, "adain": 16, "whole_layer_norm": 4}
    for k in want_tb:
        check(tb_launches[k] == want_tb[k]
              and serve_launches[k] == want_serve[k],
              f"two-replica launches of {k}: {tb_launches}, "
              f"{serve_launches}")
    return res


def dist_phase(norms, get_config, data, tmp: Path):
    """Phase 19: data parallel (ROADMAP item 16). (a)'s process, (b)'s two
    gloo ranks and (c)'s train CLI under --dist start together, with (b)'s
    reference and then (d) in this process; (a) runs its 8c leg beside
    them, its batch-8 leg once (b) is done, and its timed part alone once
    (c) is done. Returns the group trainer's norm launches by design
    (19a)."""
    t_phase = time.perf_counter()
    conf = get_config(str(CONFIG))
    root = tmp / "dist"
    root.mkdir(parents=True, exist_ok=True)
    go = (root / "world1_batch8.go", root / "world1_timed.go")
    a_proc = start_dist("world1", root / "world1.json", free_port(), *go)
    port = free_port()
    ranks = [start_dist("rank", root / f"rank{r}.json", r, port,
                        root / f"rank{r}.pt") for r in range(DIST_WORLD)]
    cfg = write_config(root / "cli" / "config_256.yaml", data,
                       {**DIST_CLI_KEYS, "max_iter": DIST_CLI_SPLIT})
    t_cli = time.perf_counter()
    cli = dist_cli(cfg, root / "cli", root / "cli_counts.json")
    try:
        return dist_checks(norms, get_config, conf, root, ranks, cli, cfg,
                           t_cli, a_proc, go, t_phase)
    finally:
        for proc in (a_proc, *ranks, cli):
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def dist_checks(norms, get_config, conf, root, ranks, cli, cfg, t_cli,
                a_proc, go, t_phase):
    """dist_phase's waits and checks, the processes started."""
    from munit_tpu_torch.io import checkpoint
    from munit_tpu_torch.train.trainer import MUNITTrainer
    # the one-process reference of (b), on the whole batch
    set_numerics("tf32_off")
    torch.backends.cudnn.deterministic = True
    ref_tr = MUNITTrainer(conf, "cuda", _capture=False)
    ref_tr.init(torch.Generator().manual_seed(SEED))
    ref, before = dist_b_steps(ref_tr, conf,
                               train_inputs(DIST_BATCH, SEED + 20))
    torch.backends.cudnn.deterministic = False
    del ref_tr
    gc.collect()
    torch.cuda.empty_cache()
    d = dist_replicas_phase(norms, get_config, root)
    gc.collect()
    torch.cuda.empty_cache()
    rank_info = [wait_dist(p, root / f"rank{r}.json", f"19(b) rank {r}")[0]
                 for r, p in enumerate(ranks)]
    go[0].touch()
    got = [torch.load(root / f"rank{r}.pt", weights_only=False)
           for r in range(DIST_WORLD)]
    b_res = {}
    lr = float(conf["lr"])
    ranks_equal = True
    for step in DIST_B_STEPS:
        (m_ref, nets_ref), (m0, nets0) = ref[step], got[0][step]
        m1, nets1 = got[1][step]
        ranks_equal &= m0 == m1 and all(
            torch.equal(nets0[n][k], nets1[n][k])
            for n in nets0 for k in nets0[n])
        rel = max(abs(m0[k] - v) / max(abs(v), 1e-12)
                  for k, v in m_ref.items() if k != "lr")
        per_net = {n: update_share(before[n], nets_ref[n], nets0[n], lr)
                   for n in nets_ref}
        b_res[step] = {"losses_max_rel_diff": rel, "nets": per_net}
    stdout, stderr = cli.communicate(timeout=600)
    check(cli.returncode == 0, f"19(c) train --dist: {stderr[-3000:]}")
    cfg.write_text(cfg.read_text().replace(
        f"max_iter: {DIST_CLI_SPLIT}", f"max_iter: {DIST_CLI_ITERS}"))
    resumed = dist_cli(cfg, root / "cli", root / "cli_counts2.json",
                       "--resume")
    r_out, r_err = resumed.communicate(timeout=600)
    cli_seconds = time.perf_counter() - t_cli
    check(resumed.returncode == 0, f"19(c) --resume: {r_err[-3000:]}")
    run = root / "cli" / "outputs" / "config_256"
    lines = [json.loads(ln) for ln in (run / "metrics.jsonl").open()]
    logged = [m["step"] for m in lines if "loss_dis_total" in m]
    finite = all(np.isfinite(v) for m in lines for k, v in m.items()
                 if k.startswith("loss"))
    sem = [m["loss_sem_seg"] for m in lines if "loss_sem_seg" in m]
    snapshots = checkpoint.steps(str(run / "checkpoints"))
    images = sorted(p.name for p in (run / "images").iterdir())
    counts = [json.loads((root / n).read_text())["launches"]
              for n in ("cli_counts.json", "cli_counts2.json")]
    emit(phase="dist_gloo_ranks", world=DIST_WORLD, batch_each=DIST_BATCH
         // DIST_WORLD, numerics="tf32_off", eager=True,
         steps=b_res, ranks_bitwise_equal=ranks_equal, ranks=rank_info,
         losses_rtol=POST_UPDATE_RTOL, update_share_max=UPDATE_SHARE_MAX)
    emit(phase="dist_cli", world=1, backend="nccl", logged_steps=logged,
         snapshots=snapshots, images=images, losses_finite=finite,
         loss_sem_seg=sem, resumed="Resume from iteration" in r_out,
         launches=counts, seconds_two_runs=cli_seconds)
    check(ranks_equal, "19(b): the two ranks' states differ")
    for step, r in b_res.items():
        check(r["losses_max_rel_diff"] <= POST_UPDATE_RTOL,
              f"19(b) {step}: {r}")
        for net, e in r["nets"].items():
            check(e["share"] <= UPDATE_SHARE_MAX
                  and e["stats_rel"] <= POST_UPDATE_RTOL,
                  f"19(b) {step} {net}: {e}")
    check(logged == list(range(1, DIST_CLI_ITERS + 1)),
          f"19(c) logged steps {logged}")
    check(finite and sem and min(sem) > 0,
          f"19(c) losses finite {finite}, loss_sem_seg {sem}")
    check(snapshots == list(range(2, DIST_CLI_ITERS + 1, 2)),
          f"19(c) snapshots {snapshots}")
    check("Resume from iteration 4" in r_out, f"19(c) resume: {r_out[-2000:]}")
    # the rest of (a), alone on the card: it is timed
    go[1].touch()
    a, _ = wait_dist(a_proc, root / "world1.json", "19(a)")
    emit(phase="dist_world1", batch=DIST_BATCH, numerics="bf16",
         lockstep_8c={"batch": 1, "numerics": "tf32_off",
                      "cudnn_deterministic": True},
         lockstep_iterations=DIST_LOCKSTEP, bf16_post_update_rtol=
         DIST_BF16_POST_RTOL, **a)
    check(a["world"] == 1 and a["backend"] == "nccl", f"19(a): {a}")
    check(a["launches"]["group"] == a["launches"]["plain"] == a["expected"],
          f"19(a) launches {a['launches']}, want {a['expected']}")
    for key, post_rtol in (("stats_8c", POST_UPDATE_RTOL),
                           ("stats", DIST_BF16_POST_RTOL)):
        st, noise = a[key]["group"], a[key]["plain_again"]
        check(st["pre_update_losses_differing"] == 0,
              f"19(a) {key} pre-update losses differ: {st}")
        check(st["post_update_max_rel_diff"] <= post_rtol,
              f"19(a) {key} post-update losses: {st}")
        if noise["bitwise_leaf_iterations"] == DIST_LOCKSTEP:
            check(st["bitwise_leaf_iterations"] == DIST_LOCKSTEP,
                  f"19(a) {key} state differs where plain is bitwise: {st}")
        else:
            check(st["mean_abs_diff_sum"] <= 2 * noise["mean_abs_diff_sum"],
                  f"19(a) {key} state {st} against plain-to-plain {noise}")
    for kind, p in a["profiled"].items():
        check(p["nccl_kernels"] > 0 and p["replays"] == p["steps"],
              f"19(a) profile of a replayed {kind} iteration: {p}")
    emit(phase="dist_seconds", seconds=time.perf_counter() - t_phase)
    return a["launches_by_design"], d


def dist_alone() -> int:
    """``python3 chip_smoke.py --dist``: the build and phase 19 alone."""
    from munit_tpu_torch.config import get_config
    from munit_tpu_torch.kernels import build, norms
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        data = write_train_data(Path(tmp) / "data")
        dist_phase(norms, get_config, data, Path(tmp))
    return 0


# Phase 2's host µs per wrapper call without a gradient (through the
# registered operators, where a checkout has them) in a checkout, through
# its own chip_smoke.py, in turns with the direct forward
# (``norms._forward``, the wrapper's path without the operators) in the
# same process
HOST_US_CODE = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
from munit_tpu_torch.kernels import build, norms
build.build_all()
gen = torch.Generator(device="cuda").manual_seed(c.SEED + 2)
out = {}
for name, shape in (("adain", (1, 64, 64, 256)),
                    ("instance_norm", (1, 128, 128, 128)),
                    ("whole_layer_norm", (1, 256, 256, 64))):
    a = c.make_inputs(*shape, torch.float32, gen)
    g, b = c.affine_of(name, a) or (None, None)
    row = out[name] = {"wrapper": [], "direct": []}
    with torch.no_grad():
        for _ in range(5):
            row["wrapper"].append(c.host_us(
                lambda: c.call(norms, name, a, True)))
            row["direct"].append(c.host_us(
                lambda: norms._forward(name, a["x"], g, b, True)))
print(json.dumps(out))
"""


def host_us_trees(trees) -> int:
    """``python3 chip_smoke.py --host-us TREE ...``: the host µs per wrapper
    call and per direct forward (five means of HOST_CALLS calls each, in
    turns) in each checkout, in order, each in a process of its own."""
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", HOST_US_CODE], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        check(out.returncode == 0, f"{tree}: {out.stderr[-2000:]}")
        emit(phase="host_us_tree", tree=tree, calls=HOST_CALLS,
             forward_us=json.loads(out.stdout.strip().splitlines()[-1]))
    return 0


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


def hd_rows(name, hd):
    """(calls, row) of a wrapper's (``name``, or its backward ``name_bwd``)
    config_HD calls at batch 1, float32, from phase 15(a)'s times."""
    base = name.removesuffix("_bwd")
    if name.endswith("_bwd"):
        return [(n, hd["bwd_times"][(base, *key, key[0])])
                for key, n in HD_BWD_CALLS[base].items()]
    return [(n, hd["times"][(base, 1, *hwc, "float32")])
            for hwc, n in HD_CALLS[base].items()]


def hd_fields(name, hd):
    """A grid kernel's config_HD figures: the sums over ``hd_rows`` of
    phase 15(a)'s times, its largest errors there, and its launches in
    phase 15(b)'s batch-1 runs (both wides) and train CLI."""
    errs = hd["bwd_err" if name.endswith("_bwd") else "err"]
    base = name.removesuffix("_bwd")
    rows = hd_rows(name, hd)
    out = {f"{key}_hd": sum(n * r[key] for n, r in rows)
           for key in ("ms", "bound_ms", "plain_ms", "library_ms")}
    out.update(max_abs_err_hd=errs[(base, "grid", "float32")],
               max_abs_err_hd_bf16=errs[(base, "grid", "bfloat16")],
               launches_hd=sum(r["launches"][name]["grid"]
                               for r in hd["runs"].values())
               + hd["cli"][name]["grid"],
               launches_hd_fused_step={
                   f"wide {w}": r["fused_launches"][name]["grid"]
                   for w, r in hd["runs"].items()})
    return out


def kernel_table(err, times, bwd_err, bwd_times, launches, train_launches,
                 mom_err, mom_times, probe_launches, cli_launches,
                 sim_launches, vanilla_launches, hd, eval_launches,
                 serve_launches, aot_launches, unit_launches, dist_launches):
    """The kernel line: one entry per wrapper and design (the cluster and
    the grid kernels of a wrapper are separate kernels), forward and
    backward, then the moments kernels of the probes. The grid kernels
    also carry their config_HD figures (``*_hd``, phase 15), the forward
    ones their launches in phase 16's evaluate run (``launches_eval``), in
    phase 17's served requests (``launches_serve``), in phase 18's
    artifact dispatches (``launches_aot``) and UNIT run
    (``launches_unit``); every norm kernel its launches in phase 19's
    data-parallel training (``launches_dist``)."""

    def later(name, design):
        return {"launches_aot": aot_launches.get(name, {}).get(design, 0),
                "launches_unit": unit_launches.get(name, {}).get(design, 0)}

    def dist(name, design):
        return {"launches_dist": dist_launches.get(name, {}).get(design, 0)}

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

    def hd_only(name, replaces, also):
        """The grid kernel of a wrapper that only config_HD's path runs
        (AdaIN at 128², forward and backward): its figures are phase
        15's."""
        f = hd_fields(name, hd)
        errs = hd["bwd_err" if name.endswith("_bwd") else "err"]
        extra = ({} if name.endswith("_bwd") else
                 {"launches_eval": eval_launches[name]["grid"],
                  "launches_serve": serve_launches[name]["grid"],
                  **later(name, "grid")})
        return entry(name, "grid", hd_rows(name, hd), errs, **f, **extra,
                     **dist(name, "grid"),
                     replaces=replaces, also_replaces=also,
                     launches=f["launches_hd"],
                     per="config_HD's calls of this design at batch 1, "
                         "float32: one translated image's (forward) or one "
                         "narrow fused step's (backward) (phase 15a); "
                         "launches: config_HD's batch-1 warm-ups (wide 0 "
                         "and 1) and its train CLI (phase 15b)")

    kernels = []
    for name, calls in PATH_CALLS.items():
        rows = [(n, times[(name, 1, *hwc, "float32")])
                for hwc, n in calls.items()]
        if "grid" not in norms_designs(rows):
            kernels.append(hd_only(name, *REPLACES[name]))
        for design in norms_designs(rows):
            mine = [(n, r) for n, r in rows if r["design"] == design]
            extra = hd_fields(name, hd) if design == "grid" else {}
            kernels.append(entry(
                name, design, mine, err, **extra,
                replaces=REPLACES[name][0], also_replaces=REPLACES[name][1],
                launches=launches[name][design],
                launches_train=train_launches["tf32"][name][design],
                launches_train_bf16=train_launches["bf16"][name][design],
                launches_cli=cli_launches[name][design],
                launches_sim2real=sim_launches[name][design],
                launches_vanilla=vanilla_launches[name][design],
                launches_eval=eval_launches[name][design],
                launches_serve=serve_launches[name][design],
                **later(name, design), **dist(name, design),
                per="one translated image: its calls of this design at "
                    "batch 1, float32; split_ms: the split design's time "
                    "for the same calls (the was); library_ms: one PyTorch "
                    "call of the same function (IN and AdaIN: F.batch_norm "
                    "on the (1, B C, H, W) view); launches: translate run "
                    "(phase 4), launches_train(_bf16): 15 training "
                    "iterations at batch 1 with TF32 (in bf16; phase 8), "
                    "launches_cli: the train CLI's 20 iterations and 8 "
                    "sample grids (phase 12), launches_sim2real: the train "
                    "CLI's 3 final_test runs of 20 iterations (phase 13), "
                    "launches_vanilla: its 2 vanilla runs of 20 iterations "
                    "and 8 grids each (phase 14); *_hd: one HD translated "
                    "image's calls at batch 1, float32 (phase 15a), "
                    "launches_hd: config_HD's batch-1 warm-ups (wide 0 and "
                    "1) and its train CLI (phase 15b), "
                    "launches_hd_fused_step: one replayed fused step's; "
                    "launches_eval: evaluate fid --kid over 32 pairs "
                    "(phase 16); launches_serve: 16 requests through the "
                    "micro-batched service, replays (phase 17a); "
                    "launches_aot: the f32, bf16 and int8 artifacts' "
                    "dispatches at batch 1 and 8 in fresh processes (phase "
                    "18b); launches_unit: translate_batch --trainer UNIT "
                    "over 16 images (phase 18e); launches_dist: 15 "
                    "iterations at batch 8 in bf16 of a trainer in a world-1 "
                    "NCCL group, captured (phase 19a)"))
    for name, calls in BWD_CALLS.items():
        rows = [(n, bwd_times[(name, *key, key[0])])
                for key, n in calls.items()]
        if "grid" not in norms_designs(rows):
            kernels.append(hd_only(name + "_bwd", BWD_REPLACES[name],
                                   BWD_ALSO))
        for design in norms_designs(rows):
            mine = [(n, r) for n, r in rows if r["design"] == design]
            extra = (hd_fields(name + "_bwd", hd) if design == "grid"
                     else {})
            kernels.append(entry(
                name + "_bwd", design, mine, bwd_err, **extra,
                replaces=BWD_REPLACES[name], also_replaces=BWD_ALSO,
                launches=train_launches["tf32"][name + "_bwd"][design],
                launches_bf16=train_launches["bf16"][name + "_bwd"][design],
                launches_cli=cli_launches[name + "_bwd"][design],
                launches_sim2real=sim_launches[name + "_bwd"][design],
                launches_vanilla=vanilla_launches[name + "_bwd"][design],
                **dist(name + "_bwd", design),
                per="one fused dis+gen step's backward calls of this design "
                    "at batch 1, float32; split_ms: the split design's "
                    "time for the same calls; launches(_bf16): 15 training "
                    "iterations at batch 1 with TF32 (in bf16; phase 8), "
                    "launches_cli: the train CLI's 20 iterations (phase "
                    "12), launches_sim2real: its 3 final_test runs (phase "
                    "13), launches_vanilla: its 2 vanilla runs (phase 14); "
                    "*_hd: one narrow config_HD fused step's backward calls "
                    "at batch 1, float32 (phase 15a), launches_hd and "
                    "launches_hd_fused_step as the forward's; "
                    "launches_dist: phase 19a's, as the forward's"))
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
    if sys.argv[1:] == ["--sim2real"]:
        return sim2real_alone()
    if sys.argv[1:] == ["--vanilla"]:
        return vanilla_alone()
    if sys.argv[1:] == ["--hd"]:
        return hd_alone()
    if sys.argv[1:] == ["--eval"]:
        return eval_alone()
    if sys.argv[1:] == ["--serve"]:
        return serve_alone()
    if sys.argv[1:] == ["--aot"]:
        return aot_alone()
    if sys.argv[1:] == ["--dist"]:
        return dist_alone()
    if sys.argv[1:2] == ["--host-us"]:
        return host_us_trees(sys.argv[2:])
    if sys.argv[1:2] == ["--cli-numerics"]:
        return cli_numerics(sys.argv[2:])
    if sys.argv[1:2] == ["--profiler"]:
        return profiler_alone(sys.argv[2:])
    grads_dir = Path(tempfile.mkdtemp())
    grads_cpu = []
    try:
        return whole_run(grads_dir, grads_cpu)
    finally:
        for proc in grads_cpu:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(grads_dir)


def whole_run(grads_dir: Path, started: list) -> int:
    """Phases 1-19; phase 9's CPU runs start after the imports, beside
    phases 1-8 (the card's phases leave most of the host's cores idle),
    their process appended to ``started``."""
    # a checkout of the repo: the port and its sources must be here
    from munit_tpu_torch.cli import translate
    from munit_tpu_torch.config import get_config, validate
    from munit_tpu_torch.io.weights import load_reference_checkpoint
    from munit_tpu_torch.kernels import build, moments, norms
    from munit_tpu_torch.nn.generator import GenBundle
    from munit_tpu_torch.nn.resnet import ResNet34_8s, seg_preprocess
    from munit_tpu_torch.tools import normprobe
    from munit_tpu_torch.train import graphs
    from munit_tpu_torch.train.trainer import (MUNITTrainer,
                                               cadence_iteration,
                                               cadence_steps, train_steps)

    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    grads_cpu = grads_cpu_start(grads_dir)
    started.append(grads_cpu[0])
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
    capture_phase(norms, moments, graphs)

    segmenter_phase(ResNet34_8s, seg_preprocess)

    train_conf = get_config(str(CONFIG))
    check(train_conf["semantic_w"] > 0, "config_256 trains with semantic_w")
    train_launches, fixed = {}, {}
    # TF32 at batch 1 only: its batch-8 leg (~45 s) was cut to keep the
    # script within its limit once phase 19 joined it; bf16, the
    # production numerics, keeps batch 1 and 8
    for numerics, batches in (("tf32", (1,)), ("bf16", BATCHES)):
        for b in batches:
            tr, batch, counts = training_phase(
                norms, MUNITTrainer, train_steps, train_conf, b, numerics)
            train_launches.setdefault(numerics, counts)
            res = train_time_phase(tr, batch, train_conf, b, numerics)
            if numerics == "bf16":
                fixed[b] = res
            del tr, batch
            torch.cuda.empty_cache()
    capture_parity_phase(MUNITTrainer, cadence_iteration, cadence_steps,
                         train_conf)
    grads_phase(MUNITTrainer, train_conf, removed_by_norm, grads_cpu,
                bench_phase)

    parity_mode(True)
    mom_err, mom_times = moments_phase(moments)
    _, probe_launches = probe_phase(moments, norms, normprobe)

    parity_mode(True)
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches, data = cli_phase(norms, get_config, Path(tmp))
        resume_phase(MUNITTrainer, train_steps, train_conf, Path(tmp))
        feed_phase(norms, MUNITTrainer, get_config, data, fixed, Path(tmp))
        sim_launches = sim2real_phase(norms, get_config, validate, data,
                                      Path(tmp))
        vanilla_launches = vanilla_phase(norms, get_config, validate, data,
                                         Path(tmp))
        hd = hd_phase(norms, get_config, validate, Path(tmp))
        eval_launches = eval_phase(norms, get_config, Path(tmp))
        serve_launches = serve_phase(norms, get_config, data, Path(tmp))
        aot_launches, unit_launches = aot_phase(norms, get_config, data,
                                                Path(tmp))
        dist_launches, _ = dist_phase(norms, get_config, data, Path(tmp))

    print(json.dumps({"kernels": kernel_table(
        err, times, bwd_err, bwd_times, launches, train_launches, mom_err,
        mom_times, probe_launches, cli_launches, sim_launches,
        vanilla_launches, hd, eval_launches, serve_launches, aot_launches,
        unit_launches, dist_launches)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
