"""Whole-tensor LayerNorm probes on the card: the questions of the JAX
package's TPU probes (``tools/normprobe.py``, ``normprobe2.py``,
``normprobe3.py``), asked of the port's kernels.

    python -m munit_tpu_torch.tools.normprobe [--device cuda|cpu] [--small]
                                              [--k K] [--reps R]

- **P1, in isolation** (normprobe.py's shapes, bfloat16): a K-chain
  y ← f(y) of each variant: the identity-and-scale floor (one read, one
  write); v0 the port's ``kernels.norms.whole_layer_norm`` (Welford
  partials, a merge, an apply: three kernels); v1 plain torch
  (``core.ops.whole_layer_norm``); v2 the one-pass moments of
  ``kernels.moments.sample_sums`` and a torch apply; v3 ``sample_sums`` and
  ``sample_affine``.
- **P2, after the 5x5 conv** (normprobe2.py): conv (reflect pad, bf16 in,
  f32 out) + bias, then each variant with its ReLU, the result scaled and
  cast back to bf16, chained; beside a conv + bias + ReLU baseline.
- **P3, under grad in the decoder tail** (normprobe3.py:35-56, plain convs
  in place of space-to-depth): conv5x5 → LN + ReLU → 7x7 out-conv → tanh →
  1x1, chained, the gradient of Σ out² to the input: autograd of plain;
  ``kernels.norms.whole_layer_norm``'s autograd Function; v2, the
  moments forward with a closed-form backward whose two sums are
  ``sample_sums(ĝ, y − mean)``.

Times are per application (P1, P2) or per block forward and backward (P3),
over a K-chain timed with CUDA events on the card; a CPU run prints host
times only, under another name. Each variant's error is taken against the
plain v1 (P3: the plain autograd gradient of the LN + ReLU alone, and of
the whole block beside a second plain run's), as the TPU probes hold
theirs against their jnp form. The default device is ``cuda``; without a
card it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from munit_tpu_torch.core import ops
from munit_tpu_torch.kernels import moments, norms

P1_SHAPES = ((16, 256, 256, 64), (16, 128, 128, 128), (8, 256, 256, 64))
P2_SHAPES = ((16, 256, 256, 64), (16, 128, 128, 128))
P3_SHAPE = (16, 256, 256, 64)
# --small: the same channel counts at a few pixels, for a CPU run
SMALL_P1 = ((2, 16, 16, 64), (2, 8, 8, 128), (1, 16, 16, 64))
SMALL_P2 = ((2, 16, 16, 64), (2, 8, 8, 128))
SMALL_P3 = (2, 16, 16, 64)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, reps, device):
    """ms per call of fn over ``reps`` calls after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def chain_ms(step, x, k, reps, device):
    """Time per application of ``step`` in a K-chain x ← step(x)."""
    def chained():
        y = x
        for _ in range(k):
            y = step(y)
        return y

    return timed_ms(chained, reps, device) / k


def _row(device, probe, shape, dtype, variant, ms, err=None, **extra):
    key = "ms" if device.type == "cuda" else "host_ms"
    row = {"probe": probe, "shape": list(shape),
           "dtype": str(dtype).split(".")[1], "variant": variant, key: ms}
    if err is not None:
        row["max_err_vs_plain"] = err
    row.update(extra)
    return row


def _max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def ln_variants(relu):
    """{name: f(x, gamma, beta)} of the forward variants of P1 and P2."""
    return {
        "v0 norms.whole_layer_norm (3 Welford kernels)":
            lambda x, g, b: norms.whole_layer_norm(x, g, b, relu),
        "v1 plain torch":
            lambda x, g, b: norms.whole_layer_norm_plain(x, g, b, relu),
        "v2 sample_sums + torch apply":
            lambda x, g, b: moments.sample_affine_plain(
                x, *moments.ln_coefficients(moments.sample_sums(x),
                                            x[0].numel())[:2], g, b, relu),
        "v3 sample_sums + sample_affine":
            lambda x, g, b: moments.whole_layer_norm(x, g, b, relu),
    }


def _inputs(shape, device, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[3]
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    gamma = torch.from_numpy(rng.rand(c).astype(np.float32))
    beta = torch.from_numpy((0.01 * rng.randn(c)).astype(np.float32))
    return rng, x.to(device), gamma.to(device), beta.to(device)


@torch.no_grad()
def probe_p1(device, shapes, k, reps):
    """P1: each variant alone on a bf16 tensor."""
    rows = []
    for shape in shapes:
        _, x, gamma, beta = _inputs(shape, device)
        x = x.to(torch.bfloat16)
        rows.append(_row(device, "P1", shape, x.dtype, "id+scale floor",
                         chain_ms(lambda t: t * 1.0009, x, k, reps, device)))
        variants = ln_variants(False)
        want = variants["v1 plain torch"](x, gamma, beta)
        for name, f in variants.items():
            def step(t, f=f):
                return f(t, gamma, beta)
            rows.append(_row(device, "P1", shape, x.dtype, name,
                             chain_ms(step, x, k, reps, device),
                             _max_err(f(x, gamma, beta), want),
                             plain_scale=float(want.float().abs().max())))
    return rows


def _conv_weights(rng, shape, scale, device, dtype=torch.bfloat16):
    """HWIO numpy draws (the TPU probes' layout) → an OIHW tensor."""
    w = rng.randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy()).to(
        device, dtype)


def _conv5(t, w5, b5):
    """Reflect-padded 5x5 conv of a bf16 input, f32 out, plus bias."""
    return ops.conv2d(ops.pad2d(t, 2, "reflect"), w5).float() + b5


@torch.no_grad()
def probe_p2(device, shapes, k, reps):
    """P2: conv5x5 + bias, then each variant with its ReLU, chained."""
    rows = []
    for shape in shapes:
        rng, x, gamma, beta = _inputs(shape, device)
        c = shape[3]
        x = x.to(torch.bfloat16)
        w5 = _conv_weights(rng, (5, 5, c, c), 0.05, device)
        b5 = torch.from_numpy((rng.randn(c) * 0.01).astype(np.float32)).to(device)

        def block(ln):
            def step(t):
                y = _conv5(t, w5, b5)
                y = torch.relu(y) if ln is None else ln(y, gamma, beta)
                return (y * 0.1).to(torch.bfloat16)
            return step

        rows.append(_row(device, "P2", shape, torch.float32,
                         "conv+bias+relu baseline (no LN)",
                         chain_ms(block(None), x, k, reps, device)))
        variants = ln_variants(True)
        y0 = _conv5(x, w5, b5)
        want = variants["v1 plain torch"](y0, gamma, beta)
        for name, f in variants.items():
            rows.append(_row(device, "P2", shape, torch.float32, name,
                             chain_ms(block(f), x, k, reps, device),
                             _max_err(f(y0, gamma, beta), want),
                             plain_scale=float(want.float().abs().max())))
    return rows


class LNFromSums(torch.autograd.Function):
    """P3's v2: the LayerNorm + ReLU forward from the moments kernel and
    the apply kernel, and the closed-form backward of normprobe3.py's
    ``_v2_bwd`` whose two per-sample sums, Σĝ and Σĝ·(y − mean), come from
    ``sample_sums``: with d = std + eps and n = H·W·C,
    dx = ĝ/d − Σĝ/(n d) − (y − mean)·Σĝ(y − mean)/(d² (n − 1) std)."""

    @staticmethod
    def forward(ctx, y, gamma, beta):
        n = y[0].numel()
        mean, inv, std = moments.ln_coefficients(moments.sample_sums(y), n)
        ctx.save_for_backward(y, mean, std, gamma, beta)
        return moments.sample_affine(y, mean, inv, gamma, beta, relu=True)

    @staticmethod
    def backward(ctx, g):
        y, mean, std, gamma, beta = ctx.saved_tensors
        n = y[0].numel()
        shape = (-1, 1, 1, 1)
        d = (std + ops.EPS).view(shape)
        dev = (ops.upcast_f32(y) - mean.view(shape)).contiguous()
        live = (dev / d) * gamma + beta > 0
        gh = (torch.where(live, ops.upcast_f32(g), 0.0) * gamma).contiguous()
        sums = moments.sample_sums(gh, dev)
        s1, s2 = sums[:, 0].view(shape), sums[:, 1].view(shape)
        dx = gh / d - s1 / (n * d) - dev * (s2 / (d * d * (n - 1)
                                                  * std.view(shape)))
        return dx.to(y.dtype), None, None


def probe_p3(device, shape, k, reps):
    """P3: the decoder tail under grad, forward and backward per block."""
    rng, x, gamma, beta = _inputs(shape, device)
    c = shape[3]
    x = x.to(torch.bfloat16)
    w5 = _conv_weights(rng, (5, 5, c, c), 0.05, device)
    b5 = torch.from_numpy((rng.randn(c) * 0.01).astype(np.float32)).to(device)
    w7 = _conv_weights(rng, (7, 7, c, 3), 0.05, device)
    b7 = torch.from_numpy((rng.randn(3) * 0.01).astype(np.float32)).to(
        device, torch.bfloat16)
    w1 = _conv_weights(rng, (1, 1, 3, c), 0.3, device)

    def tail(z):
        out = ops.conv2d(ops.pad2d(z.to(torch.bfloat16), 3, "reflect"), w7, b7)
        return ops.conv2d(torch.tanh(out), w1).to(torch.bfloat16)

    variants = {
        "autograd of plain": lambda y: torch.relu(
            ops.whole_layer_norm(y, gamma, beta)),
        "norms.whole_layer_norm autograd Function": lambda y:
            norms.whole_layer_norm(y, gamma, beta, True),
        "v2 sample_sums closed-form backward": lambda y:
            LNFromSums.apply(y, gamma, beta),
    }

    def grad_of(ln, blocks):
        def run(t):
            t = t.detach().requires_grad_(True)
            out = t
            for _ in range(blocks):
                out = tail(ln(_conv5(out, w5, b5)))
            return torch.autograd.grad(out.float().square().sum(), t)[0]
        return run

    # A variant's error is that of its LN + ReLU backward alone: one f32
    # input and one upstream gradient (the plain block's, at the LN's
    # output) into each, against plain autograd. The whole block's error
    # rides on bf16 noise: on the card two runs of the plain block differ
    # by a bf16 ulp of its largest gradient, cuDNN deterministic or not.
    plain = variants["autograd of plain"]
    y0 = _conv5(x, w5, b5).detach().requires_grad_(True)
    z0 = plain(y0)
    g_up, = torch.autograd.grad(tail(z0).float().square().sum(), z0)

    def ln_dx(ln):
        return torch.autograd.grad(ln(y0), y0, g_up)[0]

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    want_dx, want = ln_dx(plain), grad_of(plain, 1)(x).float()
    rerun = {"plain_rerun_err": rel(ln_dx(plain), want_dx),
             "block_plain_rerun_err": rel(grad_of(plain, 1)(x).float(), want)}
    rows = []
    for name, ln in variants.items():
        chain = grad_of(ln, k)
        ms = timed_ms(lambda: chain(x), reps, device) / k
        rows.append(_row(device, "P3", shape, torch.float32, name, ms,
                         rel(ln_dx(ln), want_dx),
                         block_err_vs_plain=rel(grad_of(ln, 1)(x).float(),
                                                want),
                         **rerun, per="one block, forward and backward",
                         err_is="max |dx - dx_plain| / max |dx_plain| of the "
                                "LN + ReLU backward; block_: of the block's "
                                "input gradient"))
    return rows


def run(device="cuda", small=False, k=None, reps=None):
    """Every probe's rows: {probe, shape, dtype, variant, ms (or host_ms on
    the CPU), max_err_vs_plain}."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card visible; pass --device cpu for the "
                           "plain versions")
    k1, k2, k3 = (k, k, k) if k else (10, 8, 6)   # the TPU probes' BENCH_K
    reps = reps or 5
    return (probe_p1(device, SMALL_P1 if small else P1_SHAPES, k1, reps)
            + probe_p2(device, SMALL_P2 if small else P2_SHAPES, k2, reps)
            + probe_p3(device, SMALL_P3 if small else P3_SHAPE, k3, reps))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true",
                    help="a few pixels per probe shape (a CPU check)")
    ap.add_argument("--k", type=int, default=None,
                    help="chain length (default 10 / 8 / 6 for P1 / P2 / P3)")
    ap.add_argument("--reps", type=int, default=None, help="default 5")
    args = ap.parse_args(argv)
    rows = run(args.device, args.small, args.k, args.reps)
    if args.device == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)}")
    for r in rows:
        t = r.get("ms", r.get("host_ms"))
        err = r.get("max_err_vs_plain")
        print(f"{r['probe']} {str(tuple(r['shape'])):22s} {r['variant']:46s} "
              f"{t:9.4f} {'ms' if 'ms' in r else 'host ms'}"
              + ("" if err is None else f"   err {err:.2e}"), flush=True)
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
