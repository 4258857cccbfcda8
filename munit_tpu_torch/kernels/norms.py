"""The generator's norms as Hopper kernels: wrappers, plain versions and
launch counts, forward and backward.

Each wrapper takes an NHWC tensor and, where a gradient is wanted, runs
through a ``torch.autograd.Function``. On a CPU tensor it computes its plain
version: the forward of ``munit_tpu_torch.core.ops`` and the closed-form
backward below, which mirrors the JAX package's rules. On a CUDA tensor it
launches the CUDA kernels of ``csrc/norms.cu`` on the current stream,
forward and backward, or raises: there is no fallback. Each forward launch adds one to
``launches[<wrapper>]``, each backward launch to ``launches[<wrapper>_bwd]``.

| wrapper            | replaces                                               |
| ------------------ | ------------------------------------------------------ |
| instance_norm      | munit_tpu/kernels/norms.py _in_fwd_kernel (affine=False), tiled.py; backward _in_bwd |
| adain              | norms.py _in_fwd_kernel (affine=True), tiled.py; backward _adain_bwd |
| whole_layer_norm   | norms.py _ln_fwd_kernel; backward _ln_bwd and tools/normprobe3.py _dot_kernel |

The kernels are bound by device-memory bytes; ``csrc/norms.cu`` says how.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from munit_tpu_torch.core import ops
from munit_tpu_torch.kernels import build

_THREADS = 256       # threads per block, as kThreads in csrc/norms.cu
_MIN_ROWS = 8        # least rows each thread of a split reduces
_BLOCKS_PER_SM = 4

NAMES = ("instance_norm", "adain", "whole_layer_norm")
# Launches of each wrapper's kernels since the last reset_launches().
launches = {k: 0 for n in NAMES for k in (n, n + "_bwd")}
# Backward calls whose incoming gradient was not contiguous NHWC and was
# copied before the kernels read it.
dy_copies = {n: 0 for n in NAMES}


def reset_launches() -> None:
    for d in (launches, dy_copies):
        for k in d:
            d[k] = 0


# --------------------------------------------------------------- plain forms


def _relu(y: torch.Tensor, relu: bool) -> torch.Tensor:
    return F.relu(y) if relu else y


def instance_norm_plain(x, relu=False):
    return _relu(ops.instance_norm(x), relu)


def adain_plain(x, gamma, beta, relu=False):
    return _relu(ops.adain(x, gamma, beta), relu)


def whole_layer_norm_plain(x, gamma, beta, relu=False):
    return _relu(ops.whole_layer_norm(x, gamma, beta), relu)


def _in_grads(x, g, b, dy, relu, eps=ops.EPS):
    """dx, dgamma, dbeta of (Ada)IN(+ReLU), stats recomputed two-pass; g, b
    (B, C) or None (IN). ``_adain_bwd`` / ``_in_bwd`` of the JAX package."""
    xf = ops.upcast_f32(x)
    mean = xf.mean(dim=(1, 2), keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(dim=(1, 2), keepdim=True)
                       + eps)
    xhat = (xf - mean) * rstd
    gf = 1.0 if g is None else ops.upcast_f32(g)[:, None, None, :]
    dyf = ops.upcast_f32(dy)
    if relu:
        fwd = xhat if g is None else xhat * gf + ops.upcast_f32(b)[:, None, None, :]
        dyf = torch.where(fwd > 0, dyf, torch.zeros_like(dyf))
    dgamma = (dyf * xhat).sum(dim=(1, 2))
    dbeta = dyf.sum(dim=(1, 2))
    dyg = dyf * gf
    m1 = dyg.mean(dim=(1, 2), keepdim=True)
    m2 = (dyg * xhat).mean(dim=(1, 2), keepdim=True)
    dx = ((dyg - m1 - xhat * m2) * rstd).to(x.dtype)
    return dx, dgamma, dbeta


def instance_norm_backward_plain(x, dy, relu=False):
    """dx of ``instance_norm_plain`` (``_in_bwd``)."""
    return _in_grads(x, None, None, dy, relu)[0]


def adain_backward_plain(x, gamma, beta, dy, relu=False):
    """(dx, dgamma, dbeta) of ``adain_plain`` (``_adain_bwd``)."""
    dx, dg, db = _in_grads(x, gamma, beta, dy, relu)
    return dx, dg.to(gamma.dtype), db.to(beta.dtype)


def whole_layer_norm_backward_plain(x, gamma, beta, dy, relu=False,
                                    eps=ops.EPS):
    """(dx, dgamma, dbeta) of ``whole_layer_norm_plain`` in closed form (the
    vjp of ``ops.whole_layer_norm`` that ``_ln_bwd`` takes). With
    yh = (x - mean) / d, d = std + eps, n = H W C and g = gamma * dy':
    dx = g / d - sum(g) / (n d) - yh sum(g yh) / ((n - 1) std)."""
    xf = ops.upcast_f32(x)
    n = x.shape[1] * x.shape[2] * x.shape[3]
    mean = xf.mean(dim=(1, 2, 3), keepdim=True)
    dev = xf - mean
    std = torch.sqrt(dev.square().mean(dim=(1, 2, 3), keepdim=True)
                     * (n / (n - 1)))
    d = std + eps
    yhat = dev / d
    gf, bf = ops.upcast_f32(gamma), ops.upcast_f32(beta)
    dyf = ops.upcast_f32(dy)
    if relu:
        dyf = torch.where(yhat * gf + bf > 0, dyf, torch.zeros_like(dyf))
    dgamma = (dyf * yhat).sum(dim=(0, 1, 2)).to(gamma.dtype)
    dbeta = dyf.sum(dim=(0, 1, 2)).to(beta.dtype)
    g = dyf * gf
    s1 = g.sum(dim=(1, 2, 3), keepdim=True)
    s2 = (g * yhat).sum(dim=(1, 2, 3), keepdim=True)
    dx = g / d - s1 / (n * d) - yhat * s2 / ((n - 1) * std)
    return dx.to(x.dtype), dgamma, dbeta


def _plain_forward(name, x, gamma, beta, relu):
    if name == "instance_norm":
        return instance_norm_plain(x, relu)
    if name == "adain":
        return adain_plain(x, gamma, beta, relu)
    return whole_layer_norm_plain(x, gamma, beta, relu)


def _plain_backward(name, x, gamma, beta, dy, relu):
    if name == "instance_norm":
        return instance_norm_backward_plain(x, dy, relu), None, None
    if name == "adain":
        return adain_backward_plain(x, gamma, beta, dy, relu)
    return whole_layer_norm_backward_plain(x, gamma, beta, dy, relu)


# ------------------------------------------------------------------- launch


def plan(b: int, hw: int, c: int, itemsize: int, ptr: int, sms: int):
    """Vector width and row split of one launch: (vec, splits, rows).

    vec channels move per 16-byte (or narrower) access, so C and the base
    address (``ptr``: the OR of every tensor's address) must be multiples of
    it. Each of a block's 256 threads takes vec channels of every
    (256 / (C / vec))-th row. The split aims at ``_BLOCKS_PER_SM`` blocks
    per SM over the batch, with at least ``_MIN_ROWS`` rows per thread;
    every split has at least one row.
    """
    vec = 16 // itemsize
    while vec > 1 and (c % vec or ptr % (vec * itemsize)):
        vec //= 2
    groups = c // vec
    if groups > _THREADS:
        raise ValueError(f"C={c} is too wide for one block ({_THREADS} "
                         f"threads of {vec} channels)")
    lanes = _THREADS // groups
    want = -(-_BLOCKS_PER_SM * sms // b)
    splits = max(1, min(want, hw // (lanes * _MIN_ROWS)))
    rows = -(-hw // splits)
    return vec, -(-hw // rows), rows


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("norms")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.munit_norm_forward.argtypes = [p, p, p, p, p, p, ll, p, ll, i, i, i,
                                       i, i, i, i, i, i, ctypes.c_float, p]
    lib.munit_norm_forward.restype = i
    lib.munit_norm_backward.argtypes = [p, p, p, p, p, ll, p, ll, p, p, p, p,
                                        p, i, i, i, i, i, i, i, i, i, p]
    lib.munit_norm_backward.restype = i
    lib.munit_error_string.argtypes = [i]
    lib.munit_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_shapes(x, gamma, beta, per_sample: bool):
    if x.dim() != 4:
        raise ValueError(f"expected NHWC (B, H, W, C), got {tuple(x.shape)}")
    if gamma is None:
        return
    b, _, _, c = x.shape
    want = (b, c) if per_sample else (c,)
    for name, t in (("gamma", gamma), ("beta", beta)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")


def _affine_arg(t, x):
    """(tensor, stride between samples) of an f32 row with unit C stride."""
    if t is None:
        return None, 0
    if t.device != x.device:
        raise ValueError(f"affine on {t.device}, x on {x.device}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"affine dtype must be float32 or bfloat16, got {t.dtype}")
    t = t.detach().float()
    if t.stride(-1) != 1:
        t = t.contiguous()
    return t, (t.stride(0) if t.dim() == 2 else 0)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_x(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for a tensor on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NHWC tensor")


def _raise_on(name, lib, err):
    if err:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.munit_error_string(err).decode()}")


def _launch(name, x, gamma, beta, relu, whole):
    """Forward kernels: (y, stats), stats (B, 3, C) f32 per (sample, channel)
    mean, r and std for the backward."""
    _check_x(name, x)
    b, h, w, c = x.shape
    lib = _lib()
    g, gs = _affine_arg(gamma, x)
    bt, bs = _affine_arg(beta, x)
    y = torch.empty_like(x)
    vec, splits, rows = plan(b, h * w, c, x.element_size(),
                             x.data_ptr() | y.data_ptr(),
                             _sm_count(x.device.index))
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty((b, splits, 2, 1 if whole else c), **f32)
    coef = torch.empty((b, 3, c), **f32)
    stats = torch.empty((b, 3, c), **f32)
    with torch.cuda.device(x.device):
        err = lib.munit_norm_forward(
            x.data_ptr(), y.data_ptr(), part.data_ptr(), coef.data_ptr(),
            stats.data_ptr(), _ptr(g), gs, _ptr(bt), bs,
            b, h * w, c, splits, rows, int(x.dtype == torch.bfloat16), vec,
            int(whole), int(relu), ops.EPS,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(name, lib, err)
    launches[name] += 1
    return y, stats


def _launch_backward(name, x, stats, gamma, beta, dy, relu, whole):
    """Backward kernels: (dx, dgamma, dbeta); the affine grads are None for
    the instance norm."""
    _check_x(name, x)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} on {dy.device} does "
                         f"not match x {tuple(x.shape)} on {x.device}")
    dy = dy.to(x.dtype)
    if not dy.is_contiguous():
        # the kernels read contiguous NHWC rows only; counted, never misread
        dy = dy.contiguous()
        dy_copies[name] += 1
    b, h, w, c = x.shape
    lib = _lib()
    g, gs = _affine_arg(gamma, x)
    bt, bs = _affine_arg(beta, x)
    dx = torch.empty_like(x)
    vec, splits, rows = plan(b, h * w, c, x.element_size(),
                             x.data_ptr() | dy.data_ptr() | dx.data_ptr(),
                             _sm_count(x.device.index))
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty((b, splits, 2, c), **f32)
    red = torch.empty((b, 2, c), **f32)
    bcoef = torch.empty((b, 3, c), **f32)
    dgamma = torch.empty((c,), **f32) if whole else None
    dbeta = torch.empty((c,), **f32) if whole else None
    with torch.cuda.device(x.device):
        err = lib.munit_norm_backward(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), stats.data_ptr(),
            _ptr(g), gs, _ptr(bt), bs, part.data_ptr(), red.data_ptr(),
            bcoef.data_ptr(), _ptr(dgamma), _ptr(dbeta),
            b, h * w, c, splits, rows, int(x.dtype == torch.bfloat16), vec,
            int(whole), int(relu),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(name, lib, err)
    launches[name + "_bwd"] += 1
    if gamma is None:
        return dx, None, None
    if not whole:
        dgamma, dbeta = red[:, 1], red[:, 0]
    return dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype)


def _forward(name, x, gamma, beta, relu):
    """(y, stats): the plain forward on a CPU tensor (stats None), the
    kernels on a CUDA tensor."""
    if x.device.type == "cpu":
        return _plain_forward(name, x, gamma, beta, relu), None
    return _launch(name, x, gamma, beta, relu, whole=name == "whole_layer_norm")


class _Norm(torch.autograd.Function):
    """One norm (+ReLU) with its gradient: the plain forms on a CPU tensor,
    the kernels on a CUDA tensor."""

    @staticmethod
    def forward(ctx, name, x, gamma, beta, relu):
        y, stats = _forward(name, x, gamma, beta, relu)
        ctx.name, ctx.relu = name, relu
        ctx.save_for_backward(x, gamma, beta, stats)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, gamma, beta, stats = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = _plain_backward(ctx.name, x, gamma, beta, dy, ctx.relu)
        else:
            grads = _launch_backward(ctx.name, x, stats, gamma, beta, dy,
                                     ctx.relu,
                                     whole=ctx.name == "whole_layer_norm")
        return (None, *grads, None)


def _apply(name, x, gamma, beta, relu):
    """Through the autograd Function where a gradient is wanted; otherwise
    (serving, no_grad) the forward alone, without the Function's host
    bookkeeping on every call."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, gamma, beta)):
        return _Norm.apply(name, x, gamma, beta, relu)
    return _forward(name, x, gamma, beta, relu)[0]


# ----------------------------------------------------------------- wrappers


def instance_norm(x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """Affine-less instance norm (+ReLU) of an NHWC tensor."""
    _check_shapes(x, None, None, True)
    return _apply("instance_norm", x, None, None, relu)


def adain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
          relu: bool = False) -> torch.Tensor:
    """AdaIN (+ReLU): instance norm, then gamma, beta (B, C) per sample."""
    _check_shapes(x, gamma, beta, True)
    return _apply("adain", x, gamma, beta, relu)


def whole_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     relu: bool = False) -> torch.Tensor:
    """The fork's whole-tensor LayerNorm (+ReLU); gamma, beta (C,)."""
    _check_shapes(x, gamma, beta, False)
    return _apply("whole_layer_norm", x, gamma, beta, relu)
