"""The generator's norms as Hopper kernels: wrappers, plain versions and
launch counts, forward and backward.

Each wrapper takes an NHWC tensor and, where a gradient is wanted, runs
through a ``torch.autograd.Function``. On a CPU tensor it computes its plain
version: the forward of ``munit_tpu_torch.core.ops`` and the closed-form
backward below, which mirrors the JAX package's rules. On a CUDA tensor it
launches the CUDA kernels of ``csrc/norms.cu`` on the current stream,
forward and backward, or raises: there is no fallback. Each forward launch adds one to
``launches[<wrapper>]``, each backward launch to ``launches[<wrapper>_bwd]``;
``bf16_launches`` counts those of them on a bf16 x.

| wrapper            | replaces                                               |
| ------------------ | ------------------------------------------------------ |
| instance_norm      | munit_tpu/kernels/norms.py _in_fwd_kernel (affine=False), tiled.py; backward _in_bwd |
| adain              | norms.py _in_fwd_kernel (affine=True), tiled.py; backward _adain_bwd |
| whole_layer_norm   | norms.py _ln_fwd_kernel; backward _ln_bwd and tools/normprobe3.py _dot_kernel |

The kernels are bound by device-memory bytes; ``csrc/norms.cu`` says how.
Every call is one kernel launch each way, in one of two designs chosen from
the shape before the launch (``choose``): instance norm and AdaIN take the
cluster design where ``cluster_plan`` finds that a (sample, channel group)
slab fits the shared memory of one thread block cluster; every other call
(IN and AdaIN at larger slabs, the whole-tensor LayerNorm always) takes the
grid design (``grid_plan``): one cooperative launch of blocks that are all
resident at once, with grid barriers between its phases. The older split
design (three kernels each way, the LayerNorm's backward four) is reached
only through the private ``split=True`` of ``_launch`` and
``_launch_backward``, to time it beside the others.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from munit_tpu_torch.core import ops
from munit_tpu_torch.kernels import build

_THREADS = 256       # threads per block, as kThreads in csrc/norms.cu
_MIN_ROWS = 8        # least rows each thread of a split reduces
_BLOCKS_PER_SM = 4
_LINE_BYTES = 128    # a cluster's channel group: one 128-byte row segment
_CLUSTER_MAX = 16    # blocks per cluster (above 8: non-portable, allowed)
# Tile bytes one block of the cluster design holds in shared memory: x
# forward, x and dy backward (kMaxDynamicSmem in csrc/norms.cu is the cap).
_CLUSTER_BUDGET = 64 * 1024
# The grid design: blocks of it an SM holds (the launch must fit them all at
# once) and the tile bytes each may keep in shared memory (x forward, x and
# dy backward; kMaxDynamicSmem in csrc/norms.cu is the cap).
_GRID_PER_SM = 1
_GRID_BUDGET = 192 * 1024

NAMES = ("instance_norm", "adain", "whole_layer_norm")
DESIGNS = ("cluster", "grid", "split")
# Launches of each wrapper's kernels since the last reset_launches(), and
# the same split by design.
launches = {k: 0 for n in NAMES for k in (n, n + "_bwd")}
design_launches = {k: {d: 0 for d in DESIGNS} for k in launches}
# Of those, the launches on a bf16 x.
bf16_launches = {k: 0 for k in launches}
# Backward calls whose incoming gradient was not contiguous NHWC and was
# copied before the kernels read it.
dy_copies = {n: 0 for n in NAMES}


def reset_launches() -> None:
    for d in (launches, bf16_launches, dy_copies,
              *design_launches.values()):
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


def _vec(c: int, itemsize: int, ptr: int) -> int:
    """Channels per 16-byte (or narrower) access: C and the base address
    (``ptr``: the OR of every tensor's address) must be multiples of it."""
    vec = 16 // itemsize
    while vec > 1 and (c % vec or ptr % (vec * itemsize)):
        vec //= 2
    return vec


def plan(b: int, hw: int, c: int, itemsize: int, ptr: int, sms: int):
    """Vector width and row split of one split-design launch: (vec, splits,
    rows).

    Each of a block's 256 threads takes vec channels (``_vec``) of every
    (256 / (C / vec))-th row. The split aims at ``_BLOCKS_PER_SM`` blocks
    per SM over the batch, with at least ``_MIN_ROWS`` rows per thread;
    every split has at least one row.
    """
    vec = _vec(c, itemsize, ptr)
    groups = c // vec
    if groups > _THREADS:
        raise ValueError(f"C={c} is too wide for one block ({_THREADS} "
                         f"threads of {vec} channels)")
    lanes = _THREADS // groups
    want = -(-_BLOCKS_PER_SM * sms // b)
    splits = max(1, min(want, hw // (lanes * _MIN_ROWS)))
    rows = -(-hw // splits)
    return vec, -(-hw // rows), rows


class ClusterPlan(NamedTuple):
    """One cluster-design launch: grid (ceil(C / cg) x k, B)."""
    vec: int    # channels per access
    cg: int     # channels per cluster: one 128-byte row segment
    k: int      # blocks per cluster; they split the H*W rows
    rows: int   # rows per block (the last block may hold fewer)
    smem: int   # dynamic shared memory per block: the tiles, bytes


def cluster_plan(b: int, hw: int, c: int, itemsize: int, ptr: int, sms: int,
                 tiles: int = 1, whole: bool = False) -> Optional[ClusterPlan]:
    """The cluster design's launch for a per-(sample, channel) norm, or
    None: for the whole-tensor LayerNorm (``whole``), which reduces over a
    whole sample, and where a (sample, channel group) slab, split over
    ``_CLUSTER_MAX`` blocks, does not fit ``_CLUSTER_BUDGET`` bytes of tiles
    per block (``tiles``: 1 forward, x; 2 backward, x and dy).

    A cluster takes cg channels (a 128-byte line: 32 f32, 64 bf16) of one
    sample; the last group of a C that cg does not divide is partial. Its k
    blocks split the H*W rows, at least as many as the budget needs, and
    aim at one block per SM over B x groups x k. Every block holds rows or,
    the last, fewer.
    """
    if whole:
        return None
    cg = _LINE_BYTES // itemsize
    max_rows = _CLUSTER_BUDGET // (tiles * _LINE_BYTES)
    k_fit = -(-hw // max_rows)
    if k_fit > _CLUSTER_MAX:
        return None
    groups = -(-c // cg)
    k = min(_CLUSTER_MAX, hw, max(k_fit, -(-sms // (b * groups))))
    rows = -(-hw // k)
    return ClusterPlan(_vec(c, itemsize, ptr), cg, -(-hw // rows), rows,
                       tiles * rows * _LINE_BYTES)


class GridPlan(NamedTuple):
    """One grid-design launch: ``blocks`` blocks, all resident at once."""
    vec: int     # channels per access
    splits: int  # segments per sample, each of contiguous rows
    rows: int    # rows per segment (the last of a sample may hold fewer)
    blocks: int  # the grid; block j takes segments j, j + blocks, ...
    res: int     # rows of a block's first segment kept in shared memory
    smem: int    # dynamic shared memory per block: the tiles, bytes


def grid_plan(b: int, hw: int, c: int, itemsize: int, ptr: int, sms: int,
              tiles: int = 1) -> Optional[GridPlan]:
    """The grid design's launch for any of the three norms, or None where C
    is too wide for one block's threads (more than 256 vectors).

    The card holds ``sms * _GRID_PER_SM`` blocks at once. Each sample's H*W
    rows are cut into ``splits`` contiguous segments, so that B x splits
    fills those blocks with at least one row per thread's lane; a segment
    is one contiguous byte range of the NHWC tensor and never straddles two
    samples. Above that many samples each block takes several whole
    samples. A block keeps the first ``res`` rows of its first segment
    on chip (``tiles``: 1 forward, x; 2 backward, x and dy), as many as
    ``_GRID_BUDGET`` bytes hold; it re-reads the rest.
    """
    vec = _vec(c, itemsize, ptr)
    groups = c // vec
    if groups > _THREADS:
        return None
    lanes = _THREADS // groups
    cap = sms * _GRID_PER_SM
    splits = max(1, min(cap // b, hw // lanes))
    rows = -(-hw // splits)
    splits = -(-hw // rows)
    res = min(rows, _GRID_BUDGET // (tiles * c * itemsize))
    return GridPlan(vec, splits, rows, min(b * splits, cap), res,
                    tiles * res * c * itemsize)


def choose(b: int, hw: int, c: int, itemsize: int, ptr: int, sms: int,
           tiles: int = 1, whole: bool = False):
    """The plan of one call: a ClusterPlan, else a GridPlan; raises where
    neither design takes the shape."""
    cp = cluster_plan(b, hw, c, itemsize, ptr, sms, tiles, whole)
    if cp is not None:
        return cp
    gp = grid_plan(b, hw, c, itemsize, ptr, sms, tiles)
    if gp is None:
        raise ValueError(f"C={c} is too wide for one block ({_THREADS} "
                         f"threads of {_vec(c, itemsize, ptr)} channels)")
    return gp


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
    lib.munit_norm_cluster_forward.argtypes = [p, p, p, p, ll, p, ll, i, i, i,
                                               i, i, i, i, i, i,
                                               ctypes.c_float, p]
    lib.munit_norm_cluster_forward.restype = i
    lib.munit_norm_cluster_backward.argtypes = [p, p, p, p, p, ll, p, ll, p,
                                                i, i, i, i, i, i, i, i, i, p]
    lib.munit_norm_cluster_backward.restype = i
    lib.munit_norm_cluster_occupancy.argtypes = [i, i, i, i, i, i, i,
                                                 ctypes.POINTER(i)]
    lib.munit_norm_cluster_occupancy.restype = i
    lib.munit_norm_grid_forward.argtypes = [p, p, p, p, p, p, ll, p, ll, i, i,
                                            i, i, i, i, i, i, i, i, i, i,
                                            ctypes.c_float, p]
    lib.munit_norm_grid_forward.restype = i
    lib.munit_norm_grid_backward.argtypes = [p, p, p, p, p, ll, p, ll, p, p,
                                             p, p, p, i, i, i, i, i, i, i, i,
                                             i, i, i, i, p]
    lib.munit_norm_grid_backward.restype = i
    lib.munit_norm_grid_occupancy.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.munit_norm_grid_occupancy.restype = i
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


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _plan_of(x, ptr, tiles, whole, split):
    b, h, w, c = x.shape
    args = (b, h * w, c, x.element_size(), ptr, _sm_count(x.device.index))
    return plan(*args) if split else choose(*args, tiles, whole)


def _launch(name, x, gamma, beta, relu, whole, split=False):
    """Forward kernel: (y, stats), stats (B, 3, C) f32 per (sample, channel)
    mean, r and std for the backward. ``split`` forces the split design
    (three kernels) instead of the plan's: only for comparing them."""
    _check_x(name, x)
    b, h, w, c = x.shape
    lib = _lib()
    g, gs = _affine_arg(gamma, x)
    bt, bs = _affine_arg(beta, x)
    y = torch.empty_like(x)
    stats = torch.empty((b, 3, c), dtype=torch.float32, device=x.device)
    bf16 = int(x.dtype == torch.bfloat16)
    p = _plan_of(x, x.data_ptr() | y.data_ptr(), 1, whole, split)
    f32 = dict(dtype=torch.float32, device=x.device)
    common = (_ptr(g), gs, _ptr(bt), bs, b, h * w, c)
    with torch.cuda.device(x.device):
        if isinstance(p, ClusterPlan):
            design = "cluster"
            err = lib.munit_norm_cluster_forward(
                x.data_ptr(), y.data_ptr(), stats.data_ptr(), *common, p.k,
                p.rows, p.smem, bf16, p.vec, int(relu), ops.EPS, _stream(x))
        elif isinstance(p, GridPlan):
            design = "grid"
            part = torch.empty((b * p.splits, 2, 1 if whole else c), **f32)
            coef = None if whole else torch.empty((b, 3, c), **f32)
            err = lib.munit_norm_grid_forward(
                x.data_ptr(), y.data_ptr(), part.data_ptr(), _ptr(coef),
                stats.data_ptr(), *common, p.splits, p.rows, p.res,
                p.blocks, p.smem, bf16, p.vec, int(whole), int(relu),
                ops.EPS, _stream(x))
        else:
            design = "split"
            vec, splits, rows = p
            part = torch.empty((b, splits, 2, 1 if whole else c), **f32)
            coef = torch.empty((b, 3, c), **f32)
            err = lib.munit_norm_forward(
                x.data_ptr(), y.data_ptr(), part.data_ptr(), coef.data_ptr(),
                stats.data_ptr(), *common, splits, rows, bf16, vec,
                int(whole), int(relu), ops.EPS, _stream(x))
    _raise_on(name, lib, err)
    launches[name] += 1
    bf16_launches[name] += bf16
    design_launches[name][design] += 1
    return y, stats


def _launch_backward(name, x, stats, gamma, beta, dy, relu, whole,
                     split=False):
    """Backward kernel: (dx, dgamma, dbeta); the affine grads are None for
    the instance norm. ``split`` as in ``_launch``."""
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
    bf16 = int(x.dtype == torch.bfloat16)
    f32 = dict(dtype=torch.float32, device=x.device)
    p = _plan_of(x, x.data_ptr() | dy.data_ptr() | dx.data_ptr(), 2, whole,
                 split)
    # A, B per (sample, channel): AdaIN's dbeta, dgamma (and the split
    # design's scratch); the LN's are summed over the batch into (C,)
    red = (torch.empty((b, 2, c), **f32)
           if (gamma is not None and not whole) or split else None)
    dgamma = dbeta = None
    if whole:
        dgamma = torch.empty((c,), **f32)
        dbeta = torch.empty((c,), **f32)
    common = (x.data_ptr(), dy.data_ptr(), dx.data_ptr(), stats.data_ptr(),
              _ptr(g), gs, _ptr(bt), bs)
    with torch.cuda.device(x.device):
        if isinstance(p, ClusterPlan):
            design = "cluster"
            err = lib.munit_norm_cluster_backward(
                *common, _ptr(red), b, h * w, c, p.k, p.rows, p.smem, bf16,
                p.vec, int(relu), _stream(x))
        elif isinstance(p, GridPlan):
            design = "grid"
            part = torch.empty((b * p.splits, 2, c + 1), **f32)
            bcoef = None if whole else torch.empty((b, 3, c), **f32)
            err = lib.munit_norm_grid_backward(
                *common, part.data_ptr(), _ptr(red), _ptr(bcoef),
                _ptr(dgamma), _ptr(dbeta), b, h * w, c, p.splits, p.rows,
                p.res, p.blocks, p.smem, bf16, p.vec, int(whole), int(relu),
                _stream(x))
        else:
            design = "split"
            vec, splits, rows = p
            part = torch.empty((b, splits, 2, c), **f32)
            bcoef = torch.empty((b, 3, c), **f32)
            err = lib.munit_norm_backward(
                *common, part.data_ptr(), red.data_ptr(), bcoef.data_ptr(),
                _ptr(dgamma), _ptr(dbeta), b, h * w, c, splits, rows, bf16,
                vec, int(whole), int(relu), _stream(x))
    _raise_on(name, lib, err)
    launches[name + "_bwd"] += 1
    bf16_launches[name + "_bwd"] += bf16
    design_launches[name + "_bwd"][design] += 1
    if gamma is None:
        return dx, None, None
    if not whole:
        dgamma, dbeta = red[:, 1], red[:, 0]
    return dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype)


def cluster_occupancy(x, backward: bool) -> Optional[int]:
    """Clusters of the cluster design's kernel at x's launch shape that the
    card holds at once (cudaOccupancyMaxActiveClusters); None where the
    plan sends x to the grid design."""
    b, h, w, c = x.shape
    cp = cluster_plan(b, h * w, c, x.element_size(), x.data_ptr(),
                      _sm_count(x.device.index), tiles=2 if backward else 1)
    if cp is None:
        return None
    lib = _lib()
    out = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        err = lib.munit_norm_cluster_occupancy(
            int(backward), b, c, cp.k, cp.smem,
            int(x.dtype == torch.bfloat16), cp.vec, ctypes.byref(out))
    _raise_on("cluster_occupancy", lib, err)
    return out.value


def grid_occupancy(x, backward: bool, whole: bool = False) -> Optional[int]:
    """Blocks of the grid design's kernel at x's plan that one SM holds at
    once (cudaOccupancyMaxActiveBlocksPerMultiprocessor); None where the
    plan sends x to the cluster design."""
    b, h, w, c = x.shape
    p = choose(b, h * w, c, x.element_size(), x.data_ptr(),
               _sm_count(x.device.index), 2 if backward else 1, whole)
    if not isinstance(p, GridPlan):
        return None
    lib = _lib()
    out = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        err = lib.munit_norm_grid_occupancy(
            int(backward), p.smem, int(x.dtype == torch.bfloat16), p.vec,
            ctypes.byref(out))
    _raise_on("grid_occupancy", lib, err)
    return out.value


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
