"""Per-sample moments and the per-sample affine of the whole-tensor
LayerNorm as Hopper kernels: wrappers, plain versions and launch counts.

| wrapper        | replaces (the whole-LN probes' Pallas kernels)             |
| -------------- | ---------------------------------------------------------- |
| sample_sums    | tools/normprobe.py _stats_kernel (P1a), normprobe2.py and  |
|                | normprobe3.py _stats_kernel (P2, P3a)                      |
| sample_affine  | tools/normprobe.py _apply_kernel (P1b)                     |

``sample_sums(a, b=None)`` gives per sample (Σa, Σa·b) in float32, b = a
when omitted (Σa, Σa²: the moments); ``sample_affine`` computes
(x − mean)·inv·γ + β (+ReLU) with per-sample mean and inv and per-channel
γ, β. ``ln_coefficients`` turns the moments into the fork's LayerNorm
statistics (unbiased std, eps on the std) as the TPU probes do
(E[x²] − mean², clamped at 0). Tensors are contiguous NHWC, float32 or
bfloat16.

On a CPU tensor a wrapper computes its plain version; on a CUDA tensor it
launches the kernels of ``csrc/moments.cu`` on the current stream or raises:
there is no fallback. Each launch adds one to ``launches[<wrapper>]``. The
kernels are bound by device-memory bytes; the source says how.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from munit_tpu_torch.core import ops
from munit_tpu_torch.kernels import build

_THREADS = 256          # threads per block, as kThreads in csrc/moments.cu
_MIN_VECTORS = 8        # least 16-byte vectors each thread of a block reads
_BLOCKS_PER_SM = 4
MAX_CHANNELS = 1024     # kMaxChannels: gamma and beta in shared memory

NAMES = ("sample_sums", "sample_affine")
# Launches of each wrapper's kernels since the last reset_launches().
launches = {n: 0 for n in NAMES}


def counter_dicts() -> tuple:
    """The dicts of counts: ``train/graphs.py`` adds a captured step's to
    them on every replay, as in ``norms.counter_dicts``."""
    return (launches,)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# --------------------------------------------------------------- plain forms


def sample_sums_plain(a: torch.Tensor, b: torch.Tensor | None = None):
    """(B, 2) float32: per sample Σa and Σa·b (Σa² without b)."""
    af = ops.upcast_f32(a).flatten(1)
    bf = af if b is None else ops.upcast_f32(b).flatten(1)
    return torch.stack([af.sum(1), (af * bf).sum(1)], dim=1)


def sample_affine_plain(x, mean, inv, gamma, beta, relu=False):
    """(x − mean[b])·inv[b]·γ[c] + β[c] (+ReLU) in float32, in x's type."""
    t = (ops.upcast_f32(x) - mean[:, None, None, None]) * inv[:, None, None, None]
    t = t * gamma + beta
    return (torch.relu(t) if relu else t).to(x.dtype)


def ln_coefficients(sums: torch.Tensor, n: int, eps: float = ops.EPS):
    """(mean, inv, std), each (B,), of the fork's whole-tensor LayerNorm
    from the per-sample moments of n values: var = max(E[x²] − mean², 0),
    std = sqrt(var · n / (n − 1)), inv = 1 / (std + eps), as the TPU
    probes compute them (tools/normprobe.py:117-121)."""
    mean = sums[:, 0] / n
    var = torch.clamp(sums[:, 1] / n - mean * mean, min=0.0)
    std = torch.sqrt(var * (n / (n - 1)))
    return mean, 1.0 / (std + eps), std


def whole_layer_norm(x, gamma, beta, relu=False):
    """The whole-tensor LayerNorm (+ReLU) in two kernels: the one-pass
    moments of ``sample_sums``, then ``sample_affine`` (the probes' v3)."""
    n = x.shape[1] * x.shape[2] * x.shape[3]
    mean, inv, _ = ln_coefficients(sample_sums(x), n)
    return sample_affine(x, mean, inv, gamma, beta, relu)


# ------------------------------------------------------------------- launch


def plan(b: int, n: int, itemsize: int, ptr: int, sms: int,
         c: int | None = None):
    """(vec, splits, chunk) of one launch: vec elements per 16-byte (or
    narrower) access, so n, the base address (``ptr``: the OR of every
    tensor's address) and, where a vector must not wrap a row of channels
    (the apply), c are multiples of it; each sample is cut into ``splits``
    contiguous chunks of ``chunk`` elements (a multiple of vec), aiming at
    ``_BLOCKS_PER_SM`` blocks per SM over the batch with at least
    ``_MIN_VECTORS`` vectors per thread."""
    vec = 16 // itemsize
    while vec > 1 and (n % vec or (c is not None and c % vec)
                       or ptr % (vec * itemsize)):
        vec //= 2
    want = -(-_BLOCKS_PER_SM * sms // b)
    splits = max(1, min(want, n // (_THREADS * vec * _MIN_VECTORS)))
    chunk = -(-n // splits)
    chunk = -(-chunk // vec) * vec
    return vec, -(-n // chunk), chunk


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("moments")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.munit_sample_sums.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.munit_sample_sums.restype = i
    lib.munit_sample_affine.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                        i, i, p]
    lib.munit_sample_affine.restype = i
    lib.munit_moments_error_string.argtypes = [i]
    lib.munit_moments_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name, x):
    if x.dim() != 4:
        raise ValueError(f"{name}: expected NHWC (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for a tensor on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NHWC tensor")
    if x[0].numel() > 2**30:
        raise ValueError(f"{name}: a sample of {x[0].numel()} values is "
                         "beyond the kernels' 32-bit indices")


def _f32_vector(name, t, length, device):
    if tuple(t.shape) != (length,) or t.device != device:
        raise ValueError(f"{name} must be ({length},) on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.detach().float().contiguous()


def _raise_on(name, lib, err):
    if err:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.munit_moments_error_string(err).decode()}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


# ----------------------------------------------------------------- wrappers


def sample_sums(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """(B, 2) float32: per sample Σa and Σa·b (Σa² without b) of NHWC
    tensors of one shape and type."""
    if a.device.type == "cpu":
        return sample_sums_plain(a, b)
    _check("sample_sums", a)
    if b is not None:
        _check("sample_sums", b)
        if b.shape != a.shape or b.dtype != a.dtype or b.device != a.device:
            raise ValueError("sample_sums: b must match a's shape, type and "
                             "device")
    lib = _lib()
    nb, n = a.shape[0], a[0].numel()
    ptr = a.data_ptr() | (0 if b is None else b.data_ptr())
    vec, splits, chunk = plan(nb, n, a.element_size(), ptr,
                              _sm_count(a.device.index))
    f32 = dict(dtype=torch.float32, device=a.device)
    part = torch.empty((nb, splits, 2), **f32)
    sums = torch.empty((nb, 2), **f32)
    with torch.cuda.device(a.device):
        err = lib.munit_sample_sums(
            a.data_ptr(), None if b is None else b.data_ptr(),
            part.data_ptr(), sums.data_ptr(), nb, n, splits, chunk,
            int(a.dtype == torch.bfloat16), vec, _stream(a))
    _raise_on("sample_sums", lib, err)
    launches["sample_sums"] += 1
    return sums


def sample_affine(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                  gamma: torch.Tensor, beta: torch.Tensor,
                  relu: bool = False) -> torch.Tensor:
    """(x − mean[b])·inv[b]·γ[c] + β[c] (+ReLU), in x's type; mean, inv
    (B,), gamma, beta (C,)."""
    if x.device.type == "cpu":
        return sample_affine_plain(x, mean, inv, gamma, beta, relu)
    _check("sample_affine", x)
    nb, c = x.shape[0], x.shape[3]
    if c > MAX_CHANNELS:
        raise ValueError(f"sample_affine: C={c} > {MAX_CHANNELS}")
    mean, inv = (_f32_vector(k, t, nb, x.device)
                 for k, t in (("mean", mean), ("inv", inv)))
    gamma, beta = (_f32_vector(k, t, c, x.device)
                   for k, t in (("gamma", gamma), ("beta", beta)))
    lib = _lib()
    y = torch.empty_like(x)
    n = x[0].numel()
    vec, splits, chunk = plan(nb, n, x.element_size(),
                              x.data_ptr() | y.data_ptr(),
                              _sm_count(x.device.index), c)
    with torch.cuda.device(x.device):
        err = lib.munit_sample_affine(
            x.data_ptr(), y.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), nb, n, c, splits, chunk,
            int(x.dtype == torch.bfloat16), vec, int(relu), _stream(x))
    _raise_on("sample_affine", lib, err)
    launches["sample_affine"] += 1
    return y
