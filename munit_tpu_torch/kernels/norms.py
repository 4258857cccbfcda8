"""The generator's norms as Hopper kernels: wrappers, plain versions and
launch counts.

Each wrapper takes an NHWC tensor. On a CPU tensor it computes its plain
version (``munit_tpu_torch.core.ops``). On a CUDA tensor it launches the CUDA
kernels of ``csrc/norms.cu`` on the current stream, or raises: there is no
fallback. Each launch adds one to ``launches[<wrapper>]``.

| wrapper            | replaces (munit_tpu/kernels)                        |
| ------------------ | --------------------------------------------------- |
| instance_norm      | norms.py _in_fwd_kernel (affine=False); tiled.py    |
| adain              | norms.py _in_fwd_kernel (affine=True); tiled.py     |
| whole_layer_norm   | norms.py _ln_fwd_kernel                             |

The kernels are bound by device-memory bytes; ``csrc/norms.cu`` says how.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from munit_tpu_torch.core import ops
from munit_tpu_torch.kernels import build

_THREADS = 256       # threads per block, as kThreads in csrc/norms.cu
_MIN_ROWS = 8        # least rows each thread of a split reduces
_BLOCKS_PER_SM = 4

# Launches of each wrapper's kernels since the last reset_launches().
launches = {"instance_norm": 0, "adain": 0, "whole_layer_norm": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# --------------------------------------------------------------- plain forms


def _relu(y: torch.Tensor, relu: bool) -> torch.Tensor:
    return F.relu(y) if relu else y


def instance_norm_plain(x, relu=False):
    return _relu(ops.instance_norm(x), relu)


def adain_plain(x, gamma, beta, relu=False):
    return _relu(ops.adain(x, gamma, beta), relu)


def whole_layer_norm_plain(x, gamma, beta, relu=False):
    return _relu(ops.whole_layer_norm(x, gamma, beta), relu)


# ------------------------------------------------------------------- launch


def plan(b: int, hw: int, c: int, itemsize: int, ptr: int, sms: int):
    """Vector width and row split of one launch: (vec, splits, rows).

    vec channels move per 16-byte (or narrower) access, so C and the base
    address must be multiples of it. Each of a block's 256 threads takes
    vec channels of every (256 / (C / vec))-th row. The split aims at
    ``_BLOCKS_PER_SM`` blocks per SM over the batch, with at least
    ``_MIN_ROWS`` rows per thread; every split has at least one row.
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
    lib.munit_norm_forward.argtypes = [p, p, p, p, p, ll, p, ll, i, i, i, i,
                                       i, i, i, i, i, ctypes.c_float, p]
    lib.munit_norm_forward.restype = i
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
    t = t.float()
    if t.stride(-1) != 1:
        t = t.contiguous()
    return t, (t.stride(0) if t.dim() == 2 else 0)


def _launch(name, x, gamma, beta, relu, whole):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for a tensor on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NHWC tensor")
    b, h, w, c = x.shape
    lib = _lib()
    g, gs = _affine_arg(gamma, x)
    bt, bs = _affine_arg(beta, x)
    vec, splits, rows = plan(b, h * w, c, x.element_size(), x.data_ptr(),
                             _sm_count(x.device.index))
    y = torch.empty_like(x)
    part = torch.empty((b, splits, 2, 1 if whole else c), dtype=torch.float32,
                       device=x.device)
    coef = torch.empty((b, 3, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.munit_norm_forward(
            x.data_ptr(), y.data_ptr(), part.data_ptr(), coef.data_ptr(),
            None if g is None else g.data_ptr(), gs,
            None if bt is None else bt.data_ptr(), bs,
            b, h * w, c, splits, rows, int(x.dtype == torch.bfloat16), vec,
            int(whole), int(relu), ops.EPS,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.munit_error_string(err).decode()}")
    launches[name] += 1
    return y


# ----------------------------------------------------------------- wrappers


def instance_norm(x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """Affine-less instance norm (+ReLU) of an NHWC tensor."""
    _check_shapes(x, None, None, True)
    if x.device.type == "cpu":
        return instance_norm_plain(x, relu)
    return _launch("instance_norm", x, None, None, relu, whole=False)


def adain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
          relu: bool = False) -> torch.Tensor:
    """AdaIN (+ReLU): instance norm, then gamma, beta (B, C) per sample."""
    _check_shapes(x, gamma, beta, True)
    if x.device.type == "cpu":
        return adain_plain(x, gamma, beta, relu)
    return _launch("adain", x, gamma, beta, relu, whole=False)


def whole_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     relu: bool = False) -> torch.Tensor:
    """The fork's whole-tensor LayerNorm (+ReLU); gamma, beta (C,)."""
    _check_shapes(x, gamma, beta, False)
    if x.device.type == "cpu":
        return whole_layer_norm_plain(x, gamma, beta, relu)
    return _launch("whole_layer_norm", x, gamma, beta, relu, whole=True)
