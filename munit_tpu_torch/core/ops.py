"""Plain PyTorch ops of the generator, on NHWC tensors.

Counterparts of ``munit_tpu/core/ops.py`` in plain math: no space-to-depth,
lane packing or int8 rewrites. Tensors are NHWC as in the JAX package; a
convolution views its input as channels-last NCHW (the same bytes) for
``F.conv2d`` and hands back NHWC.

``instance_norm``, ``adain`` and ``whole_layer_norm`` are the plain versions
of the Hopper kernels in ``munit_tpu_torch/kernels``: the kernels' wrappers
use them for tensors on the CPU, and the tests and ``chip_smoke.py`` hold the
kernels against them. Statistics are two-pass in (at least) float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5


def pad2d(x: torch.Tensor, padding: int, mode: str) -> torch.Tensor:
    """Spatially pad an NHWC tensor.

    mode: 'reflect' | 'replicate' | 'zero' (networks.py:641-649). The
    reflect and replicate pads run as 3-D pads of the (B, 1, H, W, C) view
    with no pad on C, so the result is a contiguous NHWC tensor.
    """
    if padding == 0:
        return x
    p = padding
    if mode == "zero":
        return F.pad(x, (0, 0, p, p, p, p))
    if mode not in ("reflect", "replicate"):
        raise ValueError(f"Unsupported padding type: {mode}")
    return F.pad(x.unsqueeze(1), (0, 0, p, p, p, p), mode=mode).squeeze(1)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, stride: int = 1) -> torch.Tensor:
    """VALID conv over an already-padded NHWC input; weight is OIHW."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride)
    return y.permute(0, 2, 3, 1).contiguous()


def upcast_f32(x: torch.Tensor) -> torch.Tensor:
    """Cast to at least float32: bf16 statistics compute in f32, float64
    passes through."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _moments(xf: torch.Tensor, dims) -> tuple:
    """Two-pass mean and biased variance."""
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    return mean, var


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Affine-less instance norm over H, W per (sample, channel); biased
    variance, eps inside the rsqrt (nn.InstanceNorm2d defaults). x: NHWC."""
    xf = upcast_f32(x)
    mean, var = _moments(xf, (1, 2))
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def adain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
          eps: float = EPS) -> torch.Tensor:
    """Adaptive instance norm: instance-normalize, then scale and shift per
    sample. gamma, beta: (B, C) from the style MLP (networks.py:823-845)."""
    xf = upcast_f32(x)
    mean, var = _moments(xf, (1, 2))
    y = (xf - mean) * torch.rsqrt(var + eps)
    g = upcast_f32(gamma)[:, None, None, :]
    b = upcast_f32(beta)[:, None, None, :]
    return (y * g + b).to(x.dtype)


def whole_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float = EPS) -> torch.Tensor:
    """The fork's custom LayerNorm (networks.py:851-878): per-sample mean
    and *unbiased* std over all of H, W, C, eps added to the std.
    gamma, beta: (C,)."""
    xf = upcast_f32(x)
    n = x.shape[1] * x.shape[2] * x.shape[3]
    mean, var_b = _moments(xf, (1, 2, 3))
    std = torch.sqrt(var_b * (n / (n - 1)))
    y = (xf - mean) / (std + eps)
    return (y * upcast_f32(gamma) + upcast_f32(beta)).to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1): mean over H, W → (B, 1, 1, C)."""
    return x.mean(dim=(1, 2), keepdim=True)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample on NHWC (nn.Upsample(scale_factor=2))."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, factor, w, factor, c)
    return x.reshape(b, h * factor, w * factor, c)


def activation(name: str):
    """Activation by name (networks.py:667-681, parameter-free subset)."""
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    if name == "selu":
        return F.selu
    if name == "tanh":
        return torch.tanh
    if name == "none":
        return lambda x: x
    raise ValueError(f"Unsupported activation: {name}")
