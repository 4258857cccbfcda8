"""Plain PyTorch ops of the networks, on NHWC tensors.

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


# The conv numerics (``munit_tpu/core/ops.py::set_conv_compute``). Parity
# mode (the default): operands as they come, and f32 convs without TF32.
# Production training: bf16 operands, f32 accumulation, the output cast back
# to the input's type; norms, losses and the optimizer stay f32.
_CONV_DTYPE = None


def set_conv_compute(dtype=None) -> None:
    """Set the conv numerics for the process: None (parity) or
    torch.bfloat16 (bf16 operands, f32 accumulate). Either way f32 convs
    and matmuls run without TF32 on the card, the counterpart of the JAX
    package's ``lax.Precision.HIGHEST``; in bf16 mode every conv is bf16
    and only the small f32 matmuls (the style MLP, the classifier's fc)
    remain."""
    global _CONV_DTYPE
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"conv compute dtype must be None or bfloat16, "
                         f"got {dtype}")
    _CONV_DTYPE = dtype
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def conv_compute_dtype():
    """The configured conv operand type (None in parity mode): what a
    caller choosing an activation type keys off."""
    return _CONV_DTYPE


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, stride: int = 1,
           dilation: int = 1, padding: int = 0) -> torch.Tensor:
    """Conv of an NHWC input; weight is OIHW. VALID over an already-padded
    input by default; ``padding`` zero-pads inside the conv, the same as
    ``conv2d(pad2d(x, padding, "zero"), ...)`` without the padded copy.

    Under ``set_conv_compute(torch.bfloat16)`` both operands are cast to
    bf16, the output is cast back to x's type and the bias is added in that
    type, as the JAX package does: a bias in f32 would promote every bf16
    activation downstream."""
    if _CONV_DTYPE is None:
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding,
                     dilation)
        return y.permute(0, 2, 3, 1).contiguous()
    y = F.conv2d(x.permute(0, 3, 1, 2).to(_CONV_DTYPE),
                 weight.to(_CONV_DTYPE), None, stride, padding, dilation)
    y = y.permute(0, 2, 3, 1).to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y.contiguous()


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """``x @ kernel + bias`` as the JAX package computes it: a bf16 x with
    f32 weights promotes to f32 (``nn.Linear`` would raise on the mix)."""
    dtype = torch.promote_types(x.dtype, weight.dtype)
    return F.linear(x.to(dtype), weight, bias)


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


def batch_norm_inference(x: torch.Tensor, mean: torch.Tensor,
                         var: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Inference-mode batch norm with frozen running statistics over the
    last (channel) axis, f32 math, output in x's type (the segmenter's
    frozen BN)."""
    inv = torch.rsqrt(upcast_f32(var) + eps) * upcast_f32(gamma)
    y = (upcast_f32(x) - upcast_f32(mean)) * inv + upcast_f32(beta)
    return y.to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1): mean over H, W → (B, 1, 1, C)."""
    return x.mean(dim=(1, 2), keepdim=True)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """A contiguous NCHW copy for the pools. CUDA's avg_pool2d backward on a
    channels-last tensor (the NHWC bytes seen as NCHW) gives wrong input
    gradients in PyTorch 2.11 with CUDA 12.8 on an H100, which sent wrong
    gradients through the multi-scale discriminator into the generator.
    tests/test_torch_kernels_cuda.py holds the pools' gradients on the card
    against the CPU."""
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False) on NHWC:
    the multi-scale discriminator's downsample between scales
    (networks.py:32-34). Sums in at least float32."""
    y = F.avg_pool2d(_nchw(upcast_f32(x)), 3, 2, 1, count_include_pad=False)
    return _nhwc(y).to(x.dtype)


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: int = 0) -> torch.Tensor:
    """Max pool on NHWC (the domain classifier's MaxPool2d, the segmenter's
    stem); the padding counts as -inf, as reduce_window's does."""
    return _nhwc(F.max_pool2d(_nchw(x), window, stride, padding))


def window_avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """The domain classifier's AvgPool2d(window), the window clamped to the
    map's extent (``munit_tpu/nn/classifiers.py``, "clamp the window"): at
    the reference's 64x64 content codes the window is the whole 16x16 map;
    smaller maps keep a live gradient instead of an empty window."""
    wh, ww = min(window, x.shape[1]), min(window, x.shape[2])
    return _nhwc(F.avg_pool2d(_nchw(x), (wh, ww), (wh, ww)))


def resize_bilinear(x: torch.Tensor, size: tuple) -> torch.Tensor:
    """Bilinear upsample of an NHWC tensor to ``size`` (H, W) with
    half-pixel centres and source coordinates clamped at the edges (torch's
    ``align_corners=False``): the JAX package's ``resize_bilinear`` default,
    ``jax.image.resize(..., "linear")``, when no axis shrinks. That call
    antialiases a downscale, which nothing in the port needs, so a
    downscale raises. Runs on a contiguous NCHW copy, as the pools do (see
    ``_nchw``)."""
    h, w = x.shape[1], x.shape[2]
    if size[0] < h or size[1] < w:
        raise ValueError(f"resize_bilinear upsamples only: {(h, w)} -> "
                         f"{tuple(size)}")
    y = F.interpolate(_nchw(x), size=tuple(size), mode="bilinear",
                      align_corners=False)
    return _nhwc(y)


def resize_nearest(x: torch.Tensor, size: tuple) -> torch.Tensor:
    """Nearest resize of an NHWC tensor: source index floor(i * in / out)
    in float32, clamped (``munit_tpu/core/ops.py::resize_nearest``)."""
    b, h, w, c = x.shape

    def index(n_out, n_in):
        i = torch.arange(n_out, dtype=torch.float32, device=x.device)
        return torch.floor(i * (n_in / n_out)).long().clamp(0, n_in - 1)

    return x[:, index(size[0], h)][:, :, index(size[1], w)]


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
