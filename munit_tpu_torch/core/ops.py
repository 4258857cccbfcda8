"""Plain PyTorch ops of the networks, on NHWC tensors.

Counterparts of ``munit_tpu/core/ops.py`` in plain math: no space-to-depth
or lane packing. Tensors are NHWC as in the JAX package; a convolution views
its input as channels-last NCHW (the same bytes) for ``F.conv2d`` and hands
back NHWC. ``conv_quant`` is the JAX package's int8 inference tier (W8A8
convolutions, ``munit_tpu/core/ops.py:183-314``).

``instance_norm``, ``adain`` and ``whole_layer_norm`` are the plain versions
of the Hopper kernels in ``munit_tpu_torch/kernels``: the kernels' wrappers
use them for tensors on the CPU, and the tests and ``chip_smoke.py`` hold the
kernels against them. Statistics are two-pass in (at least) float32.
"""

from __future__ import annotations

import contextlib
import threading

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


# --- int8 (W8A8) convolutions, inference only -----------------------------
#
# ``conv_quant`` scopes int8 convs around a region of code, in one of three
# modes, as the JAX package's (read there at trace time, here at call time):
# - dynamic: a per-tensor activation scale max(max|x|, 1e-6)/127 computed
#   on the device at each call (never read back, so a captured step holds
#   it);
# - record: full-precision convs that append each site's max|x| (a device
#   scalar) to a caller's list, every site in call order: the calibration;
# - static: one scale per site from a record pass (its max, usually x1.1),
#   the sites counted in call order; a site the heuristic leaves in full
#   precision still takes its index.
# Weights take a scale per output channel over (kh, kw, cin). Rounding is
# half to even, clipped to ±127. The product is the int8 taps of each
# output pixel, gathered in the HWIO weight's flattening order, times the
# int8 weight matrix, summed exactly in int32 by ``torch._int_mm`` (cuBLASLt
# on the card), then scaled back: ``y.float() * (sx * sw)``.
# The state is per thread: a scope covers the code run inside it.
_QUANT = threading.local()


def _quant_state():
    return getattr(_QUANT, "state", None)


@contextlib.contextmanager
def conv_quant(enabled: bool = True, scales=None, record: list | None = None,
               all_convs: bool = False):
    """Scope int8 convs around the code run inside it.

    ``scales``: per-site max|activation| floats (a record pass's) → static
    mode. ``record``: a list that gets each site's max|x| → record mode.
    Neither → dynamic mode. ``enabled=False`` turns quantization off inside
    the scope. ``all_convs`` skips the ``_quant_worthwhile`` heuristic."""
    old = _quant_state()
    if not enabled:
        _QUANT.state = None
    elif record is not None:
        _QUANT.state = {"mode": "record", "record": record, "all": all_convs}
    elif scales is not None:
        _QUANT.state = {"mode": "static", "scales": list(scales), "idx": 0,
                        "all": all_convs}
    else:
        _QUANT.state = {"mode": "dynamic", "all": all_convs}
    try:
        yield
    finally:
        _QUANT.state = old


def _quant_worthwhile(x_shape, k_shape, stride: int) -> bool:
    """The JAX package's shape rule for a conv worth quantizing: stride 1,
    at least 128 channels in and out, at most 160x160 input pixels.
    ``x_shape`` is the padded NHWC input, ``k_shape`` the HWIO kernel's."""
    kh, kw, cin, cout = k_shape
    if stride != 1:
        return False
    if min(cin, cout) < 128:
        return False
    if x_shape[1] * x_shape[2] > 160 * 160:
        return False
    return True


# The scales' /127 as the JAX package's jitted programs compute it: XLA
# turns a division by the constant 127 into a multiply by its float32
# reciprocal, which can round a scale one bit away from a true division.
INV127 = 1.0 / 127.0


def quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(xf / scale), half to even, clipped to ±127, as int8."""
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def weight_scales(weight: torch.Tensor) -> torch.Tensor:
    """Per-output-channel scales of an OIHW weight: max|w| over (kh, kw,
    cin), at least 1e-8, over 127 (``INV127``)."""
    return torch.clamp(weight.float().abs().amax(dim=(1, 2, 3)),
                       min=1e-8) * INV127


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _row_pad(m, least_m: int) -> int:
    """Zero rows that lift M above 16. In a program traced with a symbolic
    batch M is symbolic, and ``least_m`` is the fewest rows any batch
    gives: above 16 none are needed for any batch, else 17 serve every
    batch, with no guard on it."""
    if isinstance(m, int):
        return max(m, 17) - m
    return 0 if least_m >= 17 else 17


def int8_matmul(a: torch.Tensor, b: torch.Tensor,
                least_m: int = 0) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 → (M, N) int32 through ``torch._int_mm``.
    On the card its shape rules (M > 16, K and N multiples of 8) are met by
    zero rows and columns, which add nothing to a sum (``least_m``: see
    ``_row_pad``)."""
    m, k = a.shape
    n = b.shape[1]
    if a.is_cuda:
        pm, pk, pn = _row_pad(m, least_m), _ceil8(k) - k, _ceil8(n) - n
        if pm or pk:
            a = F.pad(a, (0, pk, 0, pm))
        if pk or pn:
            b = F.pad(b, (0, pn, 0, pk))
        return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]
    return torch._int_mm(a.contiguous(), b.contiguous())


def int8_conv_sums(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                   dilation: int = 1) -> torch.Tensor:
    """The exact int32 sums of a VALID conv of an int8 NHWC input with an
    int8 OIHW weight, as NHWC: each output pixel's taps gathered as one row
    in the HWIO weight's (kh, kw, cin) order."""
    b, h, w, c = xq.shape
    cout, _, kh, kw = wq.shape
    ho = (h - dilation * (kh - 1) - 1) // stride + 1
    wo = (w - dilation * (kw - 1) - 1) // stride + 1
    xq = xq.contiguous()
    sb, sh, sw, sc = xq.stride()
    taps = xq.as_strided((b, ho, wo, kh, kw, c),
                         (sb, sh * stride, sw * stride, sh * dilation,
                          sw * dilation, sc)).reshape(b * ho * wo,
                                                      kh * kw * c)
    mat = wq.permute(2, 3, 1, 0).reshape(kh * kw * c, cout)
    return int8_matmul(taps, mat, ho * wo).view(b, ho, wo, cout)


def _conv2d_int8(x: torch.Tensor, weight: torch.Tensor, stride: int,
                 dilation: int) -> torch.Tensor:
    """W8A8 conv of a padded NHWC input: quantize both operands, sum in
    int32, scale back. Returns float32."""
    st = _quant_state()
    xf = x.float()
    if st["mode"] == "static":
        if st["idx"] >= len(st["scales"]):
            raise ValueError(
                f"conv_quant: site {st['idx']} has no calibrated scale "
                f"({len(st['scales'])} recorded) — the body run must match "
                "the calibration body")
        amax = max(float(st["scales"][st["idx"]]), 1e-6)
        st["idx"] += 1
        sx = torch.full((), amax / 127.0, dtype=torch.float32,
                        device=x.device)
    else:
        sx = torch.clamp(xf.abs().amax(), min=1e-6) * INV127
    sw = weight_scales(weight)
    wq = quantize(weight.float(), sw[:, None, None, None])
    acc = int8_conv_sums(quantize(xf, sx), wq, stride, dilation)
    return acc.float() * (sx * sw)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, stride: int = 1,
           dilation: int = 1, padding: int = 0) -> torch.Tensor:
    """Conv of an NHWC input; weight is OIHW. VALID over an already-padded
    input by default; ``padding`` zero-pads inside the conv, the same as
    ``conv2d(pad2d(x, padding, "zero"), ...)`` without the padded copy.

    Under ``set_conv_compute(torch.bfloat16)`` both operands are cast to
    bf16, the output is cast back to x's type and the bias is added in that
    type, as the JAX package does: a bias in f32 would promote every bf16
    activation downstream. Inside a ``conv_quant`` scope a conv is recorded
    or run in int8 as the scope says; its shape rule reads the padded
    input."""
    st = _quant_state()
    if st is not None:
        if padding:
            x, padding = pad2d(x, padding, "zero"), 0
        if st["mode"] == "record":
            st["record"].append(x.float().abs().amax())
        elif st["all"] or _quant_worthwhile(
                x.shape, (*weight.shape[2:], *weight.shape[1::-1]), stride):
            y = _conv2d_int8(x, weight, stride, dilation).to(x.dtype)
            if bias is not None:
                y = y + bias.to(x.dtype)
            return y
        elif st["mode"] == "static":
            st["idx"] += 1
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


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN convolutions and matmuls inside the block, the
    settings restored after: the JAX package's ``Precision.HIGHEST`` for
    code that a TF32-on caller may reach."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def conv2d_f32(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
               padding=0) -> torch.Tensor:
    """A bias-free conv of an NHWC input in float32 whatever
    ``set_conv_compute`` says (zero ``padding``: an int or (ph, pw)): the
    JAX package's ``lax.conv_general_dilated`` at ``Precision.HIGHEST``
    outside its ``ops.conv`` (InceptionV3, the flood classifier). Run it
    under ``exact_f32`` for no TF32 on the card."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), weight.float(), None, stride,
                 padding)
    return y.permute(0, 2, 3, 1)


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


def box_avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """AvgPool2d(window, stride=1, padding=window // 2) on NHWC, the pad
    counted (divides by window²): the seg head's smoothing (window 7) and
    InceptionV3's branch pool (window 3, ``munit_tpu/eval/inception.py::
    _avg_pool3_s1_p1``), the JAX package's ``reduce_window`` sum over a
    zero-padded window / window²."""
    return _nhwc(F.avg_pool2d(_nchw(x), window, 1, window // 2,
                              count_include_pad=True))


def window_avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """The domain classifier's AvgPool2d(window), the window clamped to the
    map's extent (``munit_tpu/nn/classifiers.py``, "clamp the window"): at
    the reference's 64x64 content codes the window is the whole 16x16 map;
    smaller maps keep a live gradient instead of an empty window."""
    wh, ww = min(window, x.shape[1]), min(window, x.shape[2])
    return _nhwc(F.avg_pool2d(_nchw(x), (wh, ww), (wh, ww)))


def _align_corners_coords(n_out: int, n_in: int, device):
    """Source rows (or columns) of an align-corners resize: i·(n_in − 1)/
    (n_out − 1) in float32, the two neighbours clamped, and the weight of
    the second."""
    if n_out == 1:
        src = torch.zeros(1, dtype=torch.float32, device=device)
    else:
        src = (torch.arange(n_out, dtype=torch.float32, device=device)
               * ((n_in - 1) / (n_out - 1)))
    i0 = torch.floor(src).long().clamp(0, n_in - 1)
    return i0, (i0 + 1).clamp(0, n_in - 1), src - i0.float()


def resize_bilinear(x: torch.Tensor, size: tuple,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NHWC tensor to ``size`` (H, W).

    ``align_corners=False`` (the segmenter's upsample): half-pixel centres,
    source coordinates clamped at the edges, the JAX package's default
    ``jax.image.resize(..., "linear")`` when no axis shrinks. That call
    antialiases a downscale, which nothing in the port needs there, so a
    downscale raises. Runs on a contiguous NCHW copy, as the pools do (see
    ``_nchw``).

    ``align_corners=True`` (InceptionV3's 299² input, up or down, no
    antialias): the JAX package's explicit gather, corner pixels on corner
    pixels, interpolated in float32 and cast back to x's type."""
    h, w = x.shape[1], x.shape[2]
    if align_corners:
        if (h, w) == tuple(size):
            return x
        y0, y1, wy = _align_corners_coords(size[0], h, x.device)
        x0, x1, wx = _align_corners_coords(size[1], w, x.device)
        g = upcast_f32(x)
        wy, wx = wy[None, :, None, None], wx[None, None, :, None]
        top, bot = g[:, y0], g[:, y1]
        top = top[:, :, x0] * (1 - wx) + top[:, :, x1] * wx
        bot = bot[:, :, x0] * (1 - wx) + bot[:, :, x1] * wx
        return (top * (1 - wy) + bot * wy).to(x.dtype)
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
