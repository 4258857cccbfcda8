"""The sim/real domain classifier on content codes, as an ``nn.Module`` on
NHWC tensors.

Counterpart of ``munit_tpu/nn/classifiers.py::DomainClassifier`` (reference
utils.py:1370-1392, 1220-1276): content code (B, H, W, 256) → MaxPool(2) →
BasicBlock(256→128) → MaxPool(2) → BasicBlock(128→64) → AvgPool(16, the
window clamped to the map) → FC(64 P→1), a scalar logit per sample. P is
the pooled map's pixels: 1 up to 64x64 content codes (crops of 256), 4 at
config_HD's 128x128 (crop 512), where the JAX package sizes its FC from
the content it is built on.

Its BatchNorm runs in train mode, as flax's ``nn.BatchNorm(momentum=0.9)``
does and not as ``nn.BatchNorm2d``'s defaults: the output uses the batch's
mean and biased variance, and the running statistics, when the caller asks
for their update, move as running = 0.9 running + 0.1 batch with the
*biased* batch variance. Inside a data-parallel group (``dist/mesh.py``)
the batch is the global one: the statistics are meaned over the group's
equal parts, and so are their gradients. Parameter names follow the reference
``state_dict`` (``BasicBlock{1,2}.{conv1,conv2,bn1,bn2}``,
``.downsample.{0,1}``, ``fc``), the layout
``convert_domain_classifier_state_dict`` reads.
"""

from __future__ import annotations

import torch
from torch import nn

from munit_tpu_torch.core import init as winit
from munit_tpu_torch.core import ops
from munit_tpu_torch.dist import mesh

MOMENTUM = 0.9   # flax's convention: the weight of the old running value
BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """Train-mode batch norm over (B, H, W) of an NHWC tensor. The output
    takes the promoted type of x and the parameters, as flax's does: a bf16
    x with f32 scale and shift gives f32."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
        xf = ops.upcast_f32(x)
        mean = xf.mean(dim=(0, 1, 2))
        if mesh.active():
            # inside a data-parallel group: the global batch's mean, then
            # its biased variance about it, each the mean over the ranks'
            # equal parts (at world 1 the one-process values, bit for bit)
            mean = mesh.group_mean(mean)
            var = mesh.group_mean((xf - mean).square().mean(dim=(0, 1, 2)))
        else:
            var = (xf - mean).square().mean(dim=(0, 1, 2))
        if update_stats:
            with torch.no_grad():
                self.running_mean.mul_(MOMENTUM).add_(mean, alpha=1 - MOMENTUM)
                self.running_var.mul_(MOMENTUM).add_(var, alpha=1 - MOMENTUM)
        y = (xf - mean) * torch.rsqrt(var + BN_EPS) * self.weight + self.bias
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))


class _Downsample(nn.Module):
    """The reference's ``downsample`` Sequential: 1x1 conv, then BN."""

    def __init__(self, in_dim: int, planes: int):
        super().__init__()
        self.add_module("0", nn.Conv2d(in_dim, planes, 1, bias=False))
        self.add_module("1", BatchNorm(planes))

    def forward(self, x, update_stats):
        conv = getattr(self, "0")
        return getattr(self, "1")(ops.conv2d(x, conv.weight), update_stats)


class BasicBlock(nn.Module):
    """conv3x3 → BN → ReLU → conv3x3 → BN, plus the input or, where the
    widths differ or ``shortcut`` says so, a 1x1-conv + BN shortcut, then
    ReLU. Convs have no bias; zero padding, ``dilation`` of it on each side
    (the seg head's blocks are dilated)."""

    def __init__(self, in_dim: int, planes: int, dilation: int = 1,
                 shortcut: bool = False):
        super().__init__()
        self.dilation = dilation
        self.conv1 = nn.Conv2d(in_dim, planes, 3, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = (_Downsample(in_dim, planes)
                           if shortcut or in_dim != planes else None)

    def _conv(self, x, conv):
        return ops.conv2d(x, conv.weight, dilation=self.dilation,
                          padding=self.dilation)

    def forward(self, x, update_stats):
        out = torch.relu(self.bn1(self._conv(x, self.conv1), update_stats))
        out = self.bn2(self._conv(out, self.conv2), update_stats)
        identity = (x if self.downsample is None
                    else self.downsample(x, update_stats))
        return torch.relu(out + identity)


def pooled_size(n: int) -> int:
    """A content side of n after the two MaxPool(2) and the clamped
    AvgPool(16)."""
    m = n // 2 // 2
    return m // min(16, m)


class DomainClassifier(nn.Module):
    """Scalar domain logit (B, 1) from a content code (B, H, W, C) of
    ``content_hw`` (H, W)."""

    def __init__(self, in_dim: int = 256, content_hw=(64, 64)):
        super().__init__()
        # the JAX package's blocks always take the 1x1-conv shortcut
        # (munit_tpu/nn/classifiers.py::_ClsBasicBlock), also where a
        # content code of 128 channels meets the first block's 128
        self.BasicBlock1 = BasicBlock(in_dim, 128, shortcut=True)
        self.BasicBlock2 = BasicBlock(128, 64, shortcut=True)
        h, w = content_hw
        self.fc = nn.Linear(64 * pooled_size(h) * pooled_size(w), 1)

    def forward(self, x: torch.Tensor,
                update_stats: bool = False) -> torch.Tensor:
        """Train-mode BN always; ``update_stats`` moves the running
        statistics (the classifier's own step keeps them, the generator's
        fool term discards them)."""
        x = ops.max_pool(x, 2, 2)
        x = self.BasicBlock1(x, update_stats)
        x = ops.max_pool(x, 2, 2)
        x = self.BasicBlock2(x, update_stats)
        x = ops.window_avg_pool(x, 16)
        return ops.linear(x.reshape(x.shape[0], -1), self.fc.weight,
                          self.fc.bias)

    def init(self, generator: torch.Generator) -> None:
        """Seeded init as the JAX package's: N(0, 0.02) convs and fc weight,
        zero fc bias; the BN layers keep their built scale 1, shift 0 and
        running mean 0, var 1."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                winit.gaussian(m.weight, generator)
                if m.bias is not None:
                    winit.zeros(m.bias)
