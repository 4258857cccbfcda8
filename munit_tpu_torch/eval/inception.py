"""InceptionV3 (torchvision's architecture) for FID and IS: the port's
counterpart of ``munit_tpu/eval/inception.py`` (reference
inception_utils.py:27-85).

``inception_preprocess``: an image in [-1, 1] → [0, 1] → ImageNet
normalization → bilinear 299² with align_corners=True, up or down, no
antialias (config_HD's 512² comes down to 299²). ``InceptionV3`` then
returns the 2048-d global-average pool (FID, KID) and the 1000-way logits
of the fc head (IS, CIS).

Every conv is a ``BasicConv2d``: conv without bias, frozen batch norm (eps
1e-3), ReLU. The JAX package computes these convs at
``lax.Precision.HIGHEST`` outside its ``ops.conv``, so they stay float32
when the generator runs bf16; here they call ``F.conv2d`` directly in
float32, and the whole forward runs with TF32 off, whatever
``ops.set_conv_compute`` says. Tensors are NHWC; the convs see the same
bytes as channels-last NCHW. Parameter names are torchvision's
``inception_v3`` keys (``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.
branch1x1.bn.running_mean``, ``fc.weight`` ...): ``io/weights.py::
load_inception_checkpoint`` reads a torchvision ``.pth``, the JAX CLIs'
pickle of flax variables or an ``.npz``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from munit_tpu_torch.core import init as winit
from munit_tpu_torch.core import ops
from munit_tpu_torch.nn.resnet import FrozenBN, seg_preprocess

BN_EPS = 1e-3
SIZE = 299


class BasicConv2d(nn.Module):
    """conv (no bias, zero padding) → BN (eps 1e-3, frozen) → ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=(0, 0)):
        super().__init__()
        self.stride, self.padding = stride, tuple(padding)
        self.conv = nn.Conv2d(cin, cout, kernel, bias=False)
        self.bn = FrozenBN(cout, BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(ops.conv2d_f32(
            x, self.conv.weight, self.stride, self.padding)))


def _pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3, stride 1, pad 1, the pad counted: sum / 9."""
    return ops.box_avg_pool(x, 3)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=(1, 1))
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_pool3(x))], dim=-1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, ops.max_pool(x, 3, 2)],
                         dim=-1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_pool3(x))], dim=-1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          ops.max_pool(x, 3, 2)], dim=-1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=-1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=-1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_pool3(x))], dim=-1)


class InceptionV3(nn.Module):
    """An NHWC image that ``inception_preprocess`` made (at least 75² for
    the trunk's strides) → (pool (B, 2048), logits (B, num_classes))."""

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor):
        with ops.exact_f32():
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = ops.max_pool(x, 3, 2)
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
            x = ops.max_pool(x, 3, 2)
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                         "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                         "Mixed_7a", "Mixed_7b", "Mixed_7c"):
                x = getattr(self, name)(x)
            pool = x.mean(dim=(1, 2))
            return pool, F.linear(pool, self.fc.weight, self.fc.bias)

    def frozen_on(self, device) -> "InceptionV3":
        """Eval mode, no parameter in autograd, on ``device``."""
        self.eval().requires_grad_(False)
        return self.to(device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "InceptionV3":
        """Seeded random weights for runs without a checkpoint (the real
        ones are not in the repo): kaiming-normal convs (fan in), BN scale
        1, shift 0, running mean 0, var 1, an N(0, 0.01) fc and a zero
        bias."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                winit.kaiming_normal(m.weight, generator)
            elif isinstance(m, FrozenBN):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        self.fc.weight.copy_(torch.randn(self.fc.weight.shape,
                                         generator=generator) * 0.01)
        self.fc.bias.zero_()
        return self


def inception_preprocess(img_pm1: torch.Tensor) -> torch.Tensor:
    """WrapInception's preprocessing (inception_utils.py:40-46): [-1, 1] →
    ImageNet normalization → bilinear 299² with align_corners=True."""
    x = seg_preprocess(img_pm1)
    return ops.resize_bilinear(x, (SIZE, SIZE), align_corners=True)


def pool_and_logits(net: InceptionV3, img_pm1: torch.Tensor):
    """(pool, logits) of images in [-1, 1]."""
    return net(inception_preprocess(img_pm1))


def inception_probs(net: InceptionV3, img01: torch.Tensor) -> torch.Tensor:
    """Softmax class probabilities of images in [0, 1] (test_batch.py's
    IS/CIS input)."""
    _, logits = pool_and_logits(net, img01 * 2.0 - 1.0)
    return torch.softmax(logits, dim=-1)


def load_inception(path: str, device) -> InceptionV3:
    """A frozen ``InceptionV3`` on ``device`` with the weights of ``path``
    (``io/weights.py::load_inception_checkpoint``: torchvision ``.pth``,
    ``.npz``, or the JAX CLIs' pickle)."""
    from munit_tpu_torch.io.weights import load_inception_checkpoint
    net = InceptionV3()
    net.load_state_dict(load_inception_checkpoint(path))
    return net.frozen_on(device)
