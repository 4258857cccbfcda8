"""The frozen dilated ResNet34-8s semantic segmenter, as an ``nn.Module`` on
NHWC tensors.

Counterpart of ``munit_tpu/nn/resnet.py::ResNet34_8s`` (reference
resnet.py:17-250, utils.py:933-968): a 7x7 s2 stem with BN, ReLU and a 3x3
s2 max pool (pad 1), four stages of BasicBlocks [3, 4, 6, 3]; once the
output stride reaches 8, the later stages are dilated (2, then 4) with full
padding so the map keeps its size; a 1x1 conv to ``num_classes`` logits,
upsampled bilinearly (half-pixel centres) to the input size.

The net is only ever used frozen (trainer.py:137-143): ``frozen_on``
puts it in eval mode with every parameter out of autograd, and its batch
norm uses the running statistics. A gradient flows to its input image and to
nothing else, so its convolutions cost no weight gradients.

Parameter and buffer names are the reference's ``resnet34_8s.*`` keys
(``conv1``, ``bn1``, ``layer{1-4}.{i}.{conv1,bn1,conv2,bn2}``,
``layer{i}.0.downsample.{0,1}``, ``fc``): the layout that
``convert_resnet34_8s_state_dict`` reads, so a reference ``.pth`` loads with
``load_state_dict`` (``io/weights.py::load_segmenter_checkpoint`` drops its
``num_batches_tracked`` counters).

``SegmentationHead`` is the trainable head of the seg-head step
(trainer.py:203-223, ``munit_tpu/nn/resnet.py::SegmentationHead``): the
trunk's layer4 (three blocks of 512 planes, dilation 4) on content codes,
built from the domain classifier's train-mode ``BasicBlock``
(``nn/classifiers.py``, flax's batch-norm convention), then AvgPool2d(7,
padding 3, stride 1) counting the pad, then a 1x1 conv with a bias to 10
classes.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from munit_tpu_torch.core import init as winit
from munit_tpu_torch.core import ops
from munit_tpu_torch.nn import classifiers

# (planes, blocks, stride, dilation) per stage for output stride 8: the
# stride-2 stages past stride 8 become dilation 2, then 4 (resnet.py:197-250)
LAYERS_8S = ((64, 3, 1, 1), (128, 4, 2, 1), (256, 6, 1, 2), (512, 3, 1, 4))
NUM_CLASSES = 19
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def dilated_padding(dilation: int) -> int:
    """Full padding of a dilated 3x3 conv (resnet.py:17-41)."""
    upsampled = (3 - 1) * (dilation - 1) + 3
    return (upsampled - 1) // 2


class FrozenBN(nn.Module):
    """Inference-mode batch norm with the reference BatchNorm2d's names
    (InceptionV3's with eps 1e-3)."""

    def __init__(self, dim: int, eps: float = ops.EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.batch_norm_inference(x, self.running_mean,
                                        self.running_var, self.weight,
                                        self.bias, self.eps)


class _Downsample(nn.Module):
    """The reference's ``downsample`` Sequential: 1x1 strided conv, BN."""

    def __init__(self, in_dim: int, planes: int, stride: int):
        super().__init__()
        self.stride = stride
        self.add_module("0", nn.Conv2d(in_dim, planes, 1, bias=False))
        self.add_module("1", FrozenBN(planes))

    def forward(self, x):
        conv = getattr(self, "0")
        return getattr(self, "1")(ops.conv2d(x, conv.weight,
                                             stride=self.stride))


class BasicBlock(nn.Module):
    """conv3x3 (stride, dilation) → BN → ReLU → conv3x3 (dilation) → BN,
    plus the identity or a 1x1-conv + BN shortcut, then ReLU. Convs have
    no bias and zero "full" padding."""

    def __init__(self, in_dim: int, planes: int, stride: int, dilation: int,
                 downsample: bool):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.pad = dilated_padding(dilation)
        self.conv1 = nn.Conv2d(in_dim, planes, 3, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, bias=False)
        self.bn2 = FrozenBN(planes)
        self.downsample = (_Downsample(in_dim, planes, stride) if downsample
                           else None)

    def forward(self, x):
        out = ops.conv2d(x, self.conv1.weight, stride=self.stride,
                         dilation=self.dilation, padding=self.pad)
        out = torch.relu(self.bn1(out))
        out = ops.conv2d(out, self.conv2.weight, dilation=self.dilation,
                         padding=self.pad)
        out = self.bn2(out)
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class _Trunk(nn.Module):
    """The modules under the reference's ``resnet34_8s.`` prefix."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, bias=False)
        self.bn1 = FrozenBN(64)
        in_dim = 64
        for li, (planes, blocks, stride, dilation) in enumerate(LAYERS_8S):
            stage = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                down = bi == 0 and (s != 1 or in_dim != planes)
                stage.append(BasicBlock(in_dim, planes, s, dilation, down))
                in_dim = planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*stage))
        self.fc = nn.Conv2d(512, num_classes, 1)


class ResNet34_8s(nn.Module):
    """NHWC image in ImageNet normalization → (B, H, W, num_classes)
    logits at the input's size."""

    def __init__(self, num_classes: int = NUM_CLASSES):
        super().__init__()
        self.resnet34_8s = _Trunk(num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.resnet34_8s
        size = (x.shape[1], x.shape[2])
        h = ops.conv2d(x, t.conv1.weight, stride=2, padding=3)
        h = ops.max_pool(torch.relu(t.bn1(h)), 3, 2, 1)
        for li in range(len(LAYERS_8S)):
            h = getattr(t, f"layer{li + 1}")(h)
        h = ops.conv2d(h, t.fc.weight, t.fc.bias)
        return ops.resize_bilinear(h, size)

    def frozen_on(self, device) -> "ResNet34_8s":
        """Eval mode, no parameter in autograd, channels-last on device."""
        self.eval().requires_grad_(False)
        return self.to(device=device, memory_format=torch.channels_last)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Seeded random weights, as the JAX package's ``init`` draws them
        for a run without the Cityscapes checkpoint: kaiming-normal convs
        (fan in), N(0, 0.01) logit conv and a zero bias, BN scale 1, shift
        0, running mean 0, var 1."""
        for name, m in self.named_modules():
            if isinstance(m, nn.Conv2d):
                if name.endswith("fc"):
                    m.weight.copy_(torch.randn(m.weight.shape,
                                               generator=generator) * 0.01)
                    m.bias.zero_()
                else:
                    winit.kaiming_normal(m.weight, generator)
            elif isinstance(m, FrozenBN):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


class SegmentationHead(nn.Module):
    """Content code (B, H, W, C) → (B, H, W, num_classes) logits at the
    code's size. Parameter names follow the trunk's: ``layer4.{0,1,2}.*``
    (``layer4.0.downsample.{0,1}``) and ``fc``."""

    def __init__(self, in_dim: int = 256, num_classes: int = 10):
        super().__init__()
        planes, _, _, dilation = LAYERS_8S[-1]
        self.layer4 = nn.ModuleList(
            [classifiers.BasicBlock(in_dim if i == 0 else planes, planes,
                                    dilation)
             for i in range(3)])
        self.fc = nn.Conv2d(planes, num_classes, 1)

    def forward(self, c: torch.Tensor,
                update_stats: bool = False) -> torch.Tensor:
        """Train-mode BN always; ``update_stats`` moves the running
        statistics (the head's own step keeps them)."""
        for block in self.layer4:
            c = block(c, update_stats)
        return ops.conv2d(ops.box_avg_pool(c, 7), self.fc.weight,
                          self.fc.bias)

    def init(self, generator: torch.Generator) -> None:
        """Seeded init as the JAX package's: kaiming-normal convs (fan in),
        a zero logit bias; the BN layers keep scale 1, shift 0, running
        mean 0 and var 1."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                winit.kaiming_normal(m.weight, generator)
                if m.bias is not None:
                    winit.zeros(m.bias)


@functools.lru_cache(maxsize=None)
def _imagenet_stats(dtype: torch.dtype, device: torch.device):
    """The normalization's mean and std on ``device``, made once: a step
    captured as a CUDA graph (``train/graphs.py``) may copy nothing from
    the host. Made outside inference mode, so that a training step may
    read them after an inference command (InceptionV3's preprocessing,
    under ``torch.inference_mode``) made them first in the process."""
    with torch.inference_mode(False):
        return (torch.tensor(_IMAGENET_MEAN, dtype=dtype, device=device),
                torch.tensor(_IMAGENET_STD, dtype=dtype, device=device))


def imagenet_normalize(img01: torch.Tensor) -> torch.Tensor:
    """[0, 1] NHWC → ImageNet normalization (utils.py:159-174). The
    constants are at least f32, as the JAX package's ``jnp.asarray`` ones
    are, so a bf16 image becomes an f32 segmenter input."""
    mean, std = _imagenet_stats(
        torch.promote_types(img01.dtype, torch.float32), img01.device)
    return (img01 - mean) / std


def seg_preprocess(img_pm1: torch.Tensor) -> torch.Tensor:
    """A [-1, 1] image (a model's input or output) → the segmenter's input
    (trainer.py:717-723)."""
    return imagenet_normalize((img_pm1 + 1.0) * 0.5)
