"""The ResNet-18 binary flood classifier (load_flood_classifier,
utils.py:917-930): the port's counterpart of ``munit_tpu/nn/resnet18.py``,
inference only. A torchvision ``resnet18`` trunk (frozen batch norm) with a
2-way fc head; no entry point of the reference calls it, and it serves as a
quality metric.

Parameter names are torchvision's (``conv1``, ``bn1``, ``layer{1-4}.{0,1}.
{conv1,bn1,conv2,bn2}``, ``layer{2-4}.0.downsample.{0,1}``, ``fc``), so a
torchvision state dict loads after ``convert_resnet18_state_dict``. As in
the JAX package its convs are float32 (``Precision.HIGHEST`` there) whatever
``ops.set_conv_compute`` says, and run with TF32 off. Tensors are NHWC.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from munit_tpu_torch.core import ops
from munit_tpu_torch.nn.resnet import FrozenBN

_LAYERS = ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2))
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class _Downsample(nn.Module):
    """torchvision's ``downsample``: a strided 1x1 conv, then BN."""

    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.stride = stride
        self.add_module("0", nn.Conv2d(cin, planes, 1, bias=False))
        self.add_module("1", FrozenBN(planes))

    def forward(self, x):
        conv = getattr(self, "0")
        y = ops.conv2d_f32(x, conv.weight, self.stride)
        return getattr(self, "1")(y)


class _Block(nn.Module):
    """BasicBlock: 3x3 (stride) → BN → ReLU → 3x3 → BN, plus the identity
    or the downsample, then ReLU."""

    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, planes, 3, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, bias=False)
        self.bn2 = FrozenBN(planes)
        self.downsample = (_Downsample(cin, planes, stride)
                           if stride != 1 or cin != planes else None)

    def forward(self, x):
        out = torch.relu(self.bn1(ops.conv2d_f32(x, self.conv1.weight,
                                                 self.stride, 1)))
        out = self.bn2(ops.conv2d_f32(out, self.conv2.weight, 1, 1))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class FloodClassifier(nn.Module):
    """ImageNet-normalized NHWC images → (B, num_classes) logits."""

    def __init__(self, num_classes: int = 2):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, bias=False)
        self.bn1 = FrozenBN(64)
        cin = 64
        for li, (planes, blocks, stride) in enumerate(_LAYERS):
            stage = []
            for bi in range(blocks):
                stage.append(_Block(cin, planes, stride if bi == 0 else 1))
                cin = planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*stage))
        self.fc = nn.Linear(512, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with ops.exact_f32():
            x = torch.relu(self.bn1(ops.conv2d_f32(x, self.conv1.weight, 2,
                                                   3)))
            x = ops.max_pool(x, 3, 2, 1)
            for li in range(len(_LAYERS)):
                x = getattr(self, f"layer{li + 1}")(x)
            return F.linear(x.mean(dim=(1, 2)), self.fc.weight, self.fc.bias)

    def frozen_on(self, device) -> "FloodClassifier":
        """Eval mode, no parameter in autograd, on ``device``."""
        self.eval().requires_grad_(False)
        return self.to(device)


def flood_classifier_transform(img) -> np.ndarray:
    """transform_torchVar (utils.py:177-189): PIL image → shorter side 256
    → centre crop 224 → ImageNet-normalized (224, 224, 3) float32."""
    from munit_tpu_torch.data import transforms as T
    img = T.resize_shorter(img.convert("RGB"), 256)
    w, h = img.size
    img = T.crop(img, (h - 224) // 2, (w - 224) // 2, 224, 224)
    return (T.to_array01(img) - _IMAGENET_MEAN) / _IMAGENET_STD


def convert_resnet18_state_dict(sd) -> dict:
    """A torchvision ``resnet18`` state dict with the 2-way fc → this
    module's state_dict: float32 tensors, BatchNorm's
    ``num_batches_tracked`` counters dropped."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).float()
            for k, v in sd.items() if not k.endswith("num_batches_tracked")}
