"""VGG16 to relu5_3, the frozen net of the perceptual loss (``vgg_w``): the
port's copy of ``munit_tpu/nn/vgg.py`` (reference networks.py:755-804).

13 3x3 convs (zero pad 1, ReLU each) and 3 2x2 max pools, returning relu5_3
(B, H/8, W/8, 512). The convs run through ``core/ops.py``, so
``set_conv_compute(torch.bfloat16)`` gives them bf16 operands as the JAX
package's bf16 mode gives its ``ops.conv2d``. The net is only ever frozen:
eval mode, no parameter in autograd; a gradient reaches its input only.

``vgg_preprocess`` (utils.py:1051-1063): RGB → BGR, [-1, 1] → [0, 255],
minus the Caffe BGR means. The means are a float32 buffer on the net's
device, so a bf16 image promotes to float32 as it does in JAX, and a
captured step copies nothing from the host.

``convert_vgg16_state_dict`` takes the reference ``Vgg16``'s keys
(``conv1_1.weight`` ...), which are this module's own, or torchvision's
``features.{i}.*`` layout.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from munit_tpu_torch.core import init as winit
from munit_tpu_torch.core import ops

# (name, out_channels); "M" = 2x2 max pool
CFG = [("conv1_1", 64), ("conv1_2", 64), "M",
       ("conv2_1", 128), ("conv2_2", 128), "M",
       ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
       ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512),
       ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)]
CONV_NAMES = [item[0] for item in CFG if item != "M"]
# torchvision vgg16().features index of each conv
TORCHVISION_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
CAFFE_BGR_MEAN = (103.939, 116.779, 123.680)


class Vgg16(nn.Module):
    """relu5_3 features (B, H/8, W/8, 512) of an NHWC image that
    ``vgg_preprocess`` made."""

    def __init__(self):
        super().__init__()
        cin = 3
        for name, cout in (item for item in CFG if item != "M"):
            setattr(self, name, nn.Conv2d(cin, cout, 3, 1, 1))
            cin = cout
        self.register_buffer("bgr_mean", torch.tensor(CAFFE_BGR_MEAN),
                             persistent=False)

    def frozen_on(self, device) -> "Vgg16":
        """Eval mode, no parameter in autograd, on ``device``."""
        self.eval().requires_grad_(False)
        return self.to(device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Seeded kaiming-normal weights and zero biases (the JAX
        package's init), for a run without the VGG16 weights."""
        for name in CONV_NAMES:
            conv = getattr(self, name)
            winit.kaiming_normal(conv.weight, generator)
            winit.zeros(conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for item in CFG:
            if item == "M":
                x = ops.max_pool(x, 2, 2)
                continue
            conv = getattr(self, item[0])
            x = torch.relu(ops.conv2d(x, conv.weight, conv.bias, padding=1))
        return x

    def preprocess(self, batch_pm1: torch.Tensor) -> torch.Tensor:
        return vgg_preprocess(batch_pm1, self.bgr_mean)


def vgg_preprocess(batch_pm1: torch.Tensor,
                   mean: torch.Tensor | None = None) -> torch.Tensor:
    """[-1, 1] RGB NHWC → Caffe-style BGR in [0, 255], mean subtracted, in
    float32 (or wider). ``mean``: the BGR means on the image's device
    (``Vgg16.bgr_mean``); made here when None."""
    if mean is None:
        mean = torch.tensor(CAFFE_BGR_MEAN, device=batch_pm1.device)
    bgr = batch_pm1.flip(-1)
    return (bgr + 1.0) * 255.0 * 0.5 - mean


def convert_vgg16_state_dict(sd) -> Dict[str, torch.Tensor]:
    """The reference ``Vgg16`` state dict (``conv1_1.weight`` ...) or a
    torchvision VGG16 one (``features.{i}.*``, its classifier ignored) →
    this module's state dict (float32 CPU tensors)."""
    def tensor(v):
        return torch.as_tensor(v).detach().to("cpu", torch.float32).clone()

    if any(k.startswith("features.") for k in sd):
        src = {name: f"features.{i}"
               for name, i in zip(CONV_NAMES, TORCHVISION_INDEX)}
    else:
        src = {name: name for name in CONV_NAMES}
    return {f"{name}.{leaf}": tensor(sd[f"{key}.{leaf}"])
            for name, key in src.items() for leaf in ("weight", "bias")}
