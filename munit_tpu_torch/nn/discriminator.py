"""The multi-scale PatchGAN discriminator as an ``nn.Module`` on NHWC tensors.

Counterpart of ``munit_tpu/nn/discriminator.py`` (reference
networks.py:20-162): ``num_scales`` identical CNNs, the input downsampled by
AvgPool(3, s2, p1, count_include_pad=False) between scales. Each CNN is a
4x4 s2 conv block without norm, (n_layer - 1) doubling 4x4 s2 conv blocks
and a bare 1x1 conv to one logit per patch. The output is the list of
per-scale logit maps (B, h_s, w_s, 1).

Parameter names follow the reference ``state_dict`` (``cnns.{s}.{i}.conv.*``
for the blocks, ``cnns.{s}.{n_layer}.*`` for the logit conv), as
``munit_tpu/io/torch_import.py::export_dis_state_dict`` writes them. The
losses over the logit maps are in ``munit_tpu_torch/losses``.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from munit_tpu_torch.core import init as winit
from munit_tpu_torch.core import ops
from munit_tpu_torch.nn.blocks import ConvBlock


def _dis_cnn(input_dim: int, n_layer: int, dim: int, norm: str, activ: str,
             pad_type: str) -> nn.ModuleList:
    layers = [ConvBlock(input_dim, dim, 4, 2, 1, "none", activ, pad_type)]
    for _ in range(n_layer - 1):
        layers.append(ConvBlock(dim, 2 * dim, 4, 2, 1, norm, activ, pad_type))
        dim *= 2
    layers.append(nn.Conv2d(dim, 1, 1))
    return nn.ModuleList(layers)


class MsImageDis(nn.Module):
    def __init__(self, input_dim: int, n_layer: int = 4, dim: int = 64,
                 norm: str = "none", activ: str = "lrelu",
                 num_scales: int = 3, pad_type: str = "reflect"):
        super().__init__()
        self.cnns = nn.ModuleList(
            [_dis_cnn(input_dim, n_layer, dim, norm, activ, pad_type)
             for _ in range(num_scales)])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for s, cnn in enumerate(self.cnns):
            y = x
            for block in cnn[:-1]:
                y = block(y)
            out = cnn[-1]
            outs.append(ops.conv2d(y, out.weight, out.bias))
            if s + 1 < len(self.cnns):
                x = ops.avg_pool_3x3_s2(x)
        return outs

    def init(self, generator: torch.Generator) -> None:
        """Seeded reference init: N(0, 0.02) weights, zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                winit.gaussian(m.weight, generator)
                winit.zeros(m.bias)


def build(conf: dict, device="cuda") -> MsImageDis:
    """One discriminator of a config, on ``device``, channels-last."""
    d = conf["dis"]
    if d["norm"] not in ("none", "in"):
        raise NotImplementedError(
            f"dis norm '{d['norm']}' is not ported (none and in are)")
    dis = MsImageDis(conf["input_dim_a"], d["n_layer"], d["dim"], d["norm"],
                     d["activ"], d["num_scales"], d["pad_type"])
    return dis.to(device=device, memory_format=torch.channels_last)
