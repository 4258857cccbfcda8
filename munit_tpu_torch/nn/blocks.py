"""Building blocks of the generator, as ``nn.Module``s on NHWC tensors.

Counterparts of ``munit_tpu/nn/blocks.py`` (reference networks.py):
- ConvBlock   ≙ Conv2dBlock (networks.py:627-701): pad → conv → norm → act.
- LinearBlock (networks.py:704-749): linear → act; a bf16 input promotes
  to f32 against the f32 weights, as ``x @ kernel + bias`` does in JAX.
- ResBlock    (networks.py:603-624): two 3x3 conv blocks and the identity;
  the second conv block has no activation.
- MLP         (networks.py:583-597): linear blocks, linear output.

Parameter names follow the reference ``state_dict`` layout
(``model.{i}.conv.weight``, ``norm.{gamma,beta}``, ``model.{i}.fc.weight``),
so a reference checkpoint loads with ``load_state_dict``. AdaIN layers hold
no parameters: their (gamma, beta) come down the call from the style MLP.
Norms run through the Hopper kernels' wrappers (``kernels/norms.py``), which
fuse the ReLU that follows them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from munit_tpu_torch.core import ops
from munit_tpu_torch.kernels import norms

AdainPair = Tuple[torch.Tensor, torch.Tensor]  # (gamma (B,C), beta (B,C))


class LayerNormParams(nn.Module):
    """The per-channel gamma, beta of the fork's whole-tensor LayerNorm."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))
        self.beta = nn.Parameter(torch.empty(dim))


class ConvBlock(nn.Module):
    """pad → conv → norm → activation. norm: none | in | ln | adain."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int,
                 stride: int, padding: int = 0, norm: str = "none",
                 activ: str = "relu", pad_type: str = "zero"):
        super().__init__()
        if norm not in ("none", "in", "ln", "adain"):
            raise ValueError(f"Unsupported normalization: {norm}")
        self.stride, self.padding, self.pad_type = stride, padding, pad_type
        self.norm_type, self.activ = norm, activ
        self.act = ops.activation(activ)
        self.conv = nn.Conv2d(in_dim, out_dim, kernel_size, stride)
        if norm == "ln":
            self.norm = LayerNormParams(out_dim)

    def forward(self, x: torch.Tensor,
                adain_params: Optional[AdainPair] = None) -> torch.Tensor:
        x = ops.pad2d(x, self.padding, self.pad_type)
        x = ops.conv2d(x, self.conv.weight, self.conv.bias, self.stride)
        relu = self.activ == "relu"
        if self.norm_type == "in":
            x = norms.instance_norm(x, relu=relu)
        elif self.norm_type == "adain":
            if adain_params is None:
                raise ValueError("an AdaIN ConvBlock needs (gamma, beta)")
            x = norms.adain(x, adain_params[0], adain_params[1], relu=relu)
        elif self.norm_type == "ln":
            x = norms.whole_layer_norm(x, self.norm.gamma, self.norm.beta,
                                       relu=relu)
        else:
            return self.act(x)
        return x if relu else self.act(x)


class LinearBlock(nn.Module):
    """linear → activation."""

    def __init__(self, in_dim: int, out_dim: int, activ: str = "relu"):
        super().__init__()
        self.fc = nn.Linear(in_dim, out_dim)
        self.act = ops.activation(activ)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(ops.linear(x, self.fc.weight, self.fc.bias))


class ResBlock(nn.Module):
    def __init__(self, dim: int, norm: str = "in", activ: str = "relu",
                 pad_type: str = "zero"):
        super().__init__()
        self.model = nn.ModuleList([
            ConvBlock(dim, dim, 3, 1, 1, norm, activ, pad_type),
            ConvBlock(dim, dim, 3, 1, 1, norm, "none", pad_type)])

    def forward(self, x: torch.Tensor,
                adain_params: Optional[Sequence[AdainPair]] = None):
        p0, p1 = adain_params if adain_params is not None else (None, None)
        return x + self.model[1](self.model[0](x, p0), p1)


class ResBlocks(nn.Module):
    def __init__(self, num_blocks: int, dim: int, norm: str = "in",
                 activ: str = "relu", pad_type: str = "zero"):
        super().__init__()
        self.model = nn.ModuleList(
            [ResBlock(dim, norm, activ, pad_type) for _ in range(num_blocks)])

    def forward(self, x: torch.Tensor,
                adain_params: Optional[Sequence[AdainPair]] = None):
        for i, block in enumerate(self.model):
            pair = (adain_params[2 * i:2 * i + 2]
                    if adain_params is not None else None)
            x = block(x, pair)
        return x


class MLP(nn.Module):
    """Style → AdaIN-parameter MLP: input flattened, n_blk linear blocks,
    the last without activation."""

    def __init__(self, in_dim: int, out_dim: int, dim: int, n_blk: int = 3,
                 activ: str = "relu"):
        super().__init__()
        dims = [in_dim] + [dim] * (n_blk - 1)
        blocks = [LinearBlock(i, o, activ) for i, o in zip(dims, dims[1:])]
        blocks.append(LinearBlock(dim, out_dim, "none"))
        self.model = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for block in self.model:
            x = block(x)
        return x
