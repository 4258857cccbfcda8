"""Seeded weight initializers matching the reference's ``weights_init``
(utils.py:1066-1089), for runs without a checkpoint.

- generators: ``kaiming_normal_(a=0, mode='fan_in')`` on conv and linear
  weights, zero bias (``init: kaiming`` in config_256.yaml);
- the custom LayerNorm gamma: ``uniform_()`` → U[0,1) (networks.py:859).

Weights are in torch layout (OIHW convs, (out, in) linears). Every draw takes
an explicit ``torch.Generator``, so a seed fixes the weights. A torch
generator gives other numbers than ``jax.random`` from the same seed; tests
that compare the two packages make their weights with numpy instead.
"""

from __future__ import annotations

import math

import torch


def _fan_in(shape) -> int:
    if len(shape) == 4:  # OIHW conv weight
        return shape[1] * shape[2] * shape[3]
    if len(shape) == 2:  # (out, in) linear weight
        return shape[1]
    raise ValueError(f"Unsupported weight shape {tuple(shape)}")


@torch.no_grad()
def kaiming_normal(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """kaiming_normal_(a=0, mode='fan_in'): N(0, sqrt(2/fan_in))."""
    std = math.sqrt(2.0 / _fan_in(t.shape))
    return t.copy_(torch.randn(t.shape, generator=generator) * std)


@torch.no_grad()
def uniform01(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """U[0,1): custom-LayerNorm gamma init (networks.py:859)."""
    return t.copy_(torch.rand(t.shape, generator=generator))


@torch.no_grad()
def zeros(t: torch.Tensor) -> torch.Tensor:
    return t.zero_()


def by_name(name: str):
    """Map config ``init:`` values to the weight initializer. Only the
    generator's default is ported so far."""
    table = {"kaiming": kaiming_normal, "default": kaiming_normal}
    if name not in table:
        raise ValueError(f"Unsupported initialization: {name}")
    return table[name]
