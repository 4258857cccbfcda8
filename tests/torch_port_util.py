"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Weights are made with numpy from a seed in the reference ``state_dict``
layout, so the JAX package (through ``convert_gen_state_dict``) and the port
run the same numbers: torch and jax.random give different draws per seed.
"""

from __future__ import annotations

import numpy as np

from munit_tpu_torch.nn.generator import AdaINGenDual

SMALL_GEN = dict(dim=16, mlp_dim=32, style_dim=8, activ="relu",
                 n_downsample=2, n_res=2, pad_type="reflect")


def port_module(gen: dict, input_dim: int = 3) -> AdaINGenDual:
    return AdaINGenDual(input_dim, gen["dim"], gen["style_dim"],
                        gen["n_downsample"], gen["n_res"], gen["mlp_dim"],
                        gen["activ"], gen["pad_type"])


def ref_layout_weights(gen: dict, seed: int = 0) -> dict:
    """Kaiming-scaled weights, small random biases, U[0,1) LayerNorm gammas:
    every parameter of the dual generator, as float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sorted(port_module(gen).state_dict().items()):
        shape = tuple(v.shape)
        if k.endswith("norm.gamma"):
            a = rng.rand(*shape)
        elif k.endswith("weight"):
            fan_in = int(np.prod(shape[1:]))
            a = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        else:  # conv / linear biases, LayerNorm betas
            a = rng.randn(*shape) * 0.1
        out[k] = a.astype(np.float32)
    return out
