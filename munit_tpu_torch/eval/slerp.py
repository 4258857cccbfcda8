"""Spherical style-space interpolation (slerp, utils.py:849-883).

The port's numpy copy of ``munit_tpu/eval/slerp.py``.
"""

from __future__ import annotations

import numpy as np


def slerp(val: float, low: np.ndarray, high: np.ndarray) -> np.ndarray:
    omega = np.arccos(np.clip(
        np.dot(low / np.linalg.norm(low), high / np.linalg.norm(high)),
        -1.0, 1.0))
    so = np.sin(omega)
    if so == 0:
        return (1.0 - val) * low + val * high
    return np.sin((1.0 - val) * omega) / so * low + \
        np.sin(val * omega) / so * high


def get_slerp_interp(nb_latents: int, nb_interp: int, z_dim: int,
                     rng: np.random.RandomState | None = None) -> np.ndarray:
    """Style sweep codes, shape (nb_latents*nb_interp, z_dim)
    (utils.py:866-883; the reference appends two singleton spatial dims —
    styles here are flat (B, z_dim) vectors)."""
    rng = rng or np.random.RandomState()
    outs = []
    for _ in range(nb_latents):
        low, high = rng.randn(z_dim), rng.randn(z_dim)
        for v in np.linspace(0, 1, num=nb_interp):
            outs.append(slerp(float(v), low, high).astype(np.float32))
    return np.stack(outs)
