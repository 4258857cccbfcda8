"""Kernel Inception Distance (unbiased MMD² with the polynomial kernel).

The port's numpy copy of ``munit_tpu/eval/kid.py``.

The project's metric study (docs/index.html:338, arXiv:1910.10143) compares
HYPE against IS/FID/KID; the reference repo ships only FID/IS — KID completes
the set. Standard estimator (Bińkowski et al. 2018): k(x,y) = (xᵀy/d + 1)³,
unbiased block estimator over pool-3 features.
"""

from __future__ import annotations

import numpy as np


def _poly_kernel(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    d = x.shape[1]
    return (x @ y.T / d + 1.0) ** 3


def kid(feat_fake: np.ndarray, feat_real: np.ndarray,
        n_subsets: int = 100, subset_size: int = 1000,
        rng: np.random.RandomState | None = None) -> tuple[float, float]:
    """Returns (mean, std) of the unbiased MMD² over random subsets."""
    rng = rng or np.random.RandomState(0)
    m = min(subset_size, feat_fake.shape[0], feat_real.shape[0])
    scores = []
    for _ in range(n_subsets):
        xi = feat_fake[rng.choice(feat_fake.shape[0], m, replace=False)]
        yi = feat_real[rng.choice(feat_real.shape[0], m, replace=False)]
        kxx = _poly_kernel(xi, xi)
        kyy = _poly_kernel(yi, yi)
        kxy = _poly_kernel(xi, yi)
        np.fill_diagonal(kxx, 0)
        np.fill_diagonal(kyy, 0)
        mmd2 = (kxx.sum() / (m * (m - 1)) + kyy.sum() / (m * (m - 1))
                - 2 * kxy.mean())
        scores.append(mmd2)
    return float(np.mean(scores)), float(np.std(scores))
