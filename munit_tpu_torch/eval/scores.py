"""Inception Score / Conditional IS (test_batch.py:138-208 semantics).

The port's numpy copy of ``munit_tpu/eval/scores.py``.

IS  = exp(mean_x KL(p(y|x) ‖ p(y))), prior from ALL outputs.
CIS = same but the prior is computed per input image over its num_style
      outputs.
preds: softmax class distributions, shape (num_images, num_style, C) or a
flat (N, C) for IS.
"""

from __future__ import annotations

import numpy as np


def _kl(pyx: np.ndarray, py: np.ndarray) -> float:
    """scipy.stats.entropy(pyx, py): normalizes both, sum pyx*log(pyx/py)."""
    pyx = pyx / pyx.sum()
    py = py / py.sum()
    mask = pyx > 0
    return float(np.sum(pyx[mask] * np.log(pyx[mask] / py[mask])))


def inception_score(preds: np.ndarray) -> float:
    preds = preds.reshape(-1, preds.shape[-1])
    py = preds.sum(axis=0)
    kls = [_kl(preds[i], py) for i in range(preds.shape[0])]
    return float(np.exp(np.mean(kls)))


def conditional_inception_score(preds: np.ndarray) -> float:
    """preds: (num_images, num_style, C)."""
    kls = []
    for i in range(preds.shape[0]):
        cur = preds[i]
        py = cur.sum(axis=0)
        kls.extend(_kl(cur[j], py) for j in range(cur.shape[0]))
    return float(np.exp(np.mean(kls)))
