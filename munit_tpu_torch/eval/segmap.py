"""Cityscapes colormap for segmentation visualizations: the port's copy of
``munit_tpu/eval/segmap.py`` (decode_segmap, utils.py:986-1026)."""

from __future__ import annotations

import numpy as np

_CITYSCAPES_COLORS = np.asarray([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32]], dtype=np.uint8)


def decode_segmap(label_map: np.ndarray, nc: int = 19) -> np.ndarray:
    """(H, W) int class map → (H, W, 3) uint8 RGB. Labels >= nc map to black
    (matches the reference's loop leaving them zero)."""
    label_map = np.asarray(label_map)
    out = np.zeros(label_map.shape + (3,), np.uint8)
    valid = label_map < min(nc, len(_CITYSCAPES_COLORS))
    out[valid] = _CITYSCAPES_COLORS[label_map[valid]]
    return out
