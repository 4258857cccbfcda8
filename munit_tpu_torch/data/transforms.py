"""Host-side image transforms matching torchvision semantics.

The port's own copy of the inference subset of ``munit_tpu/data/transforms.py``:
Resize(shorter side) → crop → ToTensor → Normalize(.5, .5, .5). Arrays are
channel-last float32, images in [-1, 1].
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def resize_shorter(img: Image.Image, size: int,
                   resample=Image.BILINEAR) -> Image.Image:
    """torchvision Resize(int): shorter side → size, keep aspect ratio."""
    w, h = img.size
    if w <= h:
        nw, nh = size, max(1, round(h * size / w))
    else:
        nh, nw = size, max(1, round(w * size / h))
    if (nw, nh) == (w, h):
        return img
    return img.resize((nw, nh), resample)


def crop(img: Image.Image, i: int, j: int, h: int, w: int) -> Image.Image:
    return img.crop((j, i, j + w, i + h))


def to_array01(img: Image.Image) -> np.ndarray:
    """PIL → float32 HWC in [0,1] (ToTensor semantics, channel-last)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def normalize_pm1(arr01: np.ndarray) -> np.ndarray:
    """Normalize((0.5,)*3, (0.5,)*3): [0,1] → [-1,1]."""
    return arr01 * 2.0 - 1.0
