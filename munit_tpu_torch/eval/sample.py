"""Image-grid writer: the port's copy of ``munit_tpu/eval/sample.py``
(__write_images/write_2images, utils.py:768-814). The output list's first
half is the a→b panel, the second half b→a; each panel is a grid with
nrow=display_size, min-max normalized as torchvision make_grid(normalize=
True) does."""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
from PIL import Image


def make_grid(images: np.ndarray, nrow: int) -> np.ndarray:
    """(N, H, W, C) → tiled (rows*H, nrow*W, C) uint8, min-max normalized
    over the whole tensor (torchvision normalize=True, no per-image
    scaling)."""
    n, h, w, c = images.shape
    lo, hi = images.min(), images.max()
    imgs = (images - lo) / max(hi - lo, 1e-5)
    rows = int(np.ceil(n / nrow))
    canvas = np.zeros((rows * h, nrow * w, c), np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        canvas[r * h:(r + 1) * h, col * w:(col + 1) * w] = imgs[i]
    return (canvas * 255).round().astype(np.uint8)


def _host(o) -> np.ndarray:
    if isinstance(o, torch.Tensor):
        return o.detach().float().cpu().numpy()
    return np.asarray(o)


def _write_panel(outputs: List, display_num: int, path: str):
    imgs = np.concatenate([_host(o)[:display_num] for o in outputs])
    grid = make_grid(imgs, nrow=display_num)
    if grid.shape[-1] == 1:
        grid = np.repeat(grid, 3, axis=-1)
    Image.fromarray(grid).save(path)


def write_2images(image_outputs, display_num: int, image_directory: str,
                  postfix: str):
    """Write gen_a2b_<postfix>.jpg / gen_b2a_<postfix>.jpg panels of numpy
    arrays or tensors."""
    n = len(image_outputs)
    os.makedirs(image_directory, exist_ok=True)
    a2b = os.path.join(image_directory, f"gen_a2b_{postfix}.jpg")
    b2a = os.path.join(image_directory, f"gen_b2a_{postfix}.jpg")
    _write_panel(list(image_outputs[:n // 2]), display_num, a2b)
    _write_panel(list(image_outputs[n // 2:]), display_num, b2a)
    return a2b, b2a
