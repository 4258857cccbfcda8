"""Host-side image transforms matching torchvision semantics.

The port's own copy of ``munit_tpu/data/transforms.py``. The reference
pipeline (utils.py:192-250, 270-363): train: RandomHorizontalFlip →
Resize(shorter side) → RandomCrop(h, w) → ToTensor → Normalize(.5, .5,
.5); masks are flipped and cropped jointly with the image and resized
with NEAREST. Arrays are
channel-last, images float32 in [-1, 1] or, in uint8 mode, the uint8 crop
that the device normalizes (``data/loader.py::device_prefetch``).

``paths`` counts, per process, which path each ``image_transform`` call
took: the fused native pass (``munit_tpu_torch/native``) or PIL.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Optional, Tuple

import numpy as np
from PIL import Image

# grayscale value → class id (utils.py:1356-1366)
_SEM_VALUE_TABLE = {0: 0, 29: 1, 55: 2, 76: 3, 133: 4, 149: 5, 178: 6,
                    200: 7, 255: 8}
_SEM_LUT = np.arange(256, dtype=np.uint8)
_SEM_VALID = np.zeros(256, dtype=bool)
for _v, _c in _SEM_VALUE_TABLE.items():
    _SEM_LUT[_v] = _c
    _SEM_VALID[_v] = True

paths: collections.Counter = collections.Counter()
_paths_lock = threading.Lock()


def _took(path: str) -> None:
    with _paths_lock:
        paths[path] += 1


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


def crop_params(rng: np.random.Generator, img: Image.Image,
                th: int, tw: int) -> Tuple[int, int, int, int]:
    """RandomCrop.get_params: top-left (i, j) for an (th, tw) crop."""
    w, h = img.size
    if h == th and w == tw:
        return 0, 0, th, tw
    i = int(rng.integers(0, h - th + 1))
    j = int(rng.integers(0, w - tw + 1))
    return i, j, th, tw


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


def mask_to_array(mask) -> np.ndarray:
    """Reference mask loading heuristic (utils.py:316-321): masks stored as
    {0,1} are rescaled ×255 after ToTensor; {0,255} masks pass through. Both
    end as float {0,1} HW1."""
    arr = np.asarray(mask)
    if arr.ndim == 3:
        arr = arr[..., 0]
    arr = arr.astype(np.float32)
    if arr.max() != 1:
        arr = arr / 255.0
    return arr[:, :, None]


def semantic_to_classes(sem: Image.Image) -> np.ndarray:
    """Grayscale semantic PNG → int32 HW class map via the value table.
    Unmapped gray values raise (a one-hot CE would silently give them zero
    loss)."""
    arr = np.asarray(sem.convert("L"), dtype=np.uint8)
    bad = ~_SEM_VALID[arr]
    if bad.any():
        vals = np.unique(arr[bad])
        raise ValueError(
            f"semantic PNG contains unmapped gray values {vals.tolist()}; "
            f"expected one of {sorted(_SEM_VALUE_TABLE)}")
    return _SEM_LUT[arr].astype(np.int32)


def _native():
    """The fused C++ post-decode pass (``munit_tpu_torch/native``) when it
    is available; MUNIT_NATIVE_IMAGEOPS=0 forces the PIL path."""
    if os.environ.get("MUNIT_NATIVE_IMAGEOPS", "1") != "1":
        return None
    from munit_tpu_torch import native
    return native if native.available() else None


def _crop_ij(rng: np.random.Generator, h: int, w: int, th: int,
             tw: int) -> Tuple[int, int]:
    """crop_params on array dims — same draw order/conditions."""
    if h == th and w == tw:
        return 0, 0
    return int(rng.integers(0, h - th + 1)), int(rng.integers(0, w - tw + 1))


def _finish_image(crop_u8: np.ndarray, uint8_out: bool) -> np.ndarray:
    if uint8_out:
        return np.ascontiguousarray(crop_u8)
    return normalize_pm1(crop_u8.astype(np.float32) / 255.0)


def image_transform_cached(rng: Optional[np.random.Generator],
                           img_u8: np.ndarray, th: int, tw: int, train: bool,
                           uint8_out: bool = False) -> np.ndarray:
    """image_transform replayed on a decoded, resized uint8 array. Exact to
    the PIL path for the same rng: PIL's fixed-point separable resampling
    commutes with horizontal mirroring, so the crop column is mirrored
    instead. Draw order: flip, then i, then j."""
    flip = bool(train and rng is not None and rng.random() < 0.5)
    h, w = img_u8.shape[:2]
    if train and rng is not None:
        i, j = _crop_ij(rng, h, w, th, tw)
    else:
        i, j = (h - th) // 2, (w - tw) // 2
    jj = (w - tw - j) if flip else j
    out = img_u8[i:i + th, jj:jj + tw]
    if flip:
        out = out[:, ::-1]
    return _finish_image(out, uint8_out)


def image_mask_transform_cached(rng: np.random.Generator,
                                img_u8: np.ndarray,
                                mask_u8: Optional[np.ndarray],
                                mask_flip_u8: Optional[np.ndarray],
                                th: int, tw: int,
                                uint8_out: bool = False):
    """image_mask_transform replayed on cached uint8 arrays. NEAREST does
    not commute with mirroring, so the cache holds both mask orientations,
    each resized after the reference-order flip. The ×255 heuristic is
    applied per crop as in mask_to_array; in uint8 mode the mask is binary
    {0, 1}."""
    flip = rng.random() > 0.5
    h, w = img_u8.shape[:2]
    i, j = _crop_ij(rng, h, w, th, tw)
    jj = (w - tw - j) if flip else j
    out = img_u8[i:i + th, jj:jj + tw]
    if flip:
        out = out[:, ::-1]
    img = _finish_image(out, uint8_out)
    if mask_u8 is None:
        z = np.zeros((th, tw, 1), np.uint8 if uint8_out else np.float32)
        return img, z
    mc = (mask_flip_u8 if flip else mask_u8)[i:i + th, j:j + tw]
    if uint8_out:
        m = (mc.astype(np.uint8) if mc.max() == 1
             else (mc >= 128).astype(np.uint8))
        return img, np.ascontiguousarray(m[:, :, None])
    return img, mask_to_array(np.ascontiguousarray(mc))


def image_transform(rng: Optional[np.random.Generator], img: Image.Image,
                    new_size: Optional[int], th: int, tw: int,
                    train: bool, do_crop: bool = True) -> np.ndarray:
    """Single-image pipeline (get_data_loader_list, utils.py:192-250)."""
    flip = bool(train and rng is not None and rng.random() < 0.5)

    nat = _native()
    if nat is not None and new_size is not None and do_crop:
        src = np.asarray(img)
        rh, rw = nat.resized_dims(src.shape[0], src.shape[1], new_size)
        if train and rng is not None:
            i = int(rng.integers(0, rh - th + 1)) if rh > th else 0
            j = int(rng.integers(0, rw - tw + 1)) if rw > tw else 0
        else:
            i, j = (rh - th) // 2, (rw - tw) // 2
        _took("native")
        return nat.fused_transform(src, flip, new_size, i, j, th, tw)

    _took("pil")
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if new_size is not None:
        img = resize_shorter(img, new_size)
    if do_crop:
        if train and rng is not None:
            i, j, h, w = crop_params(rng, img, th, tw)
        else:
            w0, h0 = img.size
            i, j, h, w = (h0 - th) // 2, (w0 - tw) // 2, th, tw
        img = crop(img, i, j, h, w)
    return normalize_pm1(to_array01(img))


def image_mask_transform(rng: np.random.Generator, img: Image.Image,
                         mask: Optional[Image.Image], new_size: int,
                         th: int, tw: int) -> Tuple[np.ndarray, np.ndarray]:
    """Joint image+mask pipeline (MyDataset.transform, utils.py:287-337):
    shared flip, image resized BILINEAR, mask resized NEAREST to the image
    size, shared crop."""
    flip = rng.random() > 0.5
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    img = resize_shorter(img, new_size)
    i, j, h, w = crop_params(rng, img, th, tw)
    out = normalize_pm1(to_array01(crop(img, i, j, h, w)))
    if mask is None:
        return out, np.zeros((th, tw, 1), np.float32)
    if flip:
        mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
    mask = mask.resize(img.size, Image.NEAREST)
    m = mask_to_array(crop(mask, i, j, h, w))
    return out, m


def synthetic_transform(rng: np.random.Generator, img_a: Image.Image,
                        img_b: Image.Image, mask: Image.Image,
                        sem_a: Image.Image, sem_b: Image.Image,
                        new_size: int, th: int, tw: int):
    """Joint pipeline of a synthetic pair (MyDatasetSynthetic.transform,
    utils.py:483-553): one flip and one crop shared by all five inputs; the
    images resized BILINEAR, the mask and the semantics NEAREST to the
    resized B image; the mask binarized at 0.5; the semantics mapped to
    class ids. Returns (a, b, mask, sem_a, sem_b): float32 [-1, 1] HWC
    images, a float32 {0, 1} HW1 mask and int32 HW class maps."""
    if rng.random() > 0.5:
        img_a = img_a.transpose(Image.FLIP_LEFT_RIGHT)
        img_b = img_b.transpose(Image.FLIP_LEFT_RIGHT)
        mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
        sem_a = sem_a.transpose(Image.FLIP_LEFT_RIGHT)
        sem_b = sem_b.transpose(Image.FLIP_LEFT_RIGHT)
    img_a = resize_shorter(img_a, new_size)
    img_b = resize_shorter(img_b, new_size)
    mask = mask.resize(img_b.size, Image.NEAREST)
    sem_a = sem_a.resize(img_b.size, Image.NEAREST)
    sem_b = sem_b.resize(img_b.size, Image.NEAREST)
    i, j, h, w = crop_params(rng, img_b, th, tw)
    a = normalize_pm1(to_array01(crop(img_a, i, j, h, w)))
    b = normalize_pm1(to_array01(crop(img_b, i, j, h, w)))
    m = mask_to_array(crop(mask, i, j, h, w))
    m = (m > 0.5).astype(np.float32)
    sa = semantic_to_classes(crop(sem_a, i, j, h, w))
    sb = semantic_to_classes(crop(sem_b, i, j, h, w))
    return a, b, m, sa, sb
