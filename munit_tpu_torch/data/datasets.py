"""Datasets (index → sample): the port's copy of
``munit_tpu/data/datasets.py`` for the list, folder, image-and-mask,
synthetic-pair and FID-pair datasets.

A dataset is a sized object whose ``get(index, rng)`` returns a dict of
numpy arrays: NHWC images, float32 in [-1, 1] or uint8 (see
``_uint8_out_default``), and masks, float32 {0, 1} or uint8 {0, 1}.
Randomness comes from the per-call ``rng``, so epochs are reproducible and
can be sharded.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from munit_tpu_torch.data import transforms as T


class _DecodeCache:
    """Byte-bounded RAM cache of decoded and resized uint8 arrays.

    Each image is drawn many times, but its decode and resize do not depend
    on the draw (only the flip and crop do), so a cached array makes each
    later draw a crop and flip of a slice. Thread-safe; stops inserting at
    its budget (no eviction: epochs revisit the same indices)."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self.data: Dict[int, tuple] = {}
        self.nbytes = 0
        self.lock = threading.Lock()

    def get(self, key):
        return self.data.get(key)

    def put(self, key, arrays: tuple):
        size = sum(int(a.nbytes) for a in arrays if a is not None)
        with self.lock:
            if key in self.data or self.nbytes + size > self.budget:
                return
            self.data[key] = arrays
            self.nbytes += size


def _cache_budget_bytes() -> int:
    """MUNIT_CACHE_MB (default 2048; 0 disables the decoded-image cache)."""
    return int(os.environ.get("MUNIT_CACHE_MB", "2048")) << 20


def _uint8_out_default(train: bool) -> bool:
    """MUNIT_LOADER_UINT8 (default on for training datasets): emit uint8
    images and binary masks, which ``device_prefetch`` normalizes on the
    device (a quarter of the host-to-device bytes, no float conversion on
    the host). Eval datasets (train=False) keep float32 output."""
    return train and os.environ.get("MUNIT_LOADER_UINT8", "1") == "1"


def _setup_cache(obj, cache_mb, uint8_out, cacheable: bool,
                 train: bool = True):
    budget = _cache_budget_bytes() if cache_mb is None else cache_mb << 20
    obj.cache = _DecodeCache(budget) if budget > 0 and cacheable else None
    obj.uint8_out = (_uint8_out_default(train) if uint8_out is None
                     else uint8_out)


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".JPG", ".JPEG",
                  ".PNG", ".PPM", ".BMP")


def read_filelist(path: str) -> List[str]:
    """txt list, one path per line (default_txt_reader, utils.py:253-266)."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if parts:
                out.append(parts[0])
    return out


def scan_folder(folder: str) -> List[str]:
    """Recursive scan by extension (data.py ImageFolder/make_dataset)."""
    images = []
    for root, _, fnames in sorted(os.walk(folder)):
        for fname in sorted(fnames):
            if fname.endswith(IMG_EXTENSIONS):
                images.append(os.path.join(root, fname))
    if not images:
        raise RuntimeError(f"Found 0 images in: {folder}")
    return images


def _open_rgb(path: str) -> Image.Image:
    return Image.open(path).convert("RGB")


class ImageFilelist:
    """root + txt list of paths → transformed image (data.py:26-49)."""

    def __init__(self, root: str, flist: str, new_size: Optional[int],
                 height: int, width: int, train: bool, crop: bool = True,
                 cache_mb: Optional[int] = None,
                 uint8_out: Optional[bool] = None):
        self.root = root
        self.paths = read_filelist(flist)
        self.new_size, self.h, self.w = new_size, height, width
        self.train, self.crop = train, crop
        _setup_cache(self, cache_mb, uint8_out, bool(new_size and crop),
                     train=train)

    def __len__(self):
        return len(self.paths)

    def get(self, index: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        if self.cache is not None:
            hit = self.cache.get(index)
            if hit is None:
                img = _open_rgb(os.path.join(self.root, self.paths[index]))
                hit = (np.asarray(T.resize_shorter(img, self.new_size)),)
                self.cache.put(index, hit)
            x = T.image_transform_cached(rng, hit[0], self.h, self.w,
                                         self.train, self.uint8_out)
            return {"image": x}
        img = _open_rgb(os.path.join(self.root, self.paths[index]))
        x = T.image_transform(rng, img, self.new_size, self.h, self.w,
                              self.train, self.crop)
        if self.uint8_out:
            x = np.round((x + 1.0) * 127.5).astype(np.uint8)
        return {"image": x}


class ImageFolder(ImageFilelist):
    """Recursive folder dataset (data.py:109-155); optionally returns paths."""

    def __init__(self, folder: str, new_size: Optional[int], height: int,
                 width: int, train: bool, crop: bool = True,
                 return_paths: bool = False,
                 cache_mb: Optional[int] = None,
                 uint8_out: Optional[bool] = None):
        self.root = ""
        self.paths = scan_folder(folder)
        self.new_size, self.h, self.w = new_size, height, width
        self.train, self.crop = train, crop
        self.return_paths = return_paths
        _setup_cache(self, cache_mb, uint8_out, bool(new_size and crop),
                     train=train)

    def get(self, index, rng):
        out = super().get(index, rng)
        if self.return_paths:
            out["path"] = self.paths[index]
        return out


class ImageMaskDataset:
    """(image, water/ground mask) pairs with joint transform
    (MyDataset, utils.py:270-363)."""

    def __init__(self, file_list: str, mask_list: Optional[str],
                 new_size: int, height: int, width: int,
                 cache_mb: Optional[int] = None,
                 uint8_out: Optional[bool] = None):
        self.paths = read_filelist(file_list)
        self.mask_paths = read_filelist(mask_list) if mask_list else None
        self.new_size, self.h, self.w = new_size, height, width
        _setup_cache(self, cache_mb, uint8_out, bool(new_size))

    def __len__(self):
        return len(self.paths)

    def _decode_resized(self, index):
        img = T.resize_shorter(_open_rgb(self.paths[index]),
                               self.new_size)
        mask = mask_flip = None
        if self.mask_paths:
            def prep(m):
                arr = np.asarray(m.resize(img.size, Image.NEAREST))
                if arr.ndim == 3:
                    arr = arr[..., 0]
                return (arr if arr.dtype == np.uint8
                        else arr.astype(np.uint8))
            m = Image.open(self.mask_paths[index])
            # NEAREST does not commute with mirroring: both orientations
            mask = prep(m)
            mask_flip = prep(m.transpose(Image.FLIP_LEFT_RIGHT))
        return np.asarray(img), mask, mask_flip

    def get(self, index, rng):
        if self.cache is not None:
            hit = self.cache.get(index)
            if hit is None:
                hit = self._decode_resized(index)
                self.cache.put(index, hit)
            x, m = T.image_mask_transform_cached(rng, hit[0], hit[1], hit[2],
                                                 self.h, self.w,
                                                 self.uint8_out)
            return {"image": x, "mask": m}
        img = _open_rgb(self.paths[index])
        mask = (Image.open(self.mask_paths[index])
                if self.mask_paths else None)
        x, m = T.image_mask_transform(rng, img, mask, self.new_size,
                                      self.h, self.w)
        if self.uint8_out:
            x = np.round((x + 1.0) * 127.5).astype(np.uint8)
            m = (m > 0.5).astype(np.uint8)
        return {"image": x, "mask": m}


class SyntheticPairDataset:
    """Synthetic 5-tuples (image_a, image_b, mask, sem_a, sem_b)
    (MyDatasetSynthetic, utils.py:458-635): a rendered scene and its
    flooded twin, the flood mask, and both semantic maps, through one
    shared flip and crop (``transforms.synthetic_transform``). Images are
    float32 in [-1, 1], the mask float32 {0, 1}, the semantics int32 class
    ids; nothing is cached."""

    def __init__(self, list_a: str, list_b: str, mask_list: str,
                 sem_list_a: str, sem_list_b: str, new_size: int,
                 height: int, width: int):
        self.a = read_filelist(list_a)
        self.b = read_filelist(list_b)
        self.masks = read_filelist(mask_list)
        self.sem_a = read_filelist(sem_list_a)
        self.sem_b = read_filelist(sem_list_b)
        self.new_size, self.h, self.w = new_size, height, width

    def __len__(self):
        return len(self.a)

    def get(self, index, rng):
        a, b, m, sa, sb = T.synthetic_transform(
            rng, _open_rgb(self.a[index]), _open_rgb(self.b[index]),
            Image.open(self.masks[index]).convert("L"),
            Image.open(self.sem_a[index]).convert("L"),
            Image.open(self.sem_b[index]).convert("L"),
            self.new_size, self.h, self.w)
        return {"image_a": a, "image_b": b, "mask": m,
                "sem_a": sa, "sem_b": sb}


class FidPairDataset:
    """Paired (a, b) images for FID, shorter side resized to ``new_size``,
    nothing cropped (DatasetInferenceFID, utils.py:366-455), float32 in
    [-1, 1]. The reference's ``image_b = normalizer(image_a)`` copy-paste
    bug (utils.py:401) is fixed, as in the JAX package: b is image_b."""

    def __init__(self, list_a: str, list_b: str, new_size: int):
        self.a = read_filelist(list_a)
        self.b = read_filelist(list_b)
        self.new_size = new_size

    def __len__(self):
        return len(self.a)

    def _image(self, path):
        return T.normalize_pm1(T.to_array01(
            T.resize_shorter(_open_rgb(path), self.new_size)))

    def get(self, index, rng):
        return {"image_a": self._image(self.a[index]),
                "image_b": self._image(self.b[index])}
