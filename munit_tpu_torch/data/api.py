"""Loader factories: the port's copy of ``munit_tpu/data/api.py`` (reference
get_all_data_loaders utils.py:50-156; get_data_loader_list :192-250;
get_data_loader_mask_and_im :638-677; get_synthetic_data_loader :552-635;
get_fid_data_loader :408-455; get_data_loader_folder :680-740).

The threaded ``DataLoader`` is the only backend: ``MUNIT_LOADER=grain``,
the JAX package's Grain-backed loader, is not ported and raises.
"""

from __future__ import annotations

import os
import sys

from PIL import Image

from munit_tpu_torch.data.datasets import (FidPairDataset, ImageFilelist,
                                           ImageFolder, ImageMaskDataset,
                                           SyntheticPairDataset,
                                           read_filelist)
from munit_tpu_torch.data.loader import DataLoader as _ThreadedDataLoader


def DataLoader(*args, **kwargs):
    if os.environ.get("MUNIT_LOADER", "threads") == "grain":
        raise NotImplementedError(
            "MUNIT_LOADER=grain (the Grain-backed loader) is not ported; "
            "ROADMAP queue 1 item 19")
    return _ThreadedDataLoader(*args, **kwargs)


def get_data_loader_list(root, file_list, batch_size, train, new_size=None,
                         height=256, width=256, num_workers=4, crop=True,
                         seed=0, **shard):
    ds = ImageFilelist(root, file_list, new_size, height, width, train, crop)
    return DataLoader(ds, batch_size, shuffle=train, num_workers=num_workers,
                      seed=seed, **shard)


def get_data_loader_folder(input_folder, batch_size, train, new_size=None,
                           height=256, width=256, num_workers=4, crop=True,
                           return_paths=False, seed=0, **shard):
    ds = ImageFolder(input_folder, new_size, height, width, train, crop,
                     return_paths=return_paths)
    return DataLoader(ds, batch_size, shuffle=train, num_workers=num_workers,
                      seed=seed, **shard)


def get_data_loader_mask_and_im(file_list, mask_list, batch_size, train,
                                new_size=None, height=256, width=256,
                                num_workers=4, crop=True, seed=0, **shard):
    ds = ImageMaskDataset(file_list, mask_list, new_size, height, width)
    return DataLoader(ds, batch_size, shuffle=train, num_workers=num_workers,
                      seed=seed, **shard)


def get_synthetic_data_loader(file_list_a, file_list_b, mask_list, sem_list_a,
                              sem_list_b, batch_size, train, new_size=256,
                              height=256, width=256, num_workers=4, crop=True,
                              seed=0, **shard):
    ds = SyntheticPairDataset(file_list_a, file_list_b, mask_list, sem_list_a,
                              sem_list_b, new_size, height, width)
    return DataLoader(ds, batch_size, shuffle=train, num_workers=num_workers,
                      seed=seed, **shard)


def _resized_shapes(paths, new_size):
    """The (H, W) of each image after the shorter-side resize, from the
    files' headers alone (no decode); the rounding is
    ``transforms.resize_shorter``'s."""
    shapes = set()
    for p in paths:
        with Image.open(p) as im:
            w, h = im.size
        if w <= h:
            shapes.add((max(1, round(h * new_size / w)), new_size))
        else:
            shapes.add((new_size, max(1, round(w * new_size / h))))
    return shapes


def get_fid_data_loader(file_list_a, file_list_b, batch_size, new_size=256,
                        num_workers=4, seed=0, **shard):
    """Paired FID batches in list order. The FID transform only resizes,
    so lists of mixed aspect ratios give batches that cannot stack (the
    reference's DataLoader crashes there): such lists fall back to batches
    of one image, which the Inception protocol's resize to 299² makes
    exact. Each list need only be uniform within itself: image_a and
    image_b stack as separate keys."""
    ds = FidPairDataset(file_list_a, file_list_b, new_size)
    if batch_size > 1 and any(
            len(_resized_shapes(read_filelist(f), new_size)) > 1
            for f in (file_list_a, file_list_b)):
        print("fid loader: mixed image shapes after resize — using "
              "batch_size=1", file=sys.stderr)
        batch_size = 1
    return DataLoader(ds, batch_size, shuffle=False, num_workers=num_workers,
                      seed=seed, **shard)


def get_all_data_loaders(conf, seed=0, **shard):
    """trainA/B + testA/B loaders (utils.py:50-156). Folder mode via
    ``data_root``; list mode via ``data_folder_*``/``data_list_*``."""
    bs, nw = conf["batch_size"], conf["num_workers"]
    new_size = conf.get("new_size")
    h, w = conf["crop_image_height"], conf["crop_image_width"]
    if conf.get("data_root"):
        def folder(sub, train, hh, ww):
            return get_data_loader_folder(
                os.path.join(conf["data_root"], sub), bs, train, new_size,
                hh, ww, nw, True, seed=seed, **shard)
        return (folder("trainA", True, h, w), folder("trainB", True, h, w),
                folder("testA", False, new_size, new_size),
                folder("testB", False, new_size, new_size))

    def listed(root_k, list_k, train, hh, ww):
        return get_data_loader_list(conf[root_k], conf[list_k], bs, train,
                                    new_size, hh, ww, nw, True, seed=seed,
                                    **shard)
    return (
        listed("data_folder_train_a", "data_list_train_a", True, h, w),
        listed("data_folder_train_b", "data_list_train_b", True, h, w),
        listed("data_folder_test_a", "data_list_test_a", False, new_size,
               new_size),
        listed("data_folder_test_b", "data_list_test_b", False, new_size,
               new_size),
    )
