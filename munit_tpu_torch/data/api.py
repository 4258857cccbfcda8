"""Loader factories: the port's copy of ``munit_tpu/data/api.py`` for the
list, folder, image-and-mask and synthetic-pair loaders (reference
get_all_data_loaders utils.py:50-156; get_data_loader_list :192-250;
get_data_loader_mask_and_im :638-677; get_synthetic_data_loader :552-635;
get_data_loader_folder :680-740).

The threaded ``DataLoader`` is the only backend: ``MUNIT_LOADER=grain``,
the JAX package's Grain-backed loader, is not ported and raises.
"""

from __future__ import annotations

import os

from munit_tpu_torch.data.datasets import (ImageFilelist, ImageFolder,
                                           ImageMaskDataset,
                                           SyntheticPairDataset)
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
