"""Precompute the Inception pool moments (mu, sigma) of a real-image set:
the port's counterpart of ``munit_tpu/cli/compute_moments.py``.

The reference reads a precomputed ``inception_moments.npz`` of "900
flooded images" (configs/config_256.yaml:63-64) and ships no tool to make
it. Each image is resized (shorter side to ``--new_size``), centre-cropped
to a square so batches stack, and pooled by InceptionV3 on the card; the
file holds ``mu`` (float32), ``sigma`` (``np.cov``, float64) and the raw
``pool`` (float32, for ``evaluate fid --kid``), as the JAX CLI writes it,
so either package's ``evaluate`` reads either's file.

  python -m munit_tpu_torch compute_moments --images trainB.txt \\
      --inception_ckpt inception.pth --out moments.npz [--device cpu]

``--images``: a txt list of paths or a folder. ``--mesh auto`` pools on
every visible card (``dist.Replicas``, the JAX command's ``--mesh auto``):
an Inception on each, every batch padded to a multiple of the cards by
repeating its last image and split, the pools gathered and the pad's rows
sliced off. With one card, or on the CPU, it is the run without it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from munit_tpu_torch.cli.translate import resolve_device
from munit_tpu_torch.data import transforms as T
from munit_tpu_torch.data.datasets import read_filelist, scan_folder
from munit_tpu_torch.dist.mesh import Replicas, mesh_devices
from munit_tpu_torch.eval.inception import load_inception, pool_and_logits


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m munit_tpu_torch compute_moments")
    p.add_argument("--images", required=True,
                   help="txt list of image paths, or a folder")
    p.add_argument("--inception_ckpt", required=True,
                   help="InceptionV3 weights: torchvision .pth, .npz, or "
                        "the JAX CLIs' pickle")
    p.add_argument("--out", required=True)
    p.add_argument("--new_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--mesh", choices=["off", "auto"], default="off",
                   help="auto: every batch split over every visible card")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def load_square(path: str, size: int) -> np.ndarray:
    """Shorter side to ``size``, centre crop ``size``², [-1, 1] float32."""
    img = T.resize_shorter(Image.open(path).convert("RGB"), size)
    w, h = img.size
    img = T.crop(img, (h - size) // 2, (w - size) // 2, size, size)
    return T.normalize_pm1(T.to_array01(img))


@torch.inference_mode()
def main(argv=None):
    """Writes the moments file; returns its arrays {mu, sigma, pool}."""
    opts = parse_args(argv)
    device = resolve_device(opts.device)
    paths = (scan_folder(opts.images) if os.path.isdir(opts.images)
             else read_filelist(opts.images))
    reps = Replicas(mesh_devices(opts.mesh, device))
    nets = [load_inception(opts.inception_ckpt, d) for d in reps.devices]
    pools = []
    for i in range(0, len(paths), opts.batch_size):
        x = np.stack([load_square(p, opts.new_size)
                      for p in paths[i:i + opts.batch_size]])
        pool = reps(lambda j, x_j: pool_and_logits(nets[j], x_j)[0],
                    torch.from_numpy(x))
        pools.append(pool.cpu().numpy())
    pool = np.concatenate(pools, axis=0)
    out = {"mu": pool.mean(axis=0), "sigma": np.cov(pool, rowvar=False),
           "pool": pool.astype(np.float32)}
    np.savez(opts.out, **out)
    print(f"Wrote moments (+pool) of {len(pool)} images to {opts.out}")
    return out


if __name__ == "__main__":
    main()
