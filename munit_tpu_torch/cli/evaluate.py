"""Evaluation CLI, the port's counterpart of ``munit_tpu/cli/evaluate.py``:
FID (and KID) against precomputed real moments, and slerp style sweeps.

  python -m munit_tpu_torch evaluate fid --config c.yaml \\
      --checkpoint gen.pt --inception_ckpt inception.pth [--kid] \\
      [--device cuda|cpu]

FID: each pair of the config's FID lists (``data_list_fid_a``/``_b``,
``batch_size_fid``, ``new_size``) translated a→b with b's style, its
Inception pool-3 vector taken, on the card; the Fréchet distance of the
pools to ``inception_moment_path``'s moments (``compute_moments``; the JAX
package's files read too). On the card the distance goes through 400
Newton-Schulz iterations, with scipy's ``sqrtm`` when they do not
converge, as the JAX CLI; on the CPU straight through scipy, the JAX
package's own choice for CPU hosts (``prepare_inception_metrics(
use_jax=False)``). ``--kid`` also reports the Kernel Inception Distance
against the moments file's raw real ``pool``.

Sweep (utils.py:849-883): one content image decoded under spherically
interpolated styles, frame by frame:

  python -m munit_tpu_torch evaluate sweep --config c.yaml \\
      --checkpoint gen.pt --input img.jpg [--nb_interp 8] [--device cpu]

The generator comes from any file ``translate`` reads, its convolutions in
float32 with TF32 off (``ops.set_conv_compute(None)``) as the JAX CLI's
``Precision.HIGHEST``; the Inception from
a torchvision ``inception_v3`` ``.pth``, an ``.npz`` or the JAX CLIs'
pickle.

``--mesh auto`` runs on every visible card (``dist.Replicas``, the JAX
command's ``--mesh auto``): a generator and an Inception on each, every
FID batch padded to a multiple of the cards by repeating its last pair and
split, each card translating and pooling its contiguous part, the pools
gathered and the pad's rows sliced off; a sweep decodes as many frames at
once as there are cards, one a card. With one card, or on the CPU, either
command is the run without it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from munit_tpu_torch.cli.translate import (load_generator, load_image,
                                           resolve_device, save_image01)
from munit_tpu_torch.config import get_config
from munit_tpu_torch.core import ops
from munit_tpu_torch.dist.mesh import Replicas, mesh_devices


def fid_pools(reps: Replicas, gens, inceptions, batches) -> np.ndarray:
    """The pool-3 vectors (N, 2048) of each batch's guided a→b
    translations, each batch split over ``reps``' devices, with their
    generators ``gens`` and Inceptions ``inceptions``."""
    from munit_tpu_torch.eval.fid import accumulate_activations, guided_a2b
    from munit_tpu_torch.eval.inception import pool_and_logits

    def pool(i, x_a, x_b):
        return pool_and_logits(inceptions[i],
                               guided_a2b(gens[i], x_a, x_b))[0]
    return accumulate_activations(reps, pool, batches)


def cmd_fid(opts):
    """FID (a float), or with ``--kid`` {"fid", "kid", "kid_std"}."""
    from munit_tpu_torch.data.api import get_fid_data_loader
    from munit_tpu_torch.eval.fid import compute_fid_from_pools
    from munit_tpu_torch.eval.inception import load_inception
    from munit_tpu_torch.eval.kid import kid

    device = resolve_device(opts.device)
    ops.set_conv_compute(None)
    conf = get_config(opts.config)
    reps = Replicas(mesh_devices(opts.mesh, device))
    gens = [load_generator(opts.checkpoint, conf, d) for d in reps.devices]
    nets = [load_inception(opts.inception_ckpt, d) for d in reps.devices]
    loader = get_fid_data_loader(
        conf["data_list_fid_a"], conf["data_list_fid_b"],
        max(conf["batch_size_fid"], 1), new_size=conf["new_size"],
        num_workers=conf["num_workers"])
    pool = fid_pools(reps, gens, nets, loader.batches())
    with np.load(conf["inception_moment_path"]) as z:
        moments = {k: z[k] for k in z.files}
    fid = compute_fid_from_pools(pool, moments["mu"], moments["sigma"],
                                 newton_schulz=device.type == "cuda",
                                 device=device)
    print(f"FID: {fid}")
    if not opts.kid:
        return fid
    if "pool" not in moments:
        raise SystemExit(
            "--kid needs raw real features: regenerate the moments file "
            "with compute_moments (it stores `pool` beside mu/sigma)")
    kid_mean, kid_std = kid(pool, moments["pool"])
    print(f"KID: {kid_mean:.6f} ± {kid_std:.6f}")
    return {"fid": fid, "kid": kid_mean, "kid_std": kid_std}


@torch.inference_mode()
def cmd_sweep(opts):
    """Writes sweep<i>.jpg; returns the frames, (N, H, W, 3) in [-1, 1]."""
    from munit_tpu_torch.eval.slerp import get_slerp_interp
    device = resolve_device(opts.device)
    ops.set_conv_compute(None)
    conf = get_config(opts.config)
    reps = Replicas(mesh_devices(opts.mesh, device))
    gens = [load_generator(opts.checkpoint, conf, d) for d in reps.devices]
    c = gens[0].encode_content(
        load_image(opts.input, conf["new_size"], device), 1)
    styles = get_slerp_interp(opts.nb_latents, opts.nb_interp,
                              conf["gen"]["style_dim"],
                              np.random.RandomState(opts.seed))
    os.makedirs(opts.output_folder, exist_ok=True)
    frames, k = [], len(reps)
    for at in range(0, len(styles), k):
        s = torch.from_numpy(np.stack(styles[at:at + k]))
        out = reps(lambda i, c_i, s_i: gens[i].decode(c_i, s_i, 2),
                   c.expand(s.shape[0], *c.shape[1:]), s)
        for j, frame in enumerate(out.cpu().numpy()):
            frames.append(frame)
            save_image01((frame + 1) / 2.0, os.path.join(
                opts.output_folder, f"sweep{at + j:03d}.jpg"))
    print(f"Wrote {len(styles)} sweep frames to {opts.output_folder}")
    return np.stack(frames)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m munit_tpu_torch evaluate")
    sub = p.add_subparsers(dest="cmd", required=True)
    f = sub.add_parser("fid")
    f.add_argument("--config", required=True)
    f.add_argument("--checkpoint", required=True)
    f.add_argument("--inception_ckpt", required=True)
    f.add_argument("--kid", action="store_true",
                   help="also report Kernel Inception Distance (needs a "
                        "moments file with the raw real `pool`)")
    f.add_argument("--mesh", choices=["off", "auto"], default="off",
                   help="auto: every FID batch split over every visible "
                        "card")
    f.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    s = sub.add_parser("sweep")
    s.add_argument("--config", required=True)
    s.add_argument("--checkpoint", required=True)
    s.add_argument("--input", required=True)
    s.add_argument("--output_folder", default="sweep_out")
    s.add_argument("--nb_latents", type=int, default=1)
    s.add_argument("--nb_interp", type=int, default=8)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--mesh", choices=["off", "auto"], default="off",
                   help="auto: as many frames at once as visible cards")
    s.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    opts = parse_args(argv)
    return cmd_fid(opts) if opts.cmd == "fid" else cmd_sweep(opts)


if __name__ == "__main__":
    main()
