"""Multi-style batch inference, MUNIT's "multimodal" translation: the port's
counterpart of ``munit_tpu/cli/translate_batch.py`` (reference
test_batch.py semantics).

Per input image: one content encode, then one batched decode over
``--num_style`` random styles (or the same ``--synchronized`` ones for
every image), each written to ``<output_folder>_<j:02d>/<basename>``; the
input itself to ``<output_folder>/input<i:03d>.jpg`` unless
``--output_only``. ``--a2b 1`` encodes with branch 1 and decodes with
branch 2; ``--a2b 0`` the other way. Either generator loads
(``gen_state: 0`` or 1), from the same files as ``translate``.

The styles are N(0, I), drawn on the CPU from a ``torch.Generator`` seeded
by ``--seed`` and copied to the device: the synchronized styles first, then
one batch per image. The JAX command has the same semantics on another
stream of numbers (``jax.random``), so the two packages draw different
styles from one seed; the card and the CPU draw the same ones.

``--compute_IS``/``--compute_CIS`` score the translations with a
fine-tuned InceptionV3 (``--inception_ckpt``, or the target domain's
``--inception_b`` with ``--a2b 1`` and ``--inception_a`` with ``--a2b 0``,
the reference's flags): each image's ``num_style`` outputs' softmax
predictions, then the Inception Score over all of them and the
conditional one per input image (test_batch.py:138-208).

The generator's convolutions run in float32 with TF32 off
(``ops.set_conv_compute(None)``), the JAX CLI's ``Precision.HIGHEST``.

``--trainer UNIT`` (test_batch.py:210-234) translates with UNIT's VAE
generators (``nn.generator.VAEGen``) from a ``.pt`` of reference state
dicts {"a": sd, "b": sd}: ``--a2b 1`` encodes with slot ``a`` and decodes
with slot ``b``, ``--a2b 0`` the other way. One deterministic decode of the
hiddens an image (the encoder's noise, drawn from a generator on the device
seeded by ``--seed``, is dropped, as the JAX command drops it), written as
style ``_00``.

``--mesh auto`` splits each image's ``num_style`` decodes over every
visible card (``dist.Replicas``, the JAX command's ``--mesh auto``): the
content encoded once on the first card, the styles padded to a multiple of
the cards by repeating the last one, each card decoding its contiguous
part, the outputs gathered and the pad sliced off. With one card, or on the
CPU, it is the run without it. UNIT's one decode an image takes one device.

Usage:
  python -m munit_tpu_torch translate_batch --config configs/config.yaml \\
      --checkpoint gen.pt --input_folder in/ --output_folder out/ \\
      [--num_style 10] [--seed 1] [--synchronized] [--device cpu] \\
      [--compute_IS] [--compute_CIS] [--inception_ckpt inception.pth]
  python -m munit_tpu_torch translate_batch --trainer UNIT \\
      --config configs/config.yaml --checkpoint unit_gen.pt \\
      --input_folder in/ --output_folder out/ [--a2b 0] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from munit_tpu_torch.cli.translate import (load_generator, resolve_device,
                                           save_image01)
from munit_tpu_torch.config import get_config
from munit_tpu_torch.core import ops
from munit_tpu_torch.data.datasets import ImageFolder
from munit_tpu_torch.dist.mesh import Replicas, mesh_devices
from munit_tpu_torch.eval.inception import inception_probs, load_inception
from munit_tpu_torch.eval.scores import (conditional_inception_score,
                                         inception_score)
from munit_tpu_torch.io.weights import drop_adain_buffers
from munit_tpu_torch.nn.generator import VAEGen

def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m munit_tpu_torch translate_batch",
        description="Translate each image of a folder with --num_style "
                    "random styles. The styles are drawn on the CPU from a "
                    "torch.Generator seeded by --seed: the JAX command's "
                    "semantics on another stream of numbers, so its styles "
                    "for one seed differ from these.")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--input_folder", required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--num_style", type=int, default=10)
    p.add_argument("--a2b", type=int, default=1)
    p.add_argument("--synchronized", action="store_true",
                   help="the same styles for every image")
    p.add_argument("--output_only", action="store_true")
    p.add_argument("--seed", type=int, default=1,
                   help="seeds the torch.Generator of the styles")
    p.add_argument("--compute_IS", action="store_true")
    p.add_argument("--compute_CIS", action="store_true")
    p.add_argument("--inception_ckpt", default=None,
                   help="fine-tuned InceptionV3 weights: torchvision .pth, "
                        ".npz, or the JAX CLIs' pickle")
    # the reference's flags (test_batch.py:73-85, :96-102): one Inception
    # per target domain, chosen by the direction
    p.add_argument("--inception_a", default=None,
                   help="the Inception of --a2b 0; an alias of "
                        "--inception_ckpt")
    p.add_argument("--inception_b", default=None,
                   help="the Inception of --a2b 1")
    p.add_argument("--trainer", default="MUNIT", choices=["MUNIT", "UNIT"],
                   help="UNIT: VAE generators from a .pt of slots a and b, "
                        "one decode an image")
    p.add_argument("--mesh", choices=["off", "auto"], default="off",
                   help="auto: each image's decodes split over every "
                        "visible card")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def load_vae(sd, conf, device) -> VAEGen:
    """A reference VAEGen state dict (its InstanceNorm buffers, if an old
    checkpoint has them, dropped) → a frozen ``VAEGen`` on ``device``."""
    g = conf["gen"]
    vae = VAEGen(conf["input_dim_a"], g["dim"], g["n_downsample"], g["n_res"],
                 g["activ"], g["pad_type"])
    vae.load_state_dict(drop_adain_buffers(sd))
    return vae.requires_grad_(False).eval().to(
        device=device, memory_format=torch.channels_last)


def unit_translator(opts, conf, device):
    """UNIT's translate(x, styles): slot a's encoder and slot b's decoder
    with ``--a2b 1``, the other way with 0; the styles are not read."""
    blob = torch.load(opts.checkpoint, map_location="cpu", weights_only=True)
    enc_slot, dec_slot = ("a", "b") if opts.a2b else ("b", "a")
    enc, dec = (load_vae(blob[k], conf, device) for k in (enc_slot, dec_slot))
    noise = torch.Generator(device).manual_seed(opts.seed)
    return lambda x, styles: dec.decode(enc.encode(x, noise)[0])


def draw_styles(g: torch.Generator, n: int, style_dim: int) -> torch.Tensor:
    """n N(0, I) style codes from ``g``, on the CPU."""
    return torch.randn((n, style_dim), generator=g)


def munit_translator(opts, conf, device):
    """MUNIT's translate(x, styles): the content of x once, on the first
    device of ``--mesh``'s, decoded with each style, the styles split over
    the devices."""
    reps = Replicas(mesh_devices(opts.mesh, device))
    gens = [load_generator(opts.checkpoint, conf, d) for d in reps.devices]
    enc_dom, dec_dom = (1, 2) if opts.a2b else (2, 1)

    def translate(x, styles):
        c = gens[0].encode_content(x, enc_dom)
        return reps(lambda i, c_i, s_i: gens[i].decode(c_i, s_i, dec_dom),
                    c.repeat(opts.num_style, 1, 1, 1), styles)
    return translate


@torch.inference_mode()
def main(argv=None):
    """Translate the folder; returns, per image in file order, its
    (num_style, H, W, 3) float32 translations in [-1, 1]."""
    opts = parse_args(argv)
    if opts.inception_ckpt is None:
        # IS/CIS measure the target domain (test_batch.py:98-102)
        opts.inception_ckpt = (opts.inception_b if opts.a2b
                               else opts.inception_a)
    scoring = opts.compute_IS or opts.compute_CIS
    if scoring and opts.inception_ckpt is None:
        raise SystemExit("--compute_IS/CIS needs --inception_ckpt")
    device = resolve_device(opts.device)
    ops.set_conv_compute(None)
    conf = get_config(opts.config)
    style_dim = conf["gen"]["style_dim"]
    new_size = conf.get("new_size_a") or conf["new_size"]
    if opts.trainer == "UNIT":
        opts.num_style = 1
        translate = unit_translator(opts, conf, device)
    else:
        translate = munit_translator(opts, conf, device)
    net = load_inception(opts.inception_ckpt, device) if scoring else None

    dataset = ImageFolder(opts.input_folder, new_size, new_size, new_size,
                          train=False, crop=False, return_paths=True)
    if len(dataset) == 0:
        raise SystemExit("Image list is empty.")
    g = torch.Generator().manual_seed(opts.seed)
    style_fixed = draw_styles(g, opts.num_style, style_dim)
    outs, preds = [], []
    for i in range(len(dataset)):
        sample = dataset.get(i, np.random.default_rng(0))
        x = torch.from_numpy(sample["image"])[None].to(device)
        styles = (style_fixed if opts.synchronized else
                  draw_styles(g, opts.num_style, style_dim))
        y = translate(x, styles)
        if net is not None:
            preds.append(inception_probs(net, (y + 1.0) / 2.0).cpu().numpy())
        y = y.cpu().numpy()
        basename = os.path.basename(sample["path"])
        for j in range(opts.num_style):
            outdir = f"{opts.output_folder}_{j:02d}"
            os.makedirs(outdir, exist_ok=True)
            save_image01((y[j] + 1.0) / 2.0, os.path.join(outdir, basename))
        if not opts.output_only:
            os.makedirs(opts.output_folder, exist_ok=True)
            save_image01(sample["image"] / 2.0 + 0.5,
                         os.path.join(opts.output_folder,
                                      f"input{i:03d}.jpg"))
        outs.append(y)
    print(f"Wrote {len(dataset)} images x {opts.num_style} styles to "
          f"{opts.output_folder}_NN")
    if opts.compute_IS:
        print(f"Inception Score: {inception_score(np.concatenate(preds))}")
    if opts.compute_CIS:
        print("conditional Inception Score: "
              f"{conditional_inception_score(np.stack(preds))}")
    return outs


if __name__ == "__main__":
    main()
