"""Single-style folder inference: the "flood simulator" path (reference
test.py semantics, as ``munit_tpu/cli/translate.py``).

Given a style exemplar (a flooded image) and a folder of street-view images:
encode the exemplar's style once with branch 2's style encoder (the shared
one of the dual generator), then per image encode content with branch 1,
decode with branch 2, and save output%03d.jpg.

Runs on the CUDA card by default; ``--device cpu`` runs the plain versions
of the kernels on the CPU. Weights, of the config's ``gen_state``: a
reference ``gen_*.pt`` ({"2": sd} of the dual generator, {"a": sd, "b": sd}
of ``gen_state: 0``), an ``.npz`` of ``sd::`` entries or a packed inference
``.npz``, or the generator of a training checkpoint of the port
(``io/checkpoint.py``): a ``ckpt_<step>.pt`` file or a directory of them,
whose latest is read.

Convolutions run in float32 with TF32 off (``ops.set_conv_compute(None)``),
the JAX CLI's ``Precision.HIGHEST``. ``--quant int8`` runs the generator's
worthwhile convs in int8 (``ops.conv_quant``): a record pass over the first
8 inputs calibrates one scale per conv site (their largest max|x|, x1.1),
then every input runs with those static scales; the style is encoded in
float32.

Usage:
  python -m munit_tpu_torch translate --config configs/config_256.yaml \\
      --checkpoint gen.pt --input input_folder/ --style style.png \\
      --output_folder out/ [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch
from PIL import Image

from munit_tpu_torch.config import get_config
from munit_tpu_torch.core import ops
from munit_tpu_torch.data import transforms as T
from munit_tpu_torch.io import checkpoint
from munit_tpu_torch.io.weights import load_reference_checkpoint
from munit_tpu_torch.nn.generator import GenBundle


def resolve_device(name: str) -> torch.device:
    """The run's device; 'cuda' without a card raises, with no fallback."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run "
                         "on the CPU")
    return torch.device(name)


def load_image(path: str, new_size: int, device) -> torch.Tensor:
    """Image file → (1, H, W, 3) float32 in [-1, 1] on ``device``."""
    img = T.resize_shorter(Image.open(path).convert("RGB"), new_size)
    return torch.from_numpy(T.normalize_pm1(T.to_array01(img)))[None].to(device)


def save_image01(arr01: np.ndarray, path: str):
    """(H,W,C) [0,1] → jpg with make_grid(normalize=True) min-max semantics."""
    lo, hi = arr01.min(), arr01.max()
    arr = (arr01 - lo) / max(hi - lo, 1e-5)
    Image.fromarray((arr * 255).round().astype(np.uint8)).save(path)


def load_generator_weights(path: str):
    """The generator's state_dict from a training checkpoint (file or
    directory) or a reference/inference checkpoint file."""
    if checkpoint.is_training_checkpoint(path):
        return checkpoint.generator_state(path)
    return load_reference_checkpoint(path)


def load_generator(path: str, conf, device) -> GenBundle:
    """The config's generator on ``device`` with the weights of ``path``
    (any file or directory ``load_generator_weights`` reads)."""
    gen = GenBundle(conf, device)
    gen.load_state_dict(load_generator_weights(path))
    return gen


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--input", required=True, help="input folder (glob input*)")
    p.add_argument("--style", required=True, help="style exemplar image")
    p.add_argument("--output_folder", required=True)
    p.add_argument("--save_input", action="store_true")
    p.add_argument("--seed", type=int, default=10)
    # Accepted for reference test.py compatibility; unused there too.
    p.add_argument("--synchronized", action="store_true",
                   help="accepted for reference test.py compatibility (no-op)")
    p.add_argument("--output_path", default=".",
                   help="accepted for reference test.py compatibility (no-op)")
    p.add_argument("--quant", choices=["none", "int8"], default="none",
                   help="int8: calibrated static W8A8 on the worthwhile "
                        "generator convs")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def calibrate(body, inputs) -> list:
    """Static int8 scales of ``body``'s conv sites: a record pass over each
    input, the largest max|x| of each site across them, x1.1
    (``munit_tpu/cli/translate.py:119-131``)."""
    mx = None
    for x in inputs:
        rec = []
        with ops.conv_quant(record=rec):
            body(x)
        m = torch.stack(rec).cpu().numpy()
        mx = m if mx is None else np.maximum(mx, m)
    return [1.1 * float(v) for v in mx]


@torch.inference_mode()
def main(argv=None):
    """Translate the folder; returns the raw outputs, each (H, W, 3) float32
    in [-1, 1], in file order."""
    opts = parse_args(argv)
    device = resolve_device(opts.device)
    ops.set_conv_compute(None)
    conf = get_config(opts.config)
    files = sorted(glob.glob(os.path.join(opts.input, "*")))
    if not files:
        raise SystemExit("Image list is empty.")
    os.makedirs(opts.output_folder, exist_ok=True)

    gen = load_generator(opts.checkpoint, conf, device)
    new_size = conf["new_size"]

    s_b = gen.encode_style(load_image(opts.style, new_size, device), 2)

    def body(x_a):
        return gen.decode(gen.encode_content(x_a, 1), s_b, 2)

    scales = None
    if opts.quant == "int8":
        scales = calibrate(body, (load_image(p, new_size, device)
                                  for p in files[:8]))
    outs = []
    for j, path in enumerate(files):
        x_a = load_image(path, new_size, device)
        if opts.save_input:
            save_image01(((x_a[0] + 1) / 2).cpu().numpy(),
                         os.path.join(opts.output_folder, f"input{j:03d}.jpg"))
        with ops.conv_quant(scales is not None, scales=scales):
            x_ab = body(x_a)[0].cpu().numpy()
        save_image01((x_ab + 1) / 2,
                     os.path.join(opts.output_folder, f"output{j:03d}.jpg"))
        outs.append(x_ab)
    print(f"Wrote {len(files)} translations to {opts.output_folder}")
    return outs


if __name__ == "__main__":
    main()
