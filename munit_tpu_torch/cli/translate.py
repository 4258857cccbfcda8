"""Single-style folder inference: the "flood simulator" path (reference
test.py semantics, as ``munit_tpu/cli/translate.py``).

Given a style exemplar (a flooded image) and a folder of street-view images:
encode the exemplar's style once with the shared style encoder, then per
image encode content with branch 1, decode with branch 2, and save
output%03d.jpg.

Runs on the CUDA card by default; ``--device cpu`` runs the plain versions
of the kernels on the CPU. Weights: a reference ``gen_*.pt`` ({"2": sd}) or
an ``.npz`` of ``sd::`` entries.

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
from munit_tpu_torch.data import transforms as T
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
                   help="int8 is not ported yet")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


@torch.inference_mode()
def main(argv=None):
    """Translate the folder; returns the raw outputs, each (H, W, 3) float32
    in [-1, 1], in file order."""
    opts = parse_args(argv)
    if opts.quant == "int8":
        raise SystemExit("--quant int8 is not ported to the PyTorch port yet")
    device = resolve_device(opts.device)
    conf = get_config(opts.config)
    files = sorted(glob.glob(os.path.join(opts.input, "*")))
    if not files:
        raise SystemExit("Image list is empty.")
    os.makedirs(opts.output_folder, exist_ok=True)

    gen = GenBundle(conf, device)
    gen.load_state_dict(load_reference_checkpoint(opts.checkpoint))
    new_size = conf["new_size"]

    s_b = gen.encode_style(load_image(opts.style, new_size, device))
    outs = []
    for j, path in enumerate(files):
        x_a = load_image(path, new_size, device)
        if opts.save_input:
            save_image01(((x_a[0] + 1) / 2).cpu().numpy(),
                         os.path.join(opts.output_folder, f"input{j:03d}.jpg"))
        x_ab = gen.decode(gen.encode_content(x_a, 1), s_b, 2)[0].cpu().numpy()
        save_image01((x_ab + 1) / 2,
                     os.path.join(opts.output_folder, f"output{j:03d}.jpg"))
        outs.append(x_ab)
    print(f"Wrote {len(files)} translations to {opts.output_folder}")
    return outs


if __name__ == "__main__":
    main()
