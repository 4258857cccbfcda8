"""Checkpoint conversion CLI, the port's counterpart of
``munit_tpu/cli/checkpoint_tools.py``: reference PyTorch ``.pt`` files ⇄
the port's training checkpoints, and the packed inference ``.npz``.

  # import: gen (+ dis) .pt → a training checkpoint, fresh optimizers
  python -m munit_tpu_torch checkpoint_tools import --config c.yaml \\
      --gen gen_00370000.pt [--dis dis_00370000.pt] --out ckpt_dir \\
      --step 370000 [--device cpu]

  # export: a training checkpoint (file or directory) → reference gen .pt
  python -m munit_tpu_torch checkpoint_tools export --config c.yaml \\
      --ckpt ckpt_dir --out gen_exported.pt [--device cpu]

  # pack: any generator source → the packed inference .npz (bf16, or int8
  # with per-channel scales), which translate and the JAX package's
  # load_gen_params read
  python -m munit_tpu_torch checkpoint_tools pack --config c.yaml \\
      --ckpt gen.pt --out gen.npz [--quant int8] [--device cpu]

``import`` writes ``<out>/ckpt_<step>.pt``, which ``train --resume`` and
``translate`` read; the other nets and the optimizers are the trainer's
fresh ones (seed 0). Each command builds the config's nets on ``--device``
(the card by default), so a file that does not fit the config stops it.
Not ported, and refused: ``export-aot`` (ROADMAP queue 1 item 17).
"""

from __future__ import annotations

import argparse
import os

import torch

from munit_tpu_torch.cli.translate import load_generator, resolve_device
from munit_tpu_torch.config import get_config
from munit_tpu_torch.io import checkpoint
from munit_tpu_torch.io.weights import (load_reference_checkpoint,
                                        reference_gen_blob,
                                        save_packed_params, to_jax_params)

ITEM_17 = "ROADMAP queue 1 item 17"


def cmd_import(opts):
    """Returns the checkpoint's path."""
    from munit_tpu_torch.train.trainer import MUNITTrainer
    conf = get_config(opts.config)
    tr = MUNITTrainer(conf, resolve_device(opts.device))
    tr.init(torch.Generator().manual_seed(0))
    tr.gen.load_state_dict(load_reference_checkpoint(opts.gen))
    if opts.dis:
        blob = torch.load(opts.dis, map_location="cpu", weights_only=True)
        tr.dis_a.load_state_dict(blob["a"])
        tr.dis_b.load_state_dict(blob["b"])
    tr.iterations = opts.step
    path = checkpoint.save_checkpoint(opts.out, tr.state_dict(), opts.step)
    print(f"imported → {path} @ step {opts.step}")
    return path


def cmd_export(opts):
    conf = get_config(opts.config)
    gen = load_generator(opts.ckpt, conf, resolve_device(opts.device))
    torch.save(reference_gen_blob(gen.state_dict(), conf["gen_state"]),
               opts.out)
    print(f"exported {opts.ckpt} → {opts.out}")


def cmd_pack(opts):
    """A training checkpoint, reference .pt or inference .npz → the
    compact serving .npz, bf16 or int8."""
    conf = get_config(opts.config)
    gen = load_generator(opts.ckpt, conf, resolve_device(opts.device))
    save_packed_params(opts.out, to_jax_params(gen.state_dict()),
                       opts.quant)
    print(f"packed → {opts.out} ({os.path.getsize(opts.out) / 1e6:.1f} MB)")


def cmd_export_aot(opts):
    raise SystemExit("export-aot (an ahead-of-time deployment artifact) is "
                     f"not ported; {ITEM_17}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m munit_tpu_torch checkpoint_tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    i = sub.add_parser("import")
    i.add_argument("--config", required=True)
    i.add_argument("--gen", required=True)
    i.add_argument("--dis", default=None)
    i.add_argument("--out", required=True, help="checkpoint directory")
    i.add_argument("--step", type=int, default=0)
    e = sub.add_parser("export")
    e.add_argument("--config", required=True)
    e.add_argument("--ckpt", required=True,
                   help="a training checkpoint file or directory")
    e.add_argument("--out", required=True)
    k = sub.add_parser("pack", help="params-only bf16 or int8 serving "
                                    "artifact")
    k.add_argument("--config", required=True)
    k.add_argument("--ckpt", required=True,
                   help="training checkpoint, reference .pt, or inference "
                        ".npz")
    k.add_argument("--out", required=True)
    k.add_argument("--quant", choices=["bf16", "int8"], default="bf16",
                   help="int8: per-output-channel int8 weights, "
                        "dequantized at load")
    a = sub.add_parser("export-aot", help="not ported (ROADMAP item 17)")
    a.add_argument("--config", required=True)
    a.add_argument("--ckpt", required=True)
    a.add_argument("--out", required=True)
    a.add_argument("--platforms", default="cpu,tpu")
    a.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    a.add_argument("--quant", choices=["none", "int8"], default="none")
    a.add_argument("--calib-dir", default=None)
    a.add_argument("--calib-style", default=None)
    for sp in (i, e, k, a):
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    opts = parse_args(argv)
    return {"import": cmd_import, "export": cmd_export, "pack": cmd_pack,
            "export-aot": cmd_export_aot}[opts.cmd](opts)


if __name__ == "__main__":
    main()
