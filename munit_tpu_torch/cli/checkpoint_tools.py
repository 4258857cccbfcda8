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

  # export-aot: any generator source → a deployment artifact (io/aot.py):
  # the translation traced by torch.export with the weights inside, which
  # serve --artifact runs with no config or model code
  python -m munit_tpu_torch checkpoint_tools export-aot --config c.yaml \\
      --ckpt gen.pt --out gen.pt2.zip [--dtype bf16|f32] \\
      [--quant int8 --calib-dir imgs/ [--calib-style s.jpg]] \\
      [--devices cuda,cpu] [--device cpu]

``import`` writes ``<out>/ckpt_<step>.pt``, which ``train --resume`` and
``translate`` read; the other nets and the optimizers are the trainer's
fresh ones (seed 0). Each command builds the config's nets on ``--device``
(the card by default), so a file that does not fit the config stops it.
``export-aot`` calibrates on ``--device`` and traces one program set for
each of ``--devices`` (by default ``--device``'s), each on its device.
"""

from __future__ import annotations

import argparse
import glob
import os

import torch

from munit_tpu_torch.cli.translate import (calibrate, load_generator,
                                           load_image, resolve_device)
from munit_tpu_torch.config import get_config
from munit_tpu_torch.core import ops
from munit_tpu_torch.io import aot, checkpoint
from munit_tpu_torch.io.weights import (load_reference_checkpoint,
                                        reference_gen_blob,
                                        save_packed_params, to_jax_params)

NO_INT8_SITE = ("export-aot: no convs met the int8 shape heuristic at this "
                "architecture — exporting unquantized")


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


def calibration_scales(gen, opts, size: int, device) -> list:
    """int8 scales for export-aot (``munit_tpu/cli/checkpoint_tools.py``'s
    record pass): the first 8 sorted files of ``--calib-dir`` as content,
    ``--calib-style`` (by default the first of them) as the style, each
    site's largest max|x| x1.1, under the conv numerics already set."""
    if not opts.calib_dir:
        raise SystemExit("--quant int8 needs --calib-dir")
    files = sorted(glob.glob(os.path.join(opts.calib_dir, "*")))[:8]
    if not files:
        raise SystemExit(f"no calibration images in {opts.calib_dir}")
    with torch.inference_mode():
        s_b = gen.encode_style(load_image(opts.calib_style or files[0], size,
                                          device), 2)
        return calibrate(lambda x: gen.decode(gen.encode_content(x, 1), s_b,
                                              2),
                         (load_image(p, size, device) for p in files))


def cmd_export_aot(opts):
    """Any generator source → the deployment artifact; returns
    ``aot.save_artifact``'s programs."""
    conf = get_config(opts.config)
    device = resolve_device(opts.device)
    devices = opts.devices.split(",") if opts.devices else [device.type]
    size, style_dim = conf["new_size"], conf["gen"]["style_dim"]
    gen = load_generator(opts.ckpt, conf, device)
    before = ops.conv_compute_dtype()
    ops.set_conv_compute(torch.bfloat16 if opts.dtype == "bf16" else None)
    try:
        scales = (calibration_scales(gen, opts, size, device)
                  if opts.quant == "int8" else None)

        def save(scales):
            return aot.save_artifact(
                opts.out, gen.module, size, style_dim, devices,
                {"bf16": "bfloat16", "f32": "float32"}[opts.dtype], scales)

        programs = save(scales)
        if scales is not None and not any(
                aot.graph_ops(p["translate"])["aten._int_mm.default"]
                for p in programs.values()):
            print(NO_INT8_SITE)
            scales = None
            programs = save(None)
    finally:
        ops.set_conv_compute(before)
    print(f"exported AOT artifact → {opts.out} "
          f"({os.path.getsize(opts.out) / 1e6:.1f} MB, "
          f"devices={','.join(devices)}, convs={opts.dtype}, "
          f"quant={'int8-static' if scales else 'none'})")
    return programs


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
    a = sub.add_parser("export-aot",
                       help="deployment artifact (torch.export programs; "
                            "serves with no model code or config)")
    a.add_argument("--config", required=True)
    a.add_argument("--ckpt", required=True,
                   help="training checkpoint, reference .pt, or inference "
                        ".npz")
    a.add_argument("--out", required=True, help="output .pt2.zip path")
    a.add_argument("--devices", default=None,
                   help="comma-separated devices to trace a program set on "
                        "(cuda, cpu; default: --device)")
    a.add_argument("--dtype", choices=["bf16", "f32"], default="bf16",
                   help="conv compute traced into the programs")
    a.add_argument("--quant", choices=["none", "int8"], default="none",
                   help="int8: calibrated static W8A8 convs in the translate "
                        "program (needs --calib-dir)")
    a.add_argument("--calib-dir", default=None,
                   help="folder of content images for int8 calibration")
    a.add_argument("--calib-style", default=None,
                   help="style exemplar of the calibration (default: the "
                        "first calibration image)")
    for sp in (i, e, k, a):
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    opts = parse_args(argv)
    return {"import": cmd_import, "export": cmd_export, "pack": cmd_pack,
            "export-aot": cmd_export_aot}[opts.cmd](opts)


if __name__ == "__main__":
    main()
