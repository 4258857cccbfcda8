"""Command dispatcher: ``python -m munit_tpu_torch <command> [args...]``.

The PyTorch port's counterpart of ``python -m munit_tpu``; it has the
commands ported so far.
"""

import sys

COMMANDS = {
    "train": ("munit_tpu_torch.cli.train",
              "train a config on one device (reference train.py)"),
    "translate": ("munit_tpu_torch.cli.translate",
                  "guided single-style folder inference (reference test.py)"),
    "translate_batch": ("munit_tpu_torch.cli.translate_batch",
                        "multi-style batch inference (reference "
                        "test_batch.py), IS/CIS"),
    "evaluate": ("munit_tpu_torch.cli.evaluate",
                 "FID/KID against real moments; slerp style sweeps"),
    "compute_moments": ("munit_tpu_torch.cli.compute_moments",
                        "Inception pool moments of a real-image set"),
    "checkpoint_tools": ("munit_tpu_torch.cli.checkpoint_tools",
                         "reference .pt <-> training checkpoint; packed "
                         "bf16/int8 .npz; AOT deployment artifact"),
    "serve": ("munit_tpu_torch.serve.server",
              "HTTP translation service with micro-batching"),
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m munit_tpu_torch <command> [args...]\n\n"
              "commands:")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:<18} {desc}")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; run with --help for the list",
              file=sys.stderr)
        return 2
    import importlib
    importlib.import_module(COMMANDS[cmd][0]).main(rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
