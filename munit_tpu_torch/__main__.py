"""Command dispatcher: ``python -m munit_tpu_torch <command> [args...]``.

The PyTorch port's counterpart of ``python -m munit_tpu``; it has the
commands ported so far.
"""

import sys

COMMANDS = {
    "translate": ("munit_tpu_torch.cli.translate",
                  "guided single-style folder inference (reference test.py)"),
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
