"""The PyTorch port stands alone: no module of munit_tpu_torch, and neither
chip_smoke.py nor bench_torch.py, imports jax, flax or the JAX package
munit_tpu."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / "munit_tpu_torch").rglob("*.py"))
FILES += ["chip_smoke.py", "bench_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "munit_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES)
def test_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_checker_sees_forbidden_imports():
    src = ("import jax.numpy\nfrom munit_tpu.core import ops\n"
           "import importlib\nimportlib.import_module('flax.linen')\n"
           "import munit_tpu_torch\n")
    got = [m for m in _imported(ast.parse(src))
           if m.split(".")[0] in FORBIDDEN]
    assert got == ["jax.numpy", "munit_tpu.core", "flax.linen"]
