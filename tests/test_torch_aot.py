"""The port's deployment artifact (``munit_tpu_torch/io/aot.py``,
``checkpoint_tools export-aot``, ``serve --artifact``) on the CPU, at a
width whose res blocks carry 128 channels (the int8 shape rule's least).

- The port's float32 artifact against the JAX package's (``jax.export``,
  exported for the CPU in float32 from the same numpy-made weights), at
  batch 1 and 3 from one artifact with a batch-1 style broadcast: atol
  1e-4, translation's bound (``tests/test_torch_translate_256.py``).
- The traced translate program holds one registered-operator node per norm
  call of the eager translate, and none of the aten ops of a norm's plain
  version; the encode_style program holds no norm.
- A fresh process loads the artifact and translates, bit for bit as this
  one, without importing ``munit_tpu_torch.nn``, ``.config``, ``.cli`` or
  ``.train``.
- The bf16 and int8 artifacts equal the port's eager bf16 and ``translate
  --quant int8`` bit for bit (whole int8 forwards cannot be held to JAX's:
  a last-bit difference moves an operand to the next int8 step). The int8
  scales are JAX's ``export-aot`` scales of the same calibration after its
  style encoder's sites (JAX's record body encodes the style of the content
  too, and leaves it unused), within 1e-4 relative.
- ``serve --artifact`` answers within 1 uint8 step of the config-built
  service; the service refuses ``--quant int8`` and another ``new_size``;
  ``load_artifact`` refuses another format and a device the artifact has
  no program for.
- ``ops._row_pad``: the int8 product's row padding, with a symbolic batch.
"""

import json
import os
import subprocess
import sys
import zipfile
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml
from PIL import Image
from torch.utils._python_dispatch import TorchDispatchMode

from munit_tpu.cli.translate import load_image as jload_image
from munit_tpu.config import validate as jvalidate
from munit_tpu.core import ops as jops
from munit_tpu.io import aot as jaot
from munit_tpu.io.torch_import import convert_gen_state_dict
from munit_tpu.train import GenBundle as JGenBundle
from munit_tpu_torch.cli import checkpoint_tools, translate
from munit_tpu_torch.config import validate
from munit_tpu_torch.core import ops
from munit_tpu_torch.io import aot
from munit_tpu_torch.nn.generator import GenBundle
from munit_tpu_torch.serve import server
from munit_tpu_torch.serve.server import TranslationService
from tests.torch_port_util import (SMALL_DIS, one_torch_thread,  # noqa: F401
                                   ref_layout_weights)

ROOT = Path(__file__).resolve().parents[1]
SIZE = 32
STYLE_DIM = 8
# dim 32 and two downsamplings: the res blocks carry 128 channels, so the
# int8 shape rule takes their convs
GEN = dict(dim=32, mlp_dim=32, style_dim=STYLE_DIM, activ="relu",
           n_downsample=2, n_res=2, pad_type="reflect")
SPEC = {"gen_state": 1, "guided": 1, "new_size": SIZE,
        "crop_image_height": SIZE, "crop_image_width": SIZE, "gen": GEN,
        "dis": SMALL_DIS}
TOL = 1e-4
NORM_OPS = {f"munit_tpu_torch.{n}.default"
            for n in ("instance_norm", "adain", "whole_layer_norm")}
# what the plain versions of the norms compute with (ops.instance_norm,
# adain, whole_layer_norm): none belongs in the translate program
PLAIN_NORM_OPS = {"aten.mean.dim", "aten.rsqrt.default", "aten.sqrt.default",
                  "aten.square.default", "aten.div.Tensor",
                  "aten.var_mean.correction"}
PLAIN_LAYOUT = ("MUNIT_S2D", "MUNIT_PACKED_TAIL", "MUNIT_PACKED_UP",
                "MUNIT_PACKED_STEM")
BANNED = ("munit_tpu_torch.nn", "munit_tpu_torch.config",
          "munit_tpu_torch.cli", "munit_tpu_torch.train")


@pytest.fixture(autouse=True)
def f32_convs():
    ops.set_conv_compute(None)
    yield
    ops.set_conv_compute(None)


def _png(path, rng):
    Image.fromarray(rng.randint(0, 255, (SIZE, SIZE, 3), np.uint8)).save(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The config, a reference gen .pt of numpy-made weights, a style and
    three content PNGs (the int8 calibration set too)."""
    root = tmp_path_factory.mktemp("aot")
    sd = ref_layout_weights(GEN, seed=13)
    cfg = root / "c.yaml"
    cfg.write_text(yaml.safe_dump(dict(SPEC)))
    torch.save({"2": {k: torch.from_numpy(v) for k, v in sd.items()}},
               root / "gen.pt")
    rng = np.random.RandomState(14)
    _png(root / "style.png", rng)
    (root / "imgs").mkdir()
    for i in range(3):
        _png(root / "imgs" / f"input{i}.png", rng)
    return {"root": root, "sd": sd, "cfg": str(cfg),
            "gen": str(root / "gen.pt"), "style": str(root / "style.png"),
            "imgs": str(root / "imgs")}


def _export(files, name, *extra):
    out = str(files["root"] / f"{name}.pt2.zip")
    programs = checkpoint_tools.main([
        "export-aot", "--config", files["cfg"], "--ckpt", files["gen"],
        "--out", out, "--device", "cpu", *extra])
    return out, programs["cpu"]


@pytest.fixture(scope="module")
def f32(files):
    return _export(files, "f32", "--dtype", "f32")


def _inputs():
    rng = np.random.RandomState(15)
    x = rng.uniform(-1, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
    style = rng.uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    return x, style


def _generator(files):
    gen = GenBundle(validate(dict(SPEC)), "cpu")
    gen.load_state_dict({k: torch.from_numpy(v)
                         for k, v in files["sd"].items()})
    return gen


def _eager(gen, x, style, scales=None):
    """The eager translation, in static int8 with ``scales`` (the style
    encoded in float32, as the artifact's encode_style program does)."""
    with torch.no_grad():
        s = gen.encode_style(torch.from_numpy(style), 2)
        with ops.conv_quant(scales is not None, scales=scales):
            return gen.decode(gen.encode_content(torch.from_numpy(x), 1),
                              s.expand(x.shape[0], -1), 2)


def test_f32_artifact_matches_jax(files, f32, tmp_path):
    jconf = jvalidate(dict(SPEC))
    params = jax.tree.map(jnp.asarray,
                          convert_gen_state_dict(files["sd"], GEN, dual=True))
    jpath = str(tmp_path / "jax.jexp.zip")
    jaot.save_artifact(jpath, JGenBundle(jconf), params, SIZE, STYLE_DIM,
                       platforms=("cpu",), conv_dtype="float32")
    want = jaot.load_artifact(jpath)
    got = aot.load_artifact(f32[0], "cpu")
    assert got.meta["devices"] == ["cpu"] and got.new_size == SIZE
    assert got.meta["conv_dtype"] == "float32" and got.meta["quant"] == "none"
    x, style = _inputs()
    s_got = got.encode_style(style)
    s_want = want.encode_style(style)
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), rtol=0,
                               atol=TOL)
    for b in (1, 3):   # one artifact, two batches, a batch-1 style
        y = got.translate(x[:b], s_got)
        assert y.shape == (b, SIZE, SIZE, 3)
        np.testing.assert_allclose(y.numpy(),
                                   np.asarray(want.translate(x[:b], s_want)),
                                   rtol=0, atol=TOL)


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_program_reaches_the_norms_only_through_the_ops(files, f32):
    progs = f32[1]
    gen = _generator(files)
    x, style = _inputs()
    with _OpCounter() as mode:
        _eager(gen, x[:1], style)
    eager = {k: n for k, n in mode.calls.items() if k in NORM_OPS}
    traced = aot.graph_ops(progs["translate"])
    # a content encode: 1 + 2 + 2 x 2 IN; a decode: 2 x 2 AdaIN, 2 LN
    assert eager == {"munit_tpu_torch.instance_norm.default": 7,
                     "munit_tpu_torch.adain.default": 4,
                     "munit_tpu_torch.whole_layer_norm.default": 2}
    assert {k: n for k, n in traced.items() if k in NORM_OPS} == eager
    assert not PLAIN_NORM_OPS & set(traced), traced
    assert not NORM_OPS & set(aot.graph_ops(progs["encode_style"]))


FRESH = """
import json, sys
import numpy as np, torch
from munit_tpu_torch.io import aot
tr = aot.load_artifact(sys.argv[1], "cpu")
z = np.load(sys.argv[2])
y = tr.translate(z["x"], tr.encode_style(z["style"]))
np.save(sys.argv[3], y.numpy())
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith("munit_tpu_torch"))))
"""


def test_fresh_process_needs_no_model_code(files, f32, tmp_path):
    x, style = _inputs()
    np.savez(tmp_path / "in.npz", x=x, style=style)
    out = subprocess.run(
        [sys.executable, "-c", FRESH, f32[0], str(tmp_path / "in.npz"),
         str(tmp_path / "y.npy")], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "munit_tpu_torch.io.aot" in loaded
    bad = [m for m in loaded for p in BANNED
           if m == p or m.startswith(p + ".")]
    assert not bad, bad
    tr = aot.load_artifact(f32[0], "cpu")
    want = tr.translate(x, tr.encode_style(style)).numpy()
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want)


def test_bf16_artifact_equals_eager_bf16(files):
    path, _ = _export(files, "bf16", "--dtype", "bf16")
    art = aot.load_artifact(path, "cpu")
    assert art.meta["conv_dtype"] == "bfloat16"
    x, style = _inputs()
    got = art.translate(x, art.encode_style(style))
    gen = _generator(files)
    ops.set_conv_compute(torch.bfloat16)
    want = _eager(gen, x, style)
    assert torch.equal(got, want)
    ops.set_conv_compute(None)   # the casts are in the program
    assert not torch.equal(got, _eager(gen, x, style))


def jax_calibration(files):
    """The JAX CLI's export-aot calibration (``munit_tpu/cli/
    checkpoint_tools.py:99-121``) of ``files``, in JAX's plain layout:
    (scales, the count of its style encoder's sites)."""
    jgen = JGenBundle(jvalidate(dict(SPEC)))
    params = jax.tree.map(jnp.asarray,
                          convert_gen_state_dict(files["sd"], GEN, dual=True))
    s_b = jax.jit(lambda x: jgen.encode(params, x, 2)[1])(
        jload_image(files["style"], SIZE))

    def recorded(fn):
        def body(*args):
            rec = []
            with jops.conv_quant(record=rec):
                fn(*args)
            return jnp.stack(rec)
        return jax.jit(body)

    record = recorded(lambda x, s: jgen.decode(
        params, jgen.encode(params, x, 1)[0], s, 2))
    paths = sorted(Path(files["imgs"]).iterdir())
    mx = np.max([np.asarray(record(jload_image(str(p), SIZE), s_b))
                 for p in paths], axis=0)
    n_style = len(recorded(lambda x: jgen.style_encode(params, x))(
        jload_image(files["style"], SIZE)))
    return [1.1 * float(v) for v in mx], n_style


def test_int8_artifact_equals_translate_quant_int8(files, f32, tmp_path,
                                                   monkeypatch):
    for k in PLAIN_LAYOUT:   # read by the JAX package while it traces
        monkeypatch.setenv(k, "0")
    path, progs = _export(files, "int8", "--dtype", "f32", "--quant", "int8",
                          "--calib-dir", files["imgs"], "--calib-style",
                          files["style"])
    art = aot.load_artifact(path, "cpu")
    scales = art.meta["quant_scales"]
    assert art.meta["quant"] == "int8-static"
    assert aot.graph_ops(progs["translate"])["aten._int_mm.default"] > 0
    # JAX's export-aot scales of the same calibration: its record body
    # runs the whole encode, style encoder first (its sites unused), so
    # the port's scales are JAX's after the style encoder's
    jax_scales, n_style = jax_calibration(files)
    assert len(scales) == len(jax_scales) - n_style == 14
    np.testing.assert_allclose(scales, jax_scales[n_style:], rtol=1e-4)
    x, style = _inputs()
    # the CLI's eager int8 translation of the calibration folder, bit for bit
    outs = translate.main([
        "--config", files["cfg"], "--checkpoint", files["gen"], "--input",
        files["imgs"], "--style", files["style"], "--output_folder",
        str(tmp_path / "t8"), "--quant", "int8", "--device", "cpu"])
    s = art.encode_style(translate.load_image(files["style"], SIZE, "cpu"))
    paths = sorted(Path(files["imgs"]).iterdir())
    for p, want in zip(paths, outs):
        got = art.translate(translate.load_image(str(p), SIZE, "cpu"), s)
        np.testing.assert_array_equal(got[0].numpy(), want)
    # the symbolic batch: three at once, as eager at three with the scales
    want3 = _eager(_generator(files), x, style, scales)
    assert torch.equal(art.translate(x, art.encode_style(style)), want3)
    f32_out = aot.load_artifact(f32[0], "cpu")
    assert not torch.equal(f32_out.translate(x, f32_out.encode_style(style)),
                           want3)


def _u8(img):
    return np.asarray(img, np.int16)


def test_serve_artifact_matches_config_service(files, f32):
    args = ["--artifact", f32[0], "--style", files["style"], "--device",
            "cpu", "--max-batch", "2"]
    svc = server.build_service(server.parse_args(args))
    assert svc.gen is None and svc.conf is None and svc.new_size == SIZE
    gen = _generator(files)
    ref = TranslationService(validate(dict(SPEC)), gen, mesh="off")
    ref.add_style("default", Image.open(files["style"]))
    try:
        for p in sorted(Path(files["imgs"]).iterdir()):
            img = Image.open(p)
            assert np.abs(_u8(svc.translate(img))
                          - _u8(ref.translate(img))).max() <= 1
        assert svc.batcher.stats_snapshot()["requests"] == 3
    finally:
        svc.batcher.close()
    with pytest.raises(ValueError, match="baked at export"):
        TranslationService(artifact=f32[0], quant="int8", device="cpu")
    with pytest.raises(ValueError, match="cannot be served"):
        TranslationService(artifact=f32[0], new_size=2 * SIZE, device="cpu")


def test_load_refuses_format_and_device(files, f32, tmp_path):
    with pytest.raises(ValueError, match="none for cuda"):
        aot.load_artifact(f32[0], "cuda")
    bad = tmp_path / "bad.pt2.zip"
    with zipfile.ZipFile(f32[0]) as src, zipfile.ZipFile(bad, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "meta.json":
                data = json.dumps({**json.loads(data), "format": 99})
            dst.writestr(name, data)
    with pytest.raises(ValueError, match="unsupported artifact format 99"):
        aot.load_artifact(str(bad), "cpu")
    with pytest.raises(ValueError, match="no programs for device"):
        aot.save_artifact(str(tmp_path / "x.zip"), _generator(files).module,
                          SIZE, STYLE_DIM, devices=("tpu",))


class _Rows(torch.nn.Module):
    def __init__(self, per_sample):
        super().__init__()
        self.per_sample = per_sample

    def forward(self, x):
        m = x.shape[0] * self.per_sample
        a = x.reshape(m, -1)
        return F.pad(a, (0, 0, 0, ops._row_pad(m, self.per_sample)))


@pytest.mark.parametrize("per_sample,pad", [(4, 17), (32, 0)])
def test_row_pad_with_a_symbolic_batch(per_sample, pad):
    assert ops._row_pad(5, 5) == 12 and ops._row_pad(40, 40) == 0
    batch = torch.export.Dim("batch", min=1)
    ep = torch.export.export(_Rows(per_sample),
                             (torch.ones(2, per_sample, 3),),
                             dynamic_shapes=({0: batch},))
    for b in (1, 5):
        y = ep.module()(torch.ones(b, per_sample, 3))
        assert y.shape == (b * per_sample + pad, 3)
        assert y[b * per_sample:].abs().sum() == 0


def _devices_named(program):
    """The devices that the graph's nodes name, in their arguments and in
    the tensors they record."""
    found = set()

    def walk(v):
        if isinstance(v, torch.device):
            found.add(v.type)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, torch.Tensor):
            found.add(v.device.type)

    for node in program.graph.nodes:
        walk(node.args)
        walk(node.kwargs)
        walk(node.meta.get("val"))
    return found


def test_retargeted_program_names_no_traced_device(f32):
    """A program loaded for another card than the one it was traced on
    (``aot.on_device``; the CPU and ``meta`` stand in for two cards) names
    that card alone: its factory ops' devices as well as its weights."""
    for name, program in f32[1].items():
        assert _devices_named(program) == {"cpu"}, name
        moved = aot.on_device(program, "meta")
        assert _devices_named(moved) == {"meta"}, name
        module = moved.module()
        assert {t.device.type for t in (*module.parameters(),
                                        *module.buffers())} == {"meta"}
