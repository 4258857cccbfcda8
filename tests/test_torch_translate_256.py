"""The port's slice end to end on the CPU: guided translation at the full
width of configs/config_256.yaml, 256x256, batch 1, against the JAX package
with its defaults (space-to-depth stems, packed IN, packed up-stage and
tail: exact rewrites of the plain math the port computes), within atol 1e-3
(float32 sums in another order through ~40 layers of up to 6,400 terms).
Weights are numpy-made in the reference layout; JAX gets them through
``convert_gen_state_dict``. Also the translate CLI on tiny images."""

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import jax
import jax.numpy as jnp

from munit_tpu.config import get_config as jax_get_config
from munit_tpu.io.torch_import import convert_gen_state_dict
from munit_tpu.nn.generator import AdaINGenDual as JGen
from munit_tpu.train import GenBundle as JGenBundle
from munit_tpu_torch.__main__ import main as port_main
from munit_tpu_torch.cli import translate
from munit_tpu_torch.config import get_config
from munit_tpu_torch.nn.generator import GenBundle
from tests.torch_port_util import SMALL_GEN, ref_layout_weights

CONFIG_256 = "configs/config_256.yaml"


def _tensors(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def test_config_256_translation_matches_jax():
    jconf, conf = jax_get_config(CONFIG_256), get_config(CONFIG_256)
    assert conf["gen"] == jconf["gen"] and conf["gen_state"] == 1
    sd = ref_layout_weights(conf["gen"], seed=11)
    rng = np.random.RandomState(12)
    x = rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    style = rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)

    jgen = JGenBundle(jconf)
    params = jax.tree.map(jnp.asarray, convert_gen_state_dict(
        sd, jconf["gen"], dual=True))

    @jax.jit
    def forward(params, x, style):
        c, _ = jgen.encode(params, x, 1)
        _, s = jgen.encode(params, style, 2)
        return jgen.decode(params, c, s, 2)

    want = np.asarray(forward(params, x, style))

    gen = GenBundle(conf, "cpu")
    gen.load_state_dict(_tensors(sd))
    with torch.inference_mode():
        s = gen.encode_style(torch.from_numpy(style))
        got = gen.decode(gen.encode_content(torch.from_numpy(x), 1), s, 2)
    assert got.shape == (1, 256, 256, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


@pytest.fixture
def tiny_run(tmp_path):
    """A tiny config, a reference-layout gen_*.pt and three small images."""
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({"gen_state": 1, "guided": 1,
                                   "new_size": 32, "gen": SMALL_GEN}))
    sd = ref_layout_weights(SMALL_GEN, seed=5)
    ckpt = tmp_path / "gen_00000001.pt"
    torch.save({"2": _tensors(sd)}, ckpt)
    rng = np.random.RandomState(6)
    inp = tmp_path / "input"
    inp.mkdir()
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (36, 40, 3), np.uint8)).save(
            inp / f"input{i}.png")
    style = tmp_path / "style.png"
    Image.fromarray(rng.randint(0, 256, (36, 36, 3), np.uint8)).save(style)
    args = ["--config", str(cfg), "--checkpoint", str(ckpt), "--input",
            str(inp), "--style", str(style)]
    return tmp_path, args, sd


def test_translate_cli_on_cpu_matches_jax(tiny_run):
    tmp_path, args, sd = tiny_run
    out = tmp_path / "out"
    outs = translate.main(args + ["--output_folder", str(out), "--save_input",
                                  "--device", "cpu"])
    assert sorted(p.name for p in out.iterdir()) == [
        "input000.jpg", "input001.jpg", "output000.jpg", "output001.jpg"]

    jgen = JGen(input_dim=3, **SMALL_GEN)
    params = {"params": jax.tree.map(jnp.asarray, convert_gen_state_dict(
        sd, SMALL_GEN, dual=True))}
    style = translate.load_image(args[-1], 32, "cpu").numpy()
    _, s = jgen.apply(params, jnp.asarray(style), 2, method="encode")
    assert len(outs) == 2
    for i, got in enumerate(outs):
        x = translate.load_image(
            str(tmp_path / "input" / f"input{i}.png"), 32, "cpu").numpy()
        assert x.shape == (1, 32, 36, 3) and got.shape == x.shape[1:]
        c, _ = jgen.apply(params, jnp.asarray(x), 1, method="encode")
        want = jgen.apply(params, c, s, 2, method="decode")
        np.testing.assert_allclose(got, np.asarray(want)[0], rtol=0,
                                   atol=1e-4)


def test_translate_cli_needs_cuda_by_default(tiny_run, monkeypatch):
    tmp_path, args, _ = tiny_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        translate.main(args + ["--output_folder", str(tmp_path / "out")])


def test_translate_cli_rejects_int8(tiny_run):
    tmp_path, args, _ = tiny_run
    with pytest.raises(SystemExit, match="int8"):
        translate.main(args + ["--output_folder", str(tmp_path / "out"),
                               "--device", "cpu", "--quant", "int8"])


def test_module_entry_point(tiny_run, capsys):
    tmp_path, args, _ = tiny_run
    assert port_main(["--help"]) == 0
    assert "translate" in capsys.readouterr().out
    assert port_main(["no-such-command"]) == 2
    assert port_main(["translate"] + args + [
        "--output_folder", str(tmp_path / "o"), "--device", "cpu"]) == 0
    assert (tmp_path / "o" / "output001.jpg").exists()
