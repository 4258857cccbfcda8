"""The JAX package's packed inference ``.npz`` (``munit_tpu/io/checkpoint.py::
save_inference_params``: a JSON manifest, bf16 leaves as uint16 bits, int8
leaves with per-channel scales) read by the port.

A small JAX dual generator's params are packed in bf16 and in int8. The
port's translate CLI and the JAX package's own loader (``load_gen_params``
of its translate CLI, then its encode and decode) translate the same images
from the same file; the outputs agree within atol 1e-4 (float32 sums in
another order through the small generator, as in
tests/test_torch_translate_256.py). The port's state_dict equals the JAX
loader's dequantized tree exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from munit_tpu.cli.translate import load_gen_params
from munit_tpu.config import get_config as jax_get_config
from munit_tpu.io.checkpoint import save_inference_params
from munit_tpu.io.torch_import import convert_gen_state_dict
from munit_tpu.train import GenBundle as JGenBundle
from munit_tpu_torch.cli import translate
from munit_tpu_torch.io.weights import (from_jax_params,
                                        load_reference_checkpoint,
                                        to_jax_params)
from tests.torch_port_util import (SMALL_GEN, one_torch_thread,  # noqa: F401
                                   ref_layout_weights)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """A tiny config, the JAX params of numpy-made reference weights, both
    packed files, a style image and two inputs."""
    tmp = tmp_path_factory.mktemp("packed")
    cfg = tmp / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({"gen_state": 1, "guided": 1,
                                   "new_size": 32, "gen": SMALL_GEN}))
    params = jax.tree.map(jnp.asarray, convert_gen_state_dict(
        ref_layout_weights(SMALL_GEN, seed=7), SMALL_GEN, dual=True))
    files = {}
    for quant in ("bf16", "int8"):
        files[quant] = tmp / f"gen_{quant}.npz"
        save_inference_params(str(files[quant]), params, quant=quant)
    rng = np.random.RandomState(8)
    (tmp / "input").mkdir()
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (32, 36, 3), np.uint8)).save(
            tmp / "input" / f"input{i}.png")
    Image.fromarray(rng.randint(0, 256, (34, 34, 3), np.uint8)).save(
        tmp / "style.png")
    return tmp, cfg, params, files


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_port_translates_a_packed_file_as_jax_does(packed, quant):
    tmp, cfg, params, files = packed
    path = str(files[quant])
    jconf = jax_get_config(str(cfg))
    jparams = load_gen_params(path, jconf)
    sd = load_reference_checkpoint(path)
    want_sd = from_jax_params(jparams)
    assert set(sd) == set(want_sd)
    for k in sd:
        assert torch.equal(sd[k], want_sd[k]), k
    # the packing really quantized the kernels
    f32 = from_jax_params(params)
    assert max(float((sd[k] - f32[k]).abs().max()) for k in sd) > 1e-4

    outs = translate.main(["--config", str(cfg), "--checkpoint", path,
                           "--input", str(tmp / "input"), "--style",
                           str(tmp / "style.png"), "--output_folder",
                           str(tmp / f"out_{quant}"), "--device", "cpu"])
    jgen = JGenBundle(jconf)
    style = translate.load_image(str(tmp / "style.png"), 32, "cpu").numpy()
    _, s_b = jax.jit(lambda x: jgen.encode(jparams, x, 2))(style)
    body = jax.jit(lambda x: jgen.decode(jparams, jgen.encode(
        jparams, x, 1)[0], s_b, 2))
    assert len(outs) == 2
    for i, got in enumerate(outs):
        x = translate.load_image(str(tmp / "input" / f"input{i}.png"), 32,
                                 "cpu").numpy()
        want = np.asarray(body(jnp.asarray(x)))[0]
        assert got.shape == want.shape == (32, 36, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_to_jax_params_inverts_from_jax_params(packed):
    _, _, params, _ = packed
    sd = from_jax_params(params)
    tree = to_jax_params(sd)
    want, got = _flat(jax.device_get(params)), _flat(tree)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_unknown_npz_names_both_formats(tmp_path):
    plain = tmp_path / "plain.npz"
    np.savez(plain, x=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="sd::.*__manifest__"):
        load_reference_checkpoint(str(plain))
    wrong = tmp_path / "wrong.npz"
    np.savez(wrong, __manifest__=np.frombuffer(
        json.dumps({"magic": "other", "keys": {}}).encode(), np.uint8))
    with pytest.raises(ValueError, match="magic"):
        load_reference_checkpoint(str(wrong))
