"""UNIT in the port against the JAX package, on the CPU at small width:
``VAEGen`` (a content encoder and a decoder with IN res blocks) and
``translate_batch --trainer UNIT``.

Weights are made by numpy from a seed in the reference layout (``enc.*``,
``dec.*``), which the port loads strictly and the JAX package reads through
``convert_vae_gen_state_dict``.

- ``VAEGen.encode`` and ``decode`` against JAX's within 1e-4
  (translation's bound); the noise has the hiddens' shape and comes from
  the given generator.
- Both packages' ``translate_batch --trainer UNIT`` on one ``.pt`` of slots
  ``a`` and ``b``, at ``--a2b 1`` and ``0``: the same files, their images
  within 1 uint8 step.
- ``Decoder``: ``res_norm="adain"`` is the default, as before; ``"in"``
  takes no AdaIN parameters.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from munit_tpu.cli import translate_batch as jax_translate_batch
from munit_tpu.io.torch_import import convert_vae_gen_state_dict
from munit_tpu.nn import VAEGen as JVAEGen
from munit_tpu_torch.cli import translate_batch
from munit_tpu_torch.nn.generator import Decoder, VAEGen
from tests.torch_port_util import (SMALL_DIS, SMALL_GEN,  # noqa: F401
                                   one_torch_thread)

SIZE = 32
TOL = 1e-4
SPEC = {"gen_state": 1, "guided": 1, "new_size": SIZE,
        "crop_image_height": SIZE, "crop_image_width": SIZE,
        "gen": dict(SMALL_GEN), "dis": dict(SMALL_DIS)}


def _vae():
    g = SMALL_GEN
    return VAEGen(3, g["dim"], g["n_downsample"], g["n_res"], g["activ"],
                  g["pad_type"])


def vae_weights(seed):
    """Kaiming-scaled weights, small random biases and betas, U[0,1)
    LayerNorm gammas of every VAEGen parameter, as float32 numpy."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sorted(_vae().state_dict().items()):
        shape = tuple(v.shape)
        if k.endswith("norm.gamma"):
            a = rng.rand(*shape)
        elif k.endswith("weight"):
            a = rng.randn(*shape) * np.sqrt(2.0 / int(np.prod(shape[1:])))
        else:
            a = rng.randn(*shape) * 0.1
        out[k] = a.astype(np.float32)
    return out


def _jax(sd):
    g = SMALL_GEN
    net = JVAEGen(input_dim=3, dim=g["dim"], n_downsample=g["n_downsample"],
                  n_res=g["n_res"], activ=g["activ"], pad_type=g["pad_type"])
    return net, jax.tree.map(jnp.asarray, convert_vae_gen_state_dict(sd, g))


def test_vae_gen_matches_jax():
    sd = vae_weights(20)
    vae = _vae()
    vae.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jnet, params = _jax(sd)
    x = np.random.RandomState(21).uniform(-1, 1, (2, SIZE, SIZE, 3))
    x = x.astype(np.float32)
    with torch.no_grad():
        hid, noise = vae.encode(torch.from_numpy(x),
                                torch.Generator().manual_seed(0))
        y = vae.decode(hid)
    jhid = jnet.apply({"params": params}, jnp.asarray(x),
                      jax.random.PRNGKey(0), method="encode")[0]
    jy = jnet.apply({"params": params}, jhid, method="decode")
    assert hid.shape == (2, SIZE // 4, SIZE // 4, 4 * SMALL_GEN["dim"])
    np.testing.assert_allclose(hid.numpy(), np.asarray(jhid), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=TOL)
    assert noise.shape == hid.shape
    again = torch.randn(hid.shape, generator=torch.Generator().manual_seed(0))
    assert torch.equal(noise, again)


@pytest.fixture(scope="module")
def unit_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("unit")
    cfg = root / "c.yaml"
    cfg.write_text(yaml.safe_dump(SPEC))
    torch.save({slot: {k: torch.from_numpy(v)
                       for k, v in vae_weights(seed).items()}
                for slot, seed in (("a", 22), ("b", 23))}, root / "unit.pt")
    rng = np.random.RandomState(24)
    (root / "in").mkdir()
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (40, 40, 3), np.uint8)).save(
            root / "in" / f"im{i}.png")
    return root


def _images(folder):
    return {name: np.asarray(Image.open(os.path.join(folder, name)),
                             np.int16) for name in sorted(os.listdir(folder))}


@pytest.mark.parametrize("a2b", ["1", "0"])
def test_translate_batch_unit_matches_jax(unit_files, a2b):
    root = unit_files
    args = ["--config", str(root / "c.yaml"), "--checkpoint",
            str(root / "unit.pt"), "--input_folder", str(root / "in"),
            "--trainer", "UNIT", "--a2b", a2b, "--num_style", "4"]
    jax_translate_batch.main(args + ["--output_folder",
                                     str(root / f"jax{a2b}")])
    outs = translate_batch.main(args + ["--output_folder",
                                        str(root / f"port{a2b}"),
                                        "--device", "cpu"])
    assert len(outs) == 2 and all(y.shape == (1, SIZE, SIZE, 3)
                                  for y in outs)
    for sub in ("", "_00"):   # the inputs, and the one decode an image
        want = _images(str(root / f"jax{a2b}{sub}"))
        got = _images(str(root / f"port{a2b}{sub}"))
        assert sorted(got) == sorted(want) and want
        for name, img in got.items():
            assert np.abs(img - want[name]).max() <= 1, name
    assert not (root / f"port{a2b}_01").exists()
    # the direction: a2b 1 and 0 decode with other slots
    if a2b == "0":
        assert any(np.abs(_images(str(root / "port1_00"))[n]
                          - _images(str(root / "port0_00"))[n]).max() > 1
                   for n in _images(str(root / "port0_00")))


def test_decoder_res_norm():
    adain = Decoder(2, 2, 64, 3)
    assert adain.res_norm == "adain" and adain.num_adain_params == 2 * 4 * 64
    explicit = Decoder(2, 2, 64, 3, res_norm="adain")
    assert adain.state_dict().keys() == explicit.state_dict().keys()
    inorm = Decoder(2, 2, 64, 3, res_norm="in")
    assert inorm.num_adain_params == 0
    assert inorm.state_dict().keys() == adain.state_dict().keys()
    with torch.no_grad():
        y = inorm(torch.zeros(1, 8, 8, 64))
    assert y.shape == (1, 32, 32, 3)
    with pytest.raises(ValueError, match="res_norm"):
        Decoder(2, 2, 64, 3, res_norm="ln")
