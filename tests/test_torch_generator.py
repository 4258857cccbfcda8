"""The port's generator (munit_tpu_torch.nn) against the JAX package at small
width (dim 16, n_res 2, 64 px), on weights made with numpy in the reference
layout: JAX gets them through ``convert_gen_state_dict``, the port through
``from_jax_params`` of the JAX tree. Components and the whole encode/decode
agree within atol 1e-4 (float32 sums in another order through ~10 layers);
the golden fixture within its own 1e-3."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from munit_tpu.io.torch_import import (convert_gen_state_dict,
                                       export_gen_state_dict)
from munit_tpu.nn.blocks import MLP as JMLP
from munit_tpu.nn.generator import AdaINGenDual as JGen
from munit_tpu.nn.generator import ContentEncoder as JContent
from munit_tpu.nn.generator import Decoder as JDecoder
from munit_tpu.nn.generator import StyleEncoder as JStyle
from munit_tpu_torch.config import validate
from munit_tpu_torch.io.weights import (from_jax_params,
                                        load_reference_checkpoint)
from munit_tpu_torch.nn.generator import GenBundle
from tests.torch_port_util import SMALL_GEN, ref_layout_weights

G = SMALL_GEN
ATOL = 1e-4
CONTENT_DIM = G["dim"] * 4
N_ADAIN = G["n_res"] * 4 * CONTENT_DIM


@pytest.fixture(scope="module")
def setup():
    params = jax.tree.map(jnp.asarray, convert_gen_state_dict(
        ref_layout_weights(G, seed=3), G, dual=True))
    gen = GenBundle(validate({"gen_state": 1, "gen": G}), "cpu")
    gen.load_state_dict(from_jax_params(params))
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    return params, gen, x


def _component(name, params, gen, x):
    """(JAX output, port output) of one part of the generator."""
    t = torch.from_numpy
    with torch.no_grad():
        c = gen.encode_content(t(x), 1)
        s = gen.encode_style(t(x))
        if name == "style":
            want = JStyle(4, G["dim"], G["style_dim"]).apply(
                {"params": params["enc_style"]}, jnp.asarray(x))
            return want, s
        if name == "content":
            want = JContent(G["n_downsample"], G["n_res"], G["dim"]).apply(
                {"params": params["enc1_content"]}, jnp.asarray(x))
            return want, c
        if name == "mlp":
            want = JMLP(N_ADAIN, G["mlp_dim"]).apply(
                {"params": params["mlp2"]}, jnp.asarray(s.numpy()))
            return want, gen.module.get_adain_params(s, 2)
        if name == "decoder":
            ad = gen.module.get_adain_params(s, 2)
            want = JDecoder(G["n_downsample"], G["n_res"], CONTENT_DIM,
                            3).apply({"params": params["dec2"]},
                                     jnp.asarray(c.numpy()),
                                     jnp.asarray(ad.numpy()))
            return want, gen.module.dec2(c, ad)
        jgen = JGen(input_dim=3, **G)
        jc, js = jgen.apply({"params": params}, jnp.asarray(x), 1,
                            method="encode")
        want = jgen.apply({"params": params}, jc, js, 2, method="decode")
        pc, ps = gen.encode(t(x), 1)
        return want, gen.decode(pc, ps, 2)


@pytest.mark.parametrize("name", ["style", "content", "mlp", "decoder",
                                  "encode_decode"])
def test_component_matches_jax(setup, name):
    want, got = _component(name, *setup)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=ATOL)


def test_golden_fixture():
    blob = np.load("tests/fixtures/golden_gen.npz")
    gen = GenBundle(validate({"gen_state": 1, "gen": G}), "cpu")
    gen.load_state_dict(load_reference_checkpoint(
        "tests/fixtures/golden_gen.npz"))
    with torch.no_grad():
        c, s = gen.encode(torch.from_numpy(blob["x"]), 1)
        got = gen.decode(c, s, 2)
    np.testing.assert_allclose(got.numpy(), blob["y"], rtol=1e-3, atol=1e-3)


def test_state_dict_keys_match_reference_export(setup):
    params, gen, _ = setup
    ref = export_gen_state_dict(params, G, dual=True)
    want = {k for k in ref if not k.endswith(("running_mean", "running_var"))}
    assert set(gen.state_dict()) == want
    assert set(from_jax_params(params)) == want
    for k, v in from_jax_params(params).items():
        np.testing.assert_array_equal(v.numpy(), ref[k])


def test_reference_pt_checkpoint_loads(setup, tmp_path):
    """A reference gen_*.pt keeps the AdaIN dummy buffers; they are dropped."""
    params, gen, _ = setup
    ref = export_gen_state_dict(params, G, dual=True)
    path = tmp_path / "gen_00000001.pt"
    torch.save({"2": {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}},
               path)
    sd = load_reference_checkpoint(str(path))
    assert set(sd) == set(gen.state_dict())
    other = GenBundle(validate({"gen_state": 1, "gen": G}), "cpu")
    other.load_state_dict(sd)


def test_seeded_init_is_reproducible():
    conf = validate({"gen_state": 1, "gen": G})
    a, b = GenBundle(conf, "cpu"), GenBundle(conf, "cpu")
    a.init(torch.Generator().manual_seed(7))
    b.init(torch.Generator().manual_seed(7))
    sa, sb = a.state_dict(), b.state_dict()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    w = sa["enc1_content.model.3.model.0.model.0.conv.weight"]
    assert abs(w.std().item() - np.sqrt(2 / (9 * w.shape[1]))) < 0.01
    assert not sa["enc1_content.model.0.conv.bias"].any()
    g = sa["dec1.model.2.norm.gamma"]
    assert (g >= 0).all() and (g < 1).all()


def test_genbundle_has_only_the_dual_generator():
    with pytest.raises(NotImplementedError):
        GenBundle(validate({"gen_state": 0}), "cpu")
