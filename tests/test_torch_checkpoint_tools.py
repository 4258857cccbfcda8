"""The port's ``checkpoint_tools`` against the JAX package's, on the CPU, at
small width (32 px).

- ``import`` → ``export`` of a reference gen ``.pt`` (written by the JAX
  package's ``save_reference_checkpoint``, the AdaIN layers' dummy buffers
  in it) gives the file back bit for bit, for both generators.
- The port's ``import`` of a gen and dis ``.pt`` against the JAX CLI's
  ``import`` of the same files (one JAX trainer for its template): the
  same weights bit for bit, fresh optimizers, the step.
- ``pack``: the port's packed ``.npz`` equals the JAX CLI's pack of the
  same ``.pt`` array for array, manifest included; JAX's
  ``load_gen_params`` reads it, and its translation from it matches the
  port's (atol 1e-4, translation's bound).
- ``pack --quant int8``: the port's file equals the JAX CLI's array for
  array (int8 weights and their per-channel scales bit for bit, manifest
  included); both packages read it, to the same dequantized weights.
- ``export-aot`` refuses int8 without calibration images, and a cuda
  program without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from munit_tpu.cli import checkpoint_tools as jax_tools
from munit_tpu.cli.translate import load_gen_params
from munit_tpu.config import validate as jvalidate
from munit_tpu.io.checkpoint import restore_checkpoint as jax_restore
from munit_tpu.io.torch_import import (convert_gen_state_dict,
                                       save_reference_checkpoint)
from munit_tpu.train import GenBundle as JGenBundle
from munit_tpu.train import MUNITTrainer as JTrainer
from munit_tpu_torch.cli import checkpoint_tools
from munit_tpu_torch.config import validate
from munit_tpu_torch.io import checkpoint
from munit_tpu_torch.io.weights import (from_jax_dis, from_jax_params,
                                        load_reference_checkpoint)
from munit_tpu_torch.nn import discriminator
from munit_tpu_torch.nn.generator import GenBundle
from tests.torch_port_util import (SMALL_GEN, one_torch_thread,  # noqa: F401
                                   ref_layout_weights, small_train_spec)

STEP = 7


def _spec(gen_state):
    return small_train_spec(gen_state=gen_state, guided=gen_state)


def _gen_weights(gen_state):
    """Reference-layout generator weights (numpy) of either generator."""
    if gen_state == 1:
        return ref_layout_weights(SMALL_GEN, seed=3)
    gen = GenBundle(validate(_spec(0)), "cpu")
    rng = np.random.RandomState(4)
    return {k: (rng.randn(*v.shape) * 0.1).astype(np.float32)
            for k, v in gen.state_dict().items()}


def _files(gen_state, root):
    """The config, a reference gen .pt written by the JAX package and a
    dis .pt."""
    spec = _spec(gen_state)
    cfg = root / "c.yaml"
    cfg.write_text(yaml.safe_dump(spec))
    sd, gconf = _gen_weights(gen_state), spec["gen"]
    if gen_state == 1:
        params = convert_gen_state_dict(sd, gconf, dual=True)
    else:
        params = {h: convert_gen_state_dict(
            {k[2:]: v for k, v in sd.items() if k.startswith(f"{h}.")},
            gconf, dual=False) for h in ("a", "b")}
    gen_pt = root / "gen_in.pt"
    save_reference_checkpoint(str(gen_pt), params, gconf, gen_state=gen_state)
    rng = np.random.RandomState(5)
    dis = discriminator.build(validate(spec), "cpu")
    dis_pt = root / "dis_in.pt"
    torch.save({d: {k: torch.from_numpy((rng.randn(*v.shape) * 0.02).astype(
        np.float32)) for k, v in dis.state_dict().items()} for d in "ab"},
        dis_pt)
    return {"gen_state": gen_state, "cfg": str(cfg), "gen": str(gen_pt),
            "dis": str(dis_pt), "root": root, "spec": spec}


@pytest.fixture(scope="module", params=[1, 0], ids=["dual", "gen_state0"])
def files(request, tmp_path_factory):
    return _files(request.param,
                  tmp_path_factory.mktemp(f"ckpt{request.param}"))


def _tools(*args):
    return checkpoint_tools.main([*args, "--device", "cpu"])


def test_import_export_round_trip_bitwise(files):
    root = files["root"]
    path = _tools("import", "--config", files["cfg"], "--gen", files["gen"],
                  "--dis", files["dis"], "--out", str(root / "port"),
                  "--step", str(STEP))
    assert path == checkpoint.checkpoint_path(str(root / "port"), STEP)
    _tools("export", "--config", files["cfg"], "--ckpt", str(root / "port"),
           "--out", str(root / "gen_out.pt"))
    want = torch.load(files["gen"], weights_only=True)
    got = torch.load(root / "gen_out.pt", weights_only=True)
    assert set(got) == set(want) == ({"2"} if files["gen_state"] else
                                      {"a", "b"})
    for slot in want:
        assert set(got[slot]) == set(want[slot])
        for k, v in want[slot].items():
            assert torch.equal(got[slot][k], v), (slot, k)
    state, step = checkpoint.restore_checkpoint(str(root / "port"))
    assert step == state["iterations"] == STEP
    dis = torch.load(files["dis"], weights_only=True)
    for d in "ab":
        for k, v in dis[d].items():
            assert torch.equal(state["nets"][f"dis_{d}"][k], v)
    for opt in state["opt"].values():
        assert int(opt["count"]) == 0
        assert all(not t.any() for t in opt["mu"].values())
        assert all(not t.any() for t in opt["nu"].values())


def test_import_against_jax(tmp_path):
    """The JAX CLI's import of the same files (the dual generator's: one
    JAX trainer a file) holds the same weights; both start their
    optimizers fresh."""
    files = _files(1, tmp_path)
    root = files["root"]
    jax_tools.main(["import", "--config", files["cfg"], "--gen",
                    files["gen"], "--dis", files["dis"], "--out",
                    str(root / "orbax"), "--step", str(STEP)])
    template = JTrainer(jvalidate(files["spec"]), jax.random.PRNGKey(0)).state
    want, step = jax_restore(str(root / "orbax"), template)
    path = _tools("import", "--config", files["cfg"], "--gen", files["gen"],
                  "--dis", files["dis"], "--out", str(root / "port_vs_jax"),
                  "--step", str(STEP))
    got = checkpoint.load_checkpoint(path)
    assert got["step"] == step == STEP
    nets = got["state"]["nets"]
    for name, ref in (("gen", from_jax_params(want["gen"])),
                      ("dis_a", from_jax_dis(want["dis_a"])),
                      ("dis_b", from_jax_dis(want["dis_b"]))):
        assert set(nets[name]) == set(ref)
        for k, v in ref.items():
            assert torch.equal(nets[name][k], v), (name, k)
    assert all(not np.asarray(x).any() for x in
               jax.tree.leaves(want["gen_opt"]) if np.ndim(x) > 0)


def test_pack_as_jax_and_readable_by_jax(files):
    root = files["root"]
    _tools("pack", "--config", files["cfg"], "--ckpt", files["gen"],
           "--out", str(root / "port.npz"))
    jax_tools.main(["pack", "--config", files["cfg"], "--ckpt", files["gen"],
                    "--out", str(root / "jax.npz")])
    got, want = np.load(root / "port.npz"), np.load(root / "jax.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # JAX reads the port's file; both translate alike from it
    conf = jvalidate(files["spec"])
    params = load_gen_params(str(root / "port.npz"), conf)
    rng = np.random.RandomState(6)
    x, sty = (rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
              for _ in range(2))
    jgen = JGenBundle(conf)
    c, _ = jgen.encode(params, jnp.asarray(x), 1)
    _, s = jgen.encode(params, jnp.asarray(sty), 2)
    want = np.asarray(jgen.decode(params, c, s, 2))
    gen = GenBundle(validate(files["spec"]), "cpu")
    gen.load_state_dict(load_reference_checkpoint(str(root / "port.npz")))
    with torch.no_grad():
        got = gen.decode(gen.encode_content(torch.from_numpy(x), 1),
                         gen.encode_style(torch.from_numpy(sty), 2), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_pack_int8_as_jax_and_readable_by_both(files):
    root = files["root"]
    _tools("pack", "--config", files["cfg"], "--ckpt", files["gen"],
           "--out", str(root / "port8.npz"), "--quant", "int8")
    jax_tools.main(["pack", "--config", files["cfg"], "--ckpt", files["gen"],
                    "--out", str(root / "jax8.npz"), "--quant", "int8"])
    got, want = np.load(root / "port8.npz"), np.load(root / "jax8.npz")
    assert sorted(got.files) == sorted(want.files)
    dtypes = {got[k].dtype for k in got.files}
    assert np.dtype(np.int8) in dtypes and np.dtype(np.float32) in dtypes
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # both packages dequantize it to the same weights
    port_sd = load_reference_checkpoint(str(root / "port8.npz"))
    jax_sd = from_jax_params(load_gen_params(str(root / "port8.npz"),
                                             jvalidate(files["spec"])))
    assert set(port_sd) == set(jax_sd)
    for k, v in jax_sd.items():
        assert torch.equal(port_sd[k], v), k


def test_aot_refused(files):
    args = ("export-aot", "--config", files["cfg"], "--ckpt", files["gen"],
            "--out", str(files["root"] / "x"))
    with pytest.raises(SystemExit, match="needs --calib-dir"):
        _tools(*args, "--quant", "int8")
    # a cuda program is traced on a card
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _tools(*args, "--devices", "cuda")
