"""The inference commands' ``--mesh auto`` (ROADMAP item 16) on the CPU:
the port's, through ``dist.Replicas(["cpu"] * 8)`` (each command's
``mesh_devices`` made to name eight CPU devices), against the JAX
commands' ``--mesh auto`` on the conftest's 8 fake devices, at the small
generator (32 px) with a seeded InceptionV3 (.pth for the port, the JAX
commands' pickle or .pth for JAX).

- ``translate_batch --num_style 3``: 3 styles padded to 8, one a device,
  the written PNGs within 1 uint8 step of JAX's, whose styles the port
  takes (its ``draw_styles`` fed JAX's ``jax.random`` draws).
- ``compute_moments --batch_size 3``: each batch padded to 8; mu, sigma and
  the pool within 1e-4 of their largest magnitude.
- ``evaluate fid``: batches of 3 padded to 8; the FID within 1e-4
  relative (against real moments of one repeated image, sigma 0: a cheap
  2048² ``sqrtm``), both through scipy's ``sqrtm``: the port's choice on
  the CPU, and the JAX package's ``compute_fid_from_pools(use_jax=False)``
  in place of its 400 Newton-Schulz iterations at 2048², which take tens
  of seconds on a CPU and diverge on so few images.
- ``evaluate sweep``: 8 frames a call, one a device, against the port's
  one-device sweep (the JAX command has no ``--mesh`` there).
- ``serve``: ``max_batch`` rounded up to a multiple of the devices and the
  least bucket one row a device, as the JAX service's rules; a dispatch of
  3 rows within 1e-4 of the JAX service's.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from munit_tpu.cli.compute_moments import main as jax_compute_moments
from munit_tpu.cli.evaluate import main as jax_evaluate
from munit_tpu.cli.translate_batch import main as jax_translate_batch
from munit_tpu.config import validate as jvalidate
from munit_tpu.eval import fid as jax_fid
from munit_tpu.eval.inception import convert_inception_state_dict
from munit_tpu.io.torch_import import convert_gen_state_dict
from munit_tpu.serve import TranslationService as JaxService
from munit_tpu_torch.cli import compute_moments, evaluate, translate_batch
from munit_tpu_torch.config import validate
from munit_tpu_torch.core import ops
from munit_tpu_torch.nn.generator import GenBundle
from munit_tpu_torch.serve import server
from tests.torch_port_util import (SMALL_DIS, SMALL_GEN,  # noqa: F401
                                   inception_ref_weights, one_blas_thread,
                                   one_torch_thread, ref_layout_weights,
                                   save_torch)

N_DEV = 8
SIZE = 32
NUM_STYLE = 3


def _images(root, name, n, seed, hw=(40, 40)):
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        p = root / f"{name}{i}.png"
        Image.fromarray(rng.randint(0, 256, (*hw, 3), np.uint8)).save(p)
        paths.append(str(p))
    (root / f"{name}.txt").write_text("\n".join(paths) + "\n")
    return str(root / f"{name}.txt")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    sd = ref_layout_weights(SMALL_GEN, seed=3)
    torch.save({"2": {k: torch.from_numpy(v) for k, v in sd.items()}},
               root / "gen.pt")
    incep = inception_ref_weights(1)
    with open(root / "incep.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray,
                                 convert_inception_state_dict(incep)), f)
    rng = np.random.RandomState(4)
    np.savez(root / "moments.npz", mu=rng.randn(2048).astype(np.float32),
             sigma=np.zeros((2048, 2048)))
    spec = {"gen_state": 1, "guided": 1, "new_size": SIZE,
            "crop_image_height": SIZE, "crop_image_width": SIZE,
            "gen": dict(SMALL_GEN), "dis": dict(SMALL_DIS), "num_workers": 1,
            "data_list_fid_a": _images(root, "fa", 6, 5),
            "data_list_fid_b": _images(root, "fb", 6, 6),
            "batch_size_fid": 3,
            "inception_moment_path": str(root / "moments.npz")}
    (root / "c.yaml").write_text(yaml.safe_dump(spec))
    folder = root / "in"
    folder.mkdir()
    _images(folder, "x", 2, 7, (40, 44))
    (folder / "x.txt").unlink()
    return {"root": root, "cfg": str(root / "c.yaml"),
            "gen": str(root / "gen.pt"), "sd": sd, "spec": spec,
            "pth": save_torch(incep, root / "incep.pth"),
            "pkl": str(root / "incep.pkl"), "in": str(folder),
            "real": spec["data_list_fid_b"]}


@pytest.fixture
def eight_devices(monkeypatch):
    """Every port command's --mesh auto over eight CPU devices."""
    def devices(mesh, device):
        return ([torch.device("cpu")] * N_DEV if mesh == "auto"
                else [torch.device(device)])
    for mod in (translate_batch, evaluate, compute_moments, server):
        monkeypatch.setattr(mod, "mesh_devices", devices)
    yield
    ops.set_conv_compute(None)


def _u8(path):
    return np.asarray(Image.open(path), np.int32)


def test_translate_batch_mesh_matches_jax(files, eight_devices, monkeypatch,
                                          tmp_path):
    args = ["--config", files["cfg"], "--checkpoint", files["gen"],
            "--input_folder", files["in"], "--num_style", str(NUM_STYLE),
            "--seed", "2", "--mesh", "auto"]
    jax_translate_batch(args + ["--output_folder", str(tmp_path / "j")])
    # JAX's draws (cli/translate_batch.py): the fixed styles, then one
    # batch an image, each from a split of PRNGKey(seed)
    rng = jax.random.PRNGKey(2)
    draws = []
    for _ in range(3):
        rng, k = jax.random.split(rng)
        draws.append(torch.from_numpy(np.asarray(jax.random.normal(
            k, (NUM_STYLE, SMALL_GEN["style_dim"])))))
    feed = iter(draws)
    monkeypatch.setattr(translate_batch, "draw_styles",
                        lambda g, n, dim: next(feed))
    calls = []
    decode = GenBundle.decode

    def spy(self, c, s, domain):
        calls.append(c.shape[0])
        return decode(self, c, s, domain)
    monkeypatch.setattr(GenBundle, "decode", spy)
    outs = translate_batch.main(args + ["--output_folder",
                                        str(tmp_path / "p"), "--device",
                                        "cpu"])
    assert calls == [1] * N_DEV * 2          # 3 styles padded to 8, 2 images
    assert [o.shape for o in outs] == [(NUM_STYLE, SIZE, SIZE, 3)] * 2
    for j in range(NUM_STYLE):
        for name in ("x0.png", "x1.png"):
            got = _u8(tmp_path / f"p_{j:02d}" / name)
            want = _u8(tmp_path / f"j_{j:02d}" / name)
            assert np.abs(got - want).max() <= 1, (j, name)


def test_compute_moments_mesh_matches_jax(files, eight_devices, tmp_path,
                                          one_blas_thread):
    args = ["--images", files["real"], "--new_size", "32", "--batch_size",
            "3", "--mesh", "auto"]
    jax_compute_moments(args + ["--inception_ckpt", files["pth"], "--out",
                                str(tmp_path / "j.npz")])
    compute_moments.main(args + ["--inception_ckpt", files["pth"], "--out",
                                 str(tmp_path / "p.npz"), "--device", "cpu"])
    want, got = np.load(tmp_path / "j.npz"), np.load(tmp_path / "p.npz")
    assert got["pool"].shape == want["pool"].shape == (6, 2048)
    for k in ("mu", "sigma", "pool"):
        assert np.abs(got[k] - want[k]).max() <= \
            1e-4 * np.abs(want[k]).max(), k


def test_evaluate_fid_mesh_matches_jax(files, eight_devices, one_blas_thread,
                                       monkeypatch):
    monkeypatch.setattr(jax_fid, "compute_fid_from_pools", functools.partial(
        jax_fid.compute_fid_from_pools, use_jax=False))
    args = ["fid", "--config", files["cfg"], "--checkpoint", files["gen"],
            "--mesh", "auto"]
    want = jax_evaluate(args + ["--inception_ckpt", files["pkl"]])
    got = evaluate.main(args + ["--inception_ckpt", files["pth"],
                                "--device", "cpu"])
    assert np.isfinite(want) and want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_evaluate_sweep_mesh_is_the_one_device_sweep(files, eight_devices,
                                                     tmp_path):
    args = ["sweep", "--config", files["cfg"], "--checkpoint", files["gen"],
            "--input", f"{files['in']}/x0.png", "--nb_interp", "5",
            "--nb_latents", "2", "--device", "cpu"]
    meshed = evaluate.main(args + ["--mesh", "auto", "--output_folder",
                                   str(tmp_path / "m")])
    plain = evaluate.main(args + ["--output_folder", str(tmp_path / "p")])
    assert meshed.shape == plain.shape == (10, SIZE, SIZE, 3)
    np.testing.assert_allclose(meshed, plain, rtol=0, atol=1e-5)
    assert sorted(p.name for p in (tmp_path / "m").iterdir()) == \
        [f"sweep{i:03d}.jpg" for i in range(10)]


@pytest.mark.parametrize("max_batch", [1, 5, 8, 12])
def test_serve_mesh_rules_match_jax(files, eight_devices, max_batch):
    conf = files["spec"]
    params = jax.tree.map(jnp.asarray, convert_gen_state_dict(
        files["sd"], SMALL_GEN, dual=True))
    want = JaxService(jvalidate(dict(conf)), params, max_batch=max_batch,
                      mesh="auto")
    gen = GenBundle(validate(dict(conf)), "cpu")
    gen.load_state_dict({k: torch.from_numpy(v)
                         for k, v in files["sd"].items()})
    got = server.TranslationService(validate(dict(conf)), gen,
                                    max_batch=max_batch, mesh="auto",
                                    device="cpu")
    try:
        assert got.n_dev == want.n_dev == N_DEV
        assert (got.batcher is None) == (want.batcher is None)
        if want.batcher is not None:
            assert got.batcher.max_batch == want.batcher.max_batch
            assert got.batcher.min_batch == want.batcher.min_batch == N_DEV
            assert got.batcher.buckets == want.batcher.buckets
        if max_batch == 5:
            rng = np.random.RandomState(8)
            x = rng.uniform(-1, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
            s = rng.randn(3, SMALL_GEN["style_dim"]).astype(np.float32)
            w = np.asarray(want._run_padded(x, jnp.asarray(s)))
            g = got._run_padded(x, s)
            assert g.shape == w.shape == (3, SIZE, SIZE, 3)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    finally:
        for svc in (want, got):
            if svc.batcher is not None:
                svc.batcher.close()
