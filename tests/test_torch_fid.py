"""The port's FID math, IS/CIS, KID, slerp, FID loader and compute_moments
CLI against the JAX package, on the CPU.

- Newton-Schulz at D = 64 against JAX's and against scipy's ``sqrtm``;
  ``cov``, ``frechet_distance`` and ``compute_fid_from_pools`` against
  JAX's, within 1e-4 relative (float32 matmuls in another order); the
  divergence on a rank-deficient pool and its scipy fallback as in JAX.
- IS, CIS, KID, slerp and the scipy distance: numpy in both packages, so
  equal.
- The FID pairs' loader: batches bitwise equal to JAX's, the mixed-shape
  fallback to batches of one.
- ``compute_moments``: the JAX CLI's file and the port's on the same images
  and Inception (its JAX pickle for the port, its .pth for JAX): the same
  keys, types and shapes, so each package's ``evaluate`` reads the other's
  file; pools within 1e-4 of their largest magnitude (one JAX Inception
  trace).
"""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from munit_tpu.cli.compute_moments import main as jax_compute_moments
from munit_tpu.data.api import get_fid_data_loader as jax_fid_loader
from munit_tpu.eval import fid as jfid
from munit_tpu.eval.inception import convert_inception_state_dict
from munit_tpu.eval.kid import kid as jkid
from munit_tpu.eval.scores import (conditional_inception_score as jcis,
                                   inception_score as jis)
from munit_tpu.eval.slerp import get_slerp_interp as jslerp_interp
from munit_tpu.eval.slerp import slerp as jslerp
from munit_tpu_torch.cli import compute_moments, evaluate
from munit_tpu_torch.data.api import get_fid_data_loader
from munit_tpu_torch.dist.mesh import mesh_devices
from munit_tpu_torch.eval import fid
from munit_tpu_torch.eval.kid import kid
from munit_tpu_torch.eval.scores import (conditional_inception_score,
                                         inception_score)
from munit_tpu_torch.eval.slerp import get_slerp_interp, slerp
from tests.torch_port_util import (inception_ref_weights,
                                   one_torch_thread,  # noqa: F401
                                   save_torch)

RTOL = 1e-4
D = 64
ROOT = Path(__file__).resolve().parents[1]


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


def _sample(seed, n, d=D):
    return np.abs(np.random.RandomState(seed).randn(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def real():
    x = _sample(0, 200)
    return x.mean(axis=0), np.cov(x, rowvar=False)


def test_newton_schulz_against_jax_and_scipy():
    from scipy import linalg
    a = _sample(1, 300)
    a = (a.T @ a / 300).astype(np.float32)
    got = fid.sqrt_newton_schulz(torch.from_numpy(a)).numpy()
    want = np.asarray(jfid.sqrt_newton_schulz(jnp.asarray(a)))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= RTOL * scale
    assert np.abs(got - linalg.sqrtm(a.astype(np.float64)).real).max() \
        <= 1e-3 * scale


def test_cov_against_jax_and_numpy():
    x = _sample(2, 50)
    got = fid.cov(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfid.cov(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got, np.cov(x, rowvar=False), rtol=RTOL,
                               atol=1e-6)


def test_frechet_distance_against_jax_and_scipy(real):
    pool = _sample(3, 300)
    mu, sigma = pool.mean(axis=0), np.cov(pool, rowvar=False)
    got = fid.frechet_distance(mu, sigma, *real)
    assert _rel(got, jfid.frechet_distance(mu, sigma, *real)) < RTOL
    exact = fid.frechet_distance_scipy(mu, sigma, *real)
    assert exact == jfid.frechet_distance_scipy(mu, sigma, *real)
    assert _rel(got, exact) < 1e-3
    # the pools' own path converges and agrees with JAX's
    got = fid.compute_fid_from_pools(pool, *real)
    assert _rel(got, jfid.compute_fid_from_pools(pool, *real)) < RTOL
    # a set against its own moments
    assert abs(fid.frechet_distance(mu, sigma, mu, sigma)) < 1e-2


@pytest.mark.parametrize("n", [3, 10])
def test_fid_falls_back_to_scipy_on_rank_deficient_pools(real, n):
    """Far fewer images than dimensions: Newton-Schulz diverges in both
    packages, and both take scipy's sqrtm with eps jitter."""
    pool = _sample(4 + n, n)
    tp = torch.from_numpy(pool)
    mu, sigma = tp.mean(dim=0), fid.cov(tp)
    assert not np.isfinite(fid.frechet_distance(mu, sigma, *real))
    got = fid.compute_fid_from_pools(pool, *real)
    assert got == fid.frechet_distance_scipy(mu.numpy(), sigma.numpy(), *real)
    assert got == fid.compute_fid_from_pools(pool, *real,
                                             newton_schulz=False)
    assert _rel(got, jfid.compute_fid_from_pools(pool, *real)) < RTOL


def test_scores_kid_slerp_equal_jax():
    rng = np.random.RandomState(5)
    preds = rng.dirichlet(np.ones(10), size=(4, 5)).astype(np.float32)
    assert inception_score(preds) == jis(preds)
    assert conditional_inception_score(preds) == jcis(preds)
    a, b = _sample(6, 40), _sample(7, 30) + 0.5
    assert kid(a, b, n_subsets=20, subset_size=25) == jkid(
        a, b, n_subsets=20, subset_size=25)
    low, high = rng.randn(8), rng.randn(8)
    for v in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(slerp(v, low, high),
                                      jslerp(v, low, high))
    np.testing.assert_array_equal(
        get_slerp_interp(2, 4, 8, np.random.RandomState(1)),
        jslerp_interp(2, 4, 8, np.random.RandomState(1)))


# ------------------------------------------------------------- FID loader

def _write(root, name, shapes, seed):
    rng = np.random.RandomState(seed)
    paths = []
    for i, (h, w) in enumerate(shapes):
        p = root / f"{name}{i}.png"
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(p)
        paths.append(str(p))
    (root / f"{name}.txt").write_text("\n".join(paths) + "\n")
    return str(root / f"{name}.txt")


@pytest.mark.parametrize("mixed", [False, True])
def test_fid_loader_batches_as_jax(tmp_path, mixed, capsys):
    """One epoch in list order, the last partial batch dropped; a list of
    mixed shapes after the resize falls back to batches of one."""
    shapes_b = [(40, 44)] * 5 if not mixed else [(40, 44), (44, 40)] * 2 + [
        (40, 44)]
    list_a = _write(tmp_path, "a", [(48, 40)] * 5, 0)
    list_b = _write(tmp_path, "b", shapes_b, 1)
    got = list(get_fid_data_loader(list_a, list_b, 2, new_size=32,
                                   num_workers=2).batches())
    assert ("batch_size=1" in capsys.readouterr().err) == mixed
    want = list(jax_fid_loader(list_a, list_b, 2, new_size=32,
                               num_workers=2).batches())
    assert len(got) == len(want) == (5 if mixed else 2)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"image_a", "image_b"}
        for k in g:
            assert g[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], w[k])


# -------------------------------------------------------- compute_moments

def test_compute_moments_files_cross(tmp_path):
    weights = inception_ref_weights(1)
    pth = save_torch(weights, tmp_path / "inception.pth")
    pkl = tmp_path / "inception.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray,
                                 convert_inception_state_dict(weights)), f)
    images = _write(tmp_path, "real", [(48, 56), (56, 48)] * 3, 2)
    args = ["--images", images, "--new_size", "40", "--batch_size", "3"]
    jax_compute_moments(args + ["--inception_ckpt", pth,
                                "--out", str(tmp_path / "jax.npz")])
    compute_moments.main(args + ["--inception_ckpt", str(pkl), "--out",
                                 str(tmp_path / "port.npz"), "--device",
                                 "cpu"])
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(got.files) == sorted(want.files) == ["mu", "pool", "sigma"]
    for k in want.files:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        scale = np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= RTOL * scale, k
    assert got["pool"].shape == (6, 2048)
    # --mesh auto (ROADMAP item 16, refused until it was ported) takes every
    # visible card, and on the CPU the one device: the run without it
    assert compute_moments.parse_args(
        args + ["--inception_ckpt", pth, "--out", "x", "--mesh",
                "auto"]).mesh == "auto"
    assert evaluate.parse_args(["fid", "--config", "c", "--checkpoint", "g",
                                "--inception_ckpt", pth, "--mesh",
                                "auto"]).mesh == "auto"
    assert mesh_devices("auto", "cpu") == [torch.device("cpu")]


@pytest.mark.parametrize("argv", [
    ["evaluate", "fid", "--config", "configs/config_256.yaml",
     "--checkpoint", "g.pt", "--inception_ckpt", "i.pth"],
    ["evaluate", "sweep", "--config", "configs/config_256.yaml",
     "--checkpoint", "g.pt", "--input", "x.jpg"],
    ["compute_moments", "--images", "l.txt", "--inception_ckpt", "i.pth",
     "--out", "m.npz"],
    ["checkpoint_tools", "import", "--config", "configs/config_256.yaml",
     "--gen", "g.pt", "--out", "ckpt"],
    ["checkpoint_tools", "export", "--config", "configs/config_256.yaml",
     "--ckpt", "ckpt", "--out", "g.pt"],
    ["checkpoint_tools", "pack", "--config", "configs/config_256.yaml",
     "--ckpt", "g.pt", "--out", "g.npz"]], ids=lambda a: "_".join(a[:2]))
def test_eval_entry_points_need_a_card_by_default(argv, monkeypatch):
    """The card by default, with no fallback: without one, every command
    of the slice stops before it loads any weights, and names --device
    cpu."""
    from munit_tpu_torch.__main__ import main as entry
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        entry(argv)
