"""The port's evaluation CLIs and in-training FID end to end against the JAX
package, on the CPU, at the tiny config of the port's train CLI tests
(generator dim 16, 32 px, 6 FID pairs of 40x40 PNGs resized to 32, batch
3) with a seeded InceptionV3 (.pth).

- ``compute_moments`` (the port's) writes the real moments; the train CLI
  runs 2 iterations in f32 parity with ``eval_fid: 1`` and a snapshot at
  2, and again with ``eval_fid: 0``: the losses of every step and the
  snapshot's whole state are equal bit for bit, and the first run logs
  ``FID`` at its snapshot.
- ``evaluate fid --kid`` on that snapshot gives the logged FID.
- JAX's side, on the snapshot's generator (``to_jax_params``): its
  ``MUNITTrainer.sample_fid`` over its own FID loader, its
  ``accumulate_activations`` through its InceptionV3 (one trace), its
  ``compute_fid_from_pools(use_jax=False)`` and ``kid`` against the port's
  moments file: the body of its ``prepare_inception_metrics(...)(trainer,
  loader, use_jax=False)``, and the FID of its ``evaluate`` CLI, whose 400
  Newton-Schulz iterations at 2048² diverge on 6 images and fall back to
  the same scipy ``sqrtm``. FID and KID agree within 1e-4 relative (the
  KID's spread, rounding noise here, within 1e-5 of the KID).
- ``evaluate sweep`` against JAX's decode of the same slerp styles (atol
  1e-4, translation's bound).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from munit_tpu.cli.translate import load_image as jax_load_image
from munit_tpu.config import validate as jvalidate
from munit_tpu.data.api import get_fid_data_loader as jax_fid_loader
from munit_tpu.eval import fid as jfid
from munit_tpu.eval.inception import InceptionV3 as JInception
from munit_tpu.eval.inception import convert_inception_state_dict
from munit_tpu.eval.inception import inception_preprocess as jpreprocess
from munit_tpu.eval.kid import kid as jkid
from munit_tpu.eval.slerp import get_slerp_interp
from munit_tpu.train import GenBundle as JGenBundle
from munit_tpu.train import MUNITTrainer as JTrainer
from munit_tpu_torch.cli import compute_moments, evaluate
from munit_tpu_torch.cli import train as cli_train
from munit_tpu_torch.core import ops
from munit_tpu_torch.io import checkpoint
from munit_tpu_torch.io.weights import to_jax_params
from tests.torch_port_util import (inception_ref_weights,  # noqa: F401
                                   one_blas_thread, one_torch_thread,
                                   save_torch, small_train_spec)

RTOL = 1e-4
ITERS = 2
FID_PAIRS = 6


def _images(root, name, shapes, seed, ext="png"):
    rng = np.random.RandomState(seed)
    paths = []
    for i, (h, w) in enumerate(shapes):
        p = root / f"{name}{i}.{ext}"
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(p)
        paths.append(str(p))
    (root / f"{name}.txt").write_text("\n".join(paths) + "\n")
    return str(root / f"{name}.txt")


def _metrics(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _losses(run):
    return {m["step"]: {k: v for k, v in m.items() if k != "step"}
            for m in _metrics(run) if "loss_dis_total" in m}


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


@pytest.fixture(scope="module")
def setup(tmp_path_factory, one_blas_thread):
    root = tmp_path_factory.mktemp("eval")
    data = {}
    for dom, seed in (("a", 0), ("b", 1)):
        lst = _images(root, f"train_{dom}", [(40, 46), (44, 36)] * 2, seed,
                      "jpg")
        data.update({f"data_list_train_{dom}": lst,
                     f"data_list_test_{dom}": lst,
                     f"data_folder_train_{dom}": "/",
                     f"data_folder_test_{dom}": "/"})
    fid_a = _images(root, "fid_a", [(40, 40)] * FID_PAIRS, 2)
    fid_b = _images(root, "fid_b", [(40, 40)] * FID_PAIRS, 3)
    inception = save_torch(inception_ref_weights(2), root / "inception.pth")
    moments = str(root / "moments.npz")
    compute_moments.main(["--images", fid_b, "--inception_ckpt", inception,
                          "--out", moments, "--new_size", "32",
                          "--batch_size", "3", "--device", "cpu"])
    spec = small_train_spec(
        **data, precision="parity", num_workers=2, log_iter=1,
        max_iter=ITERS, snapshot_save_iter=ITERS, image_save_iter=1000,
        image_display_iter=1000, data_list_fid_a=fid_a, data_list_fid_b=fid_b,
        batch_size_fid=3, inception_ckpt_path=inception,
        inception_moment_path=moments)
    runs = {}
    try:
        for eval_fid in (1, 0):
            out = root / f"run{eval_fid}"
            out.mkdir()
            cfg = out / "c.yaml"
            cfg.write_text(yaml.safe_dump({**spec, "eval_fid": eval_fid}))
            assert cli_train.main(["--config", str(cfg), "--output_path",
                                   str(out), "--device", "cpu"]) == ITERS
            runs[eval_fid] = (str(cfg), str(out / "outputs" / "c"))
    finally:
        ops.set_conv_compute(None)
    return {"spec": spec, "runs": runs, "inception": inception,
            "moments": moments, "root": root}


def test_eval_fid_logs_fid_and_keeps_training_bitwise(setup):
    run_fid, run_plain = setup["runs"][1][1], setup["runs"][0][1]
    fids = [m for m in _metrics(run_fid) if "FID" in m]
    assert [m["step"] for m in fids] == [ITERS]
    assert np.isfinite(fids[0]["FID"])
    assert not any("FID" in m for m in _metrics(run_plain))
    assert _losses(run_fid) == _losses(run_plain)
    assert len(_losses(run_fid)) == ITERS
    got, want = (checkpoint.restore_checkpoint(os.path.join(r, "checkpoints"))
                 for r in (run_fid, run_plain))
    assert got[1] == want[1] == ITERS
    assert _equal(got[0], want[0])


@pytest.fixture(scope="module")
def jax_reference(setup):
    """JAX's FID pools of the snapshot's generator and its FID and KID
    against the port's moments file."""
    cfg, run = setup["runs"][1]
    params = jax.tree.map(jnp.asarray, to_jax_params(
        checkpoint.generator_state(os.path.join(run, "checkpoints"))))

    class Stub:            # what JAX's sample_fid reads of its trainer
        gen = JGenBundle(jvalidate(setup["spec"]))
        state = {"gen": params}
        sample_fid = JTrainer.sample_fid

    variables = jax.tree.map(jnp.asarray, convert_inception_state_dict(
        {k: v.numpy() for k, v in torch.load(setup["inception"]).items()}))
    net = JInception()
    pool_fn = jax.jit(lambda x: net.apply(variables, jpreprocess(x))[0])
    spec = setup["spec"]
    loader = jax_fid_loader(spec["data_list_fid_a"], spec["data_list_fid_b"],
                            spec["batch_size_fid"], new_size=spec["new_size"],
                            num_workers=2)
    pool = jfid.accumulate_activations(Stub().sample_fid, pool_fn,
                                       loader.batches())
    with np.load(setup["moments"]) as m:
        return {"fid": jfid.compute_fid_from_pools(pool, m["mu"], m["sigma"],
                                                   use_jax=False),
                "kid": jkid(pool, m["pool"]), "params": params,
                "gen": Stub.gen}


def test_evaluate_fid_kid_against_jax(setup, jax_reference):
    cfg, run = setup["runs"][1]
    got = evaluate.main(["fid", "--config", cfg, "--checkpoint",
                         os.path.join(run, "checkpoints"), "--inception_ckpt",
                         setup["inception"], "--kid", "--device", "cpu"])
    logged = [m["FID"] for m in _metrics(run) if "FID" in m][0]
    assert got["fid"] == logged
    np.testing.assert_allclose(got["fid"], jax_reference["fid"], rtol=RTOL)
    # 6 images a side: every KID subset holds all of them, so the spread
    # over subsets is summation-order rounding
    kid_mean, kid_std = jax_reference["kid"]
    np.testing.assert_allclose(got["kid"], kid_mean, rtol=RTOL)
    np.testing.assert_allclose(got["kid_std"], kid_std, rtol=0,
                               atol=1e-5 * kid_mean)
    np.testing.assert_allclose(logged, jax_reference["fid"], rtol=RTOL)


def test_evaluate_sweep_against_jax(setup, jax_reference, tmp_path):
    cfg, run = setup["runs"][1]
    image = setup["spec"]["data_list_fid_a"].replace(".txt", "0.png")
    frames = evaluate.main(["sweep", "--config", cfg, "--checkpoint",
                            os.path.join(run, "checkpoints"), "--input",
                            image, "--nb_interp", "3", "--seed", "4",
                            "--output_folder", str(tmp_path / "sweep"),
                            "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "sweep")) == [
        "sweep000.jpg", "sweep001.jpg", "sweep002.jpg"]
    gen, params = jax_reference["gen"], jax_reference["params"]
    c, _ = gen.encode(params, jax_load_image(image, 32), 1)
    styles = get_slerp_interp(1, 3, 8, np.random.RandomState(4))
    want = np.stack([np.asarray(gen.decode(params, c, jnp.asarray(s)[None],
                                           2))[0] for s in styles])
    np.testing.assert_allclose(frames, want, rtol=0, atol=1e-4)
