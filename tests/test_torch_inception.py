"""InceptionV3, its preprocessing and weight loaders, translate_batch's
IS/CIS and the flood classifier of the port against the JAX package, on
the CPU.

One seeded InceptionV3 in torchvision's layout (``inception_ref_weights``:
batch norms near the identity, their statistics random) goes to JAX through
``convert_inception_state_dict`` and to the port through its loader; one
JAX trace (preprocessing and trunk, at (3, 40, 40, 3) images, 299² inside)
serves every comparison. Pool and logits agree within 1e-4 of their
largest magnitude (float32 convolutions summed in another order);
probabilities within 1e-6 absolute; IS and CIS within 1e-4 relative; the
resizes and pools within 1e-6 of their largest magnitude; the numpy
transforms exactly.
"""

import collections
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from munit_tpu.core import ops as jops
from munit_tpu.eval.inception import InceptionV3 as JInception
from munit_tpu.eval.inception import _avg_pool3_s1_p1
from munit_tpu.eval.inception import convert_inception_state_dict
from munit_tpu.eval.inception import inception_preprocess as jpreprocess
from munit_tpu.eval.scores import (conditional_inception_score as jcis,
                                   inception_score as jis)
from munit_tpu.nn import resnet18 as jresnet18
from munit_tpu_torch.cli import translate_batch
from munit_tpu_torch.core import ops
from munit_tpu_torch.eval.inception import (inception_preprocess,
                                            inception_probs, load_inception,
                                            pool_and_logits)
from munit_tpu_torch.io.weights import load_inception_checkpoint
from munit_tpu_torch.nn import resnet18
from tests.torch_port_util import (SMALL_GEN, inception_ref_weights,
                                   one_torch_thread,  # noqa: F401
                                   ref_layout_weights, resnet18_ref_weights,
                                   save_torch)

TOL = 1e-4          # of the largest magnitude: pool and logits
RESIZE_TOL = 1e-6   # of the largest magnitude: resizes and pools
SIZE = 40           # the images of every Inception call here


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def weights():
    return inception_ref_weights(0)


@pytest.fixture(scope="module")
def files(weights, tmp_path_factory):
    """The weights as a torchvision .pth, the JAX CLIs' pickle of flax
    variables (numpy leaves) and two .npz (plain and ``sd::`` keys)."""
    root = tmp_path_factory.mktemp("inception")
    out = {"pth": save_torch(weights, root / "inception.pth"),
           "pickle": str(root / "inception.pkl"),
           "npz": str(root / "inception.npz"),
           "sd_npz": str(root / "inception_sd.npz")}
    with open(out["pickle"], "wb") as f:
        pickle.dump(jax.tree.map(np.asarray,
                                 convert_inception_state_dict(weights)), f)
    np.savez(out["npz"], **weights)
    np.savez(out["sd_npz"], **{f"sd::{k}": v for k, v in weights.items()})
    return out


@pytest.fixture(scope="module")
def jax_inception(weights):
    """JAX's preprocessing and trunk → (pool, logits), one trace."""
    variables = jax.tree.map(jnp.asarray,
                             convert_inception_state_dict(weights))
    net = JInception()
    return jax.jit(lambda x: net.apply(variables, jpreprocess(x)))


@pytest.fixture(scope="module")
def net(files):
    return load_inception(files["pth"], "cpu")


def _images(seed, n=3, size=SIZE):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32)


def test_inception_v3_against_jax(net, jax_inception):
    x = _images(0)
    want_pool, want_logits = jax_inception(jnp.asarray(x))
    with torch.no_grad():
        pool, logits = pool_and_logits(net, torch.from_numpy(x))
    assert pool.shape == (3, 2048) and logits.shape == (3, 1000)
    _close(pool, want_pool, TOL)
    _close(logits, want_logits, TOL)


def test_inception_convs_stay_f32_under_bf16_convs(net):
    """The JAX package's BasicConv2d bypasses its ops.conv, so its convs
    stay float32 in bf16 training; the port's ignore set_conv_compute."""
    x = torch.from_numpy(_images(1, n=1))
    with torch.no_grad():
        want = pool_and_logits(net, x)
        ops.set_conv_compute(torch.bfloat16)
        try:
            got = pool_and_logits(net, x)
        finally:
            ops.set_conv_compute(None)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)


@pytest.mark.parametrize("fmt", ["pickle", "npz", "sd_npz"])
def test_inception_loaders_read_every_format(files, fmt):
    want = load_inception_checkpoint(files["pth"])
    got = load_inception_checkpoint(files[fmt])
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_inception_loader_drops_aux_and_counters(weights, tmp_path):
    sd = dict(weights)
    sd["AuxLogits.fc.weight"] = np.zeros((1000, 768), np.float32)
    sd["Mixed_5b.branch1x1.bn.num_batches_tracked"] = np.zeros((),
                                                               np.int64)
    got = load_inception_checkpoint(save_torch(sd, tmp_path / "tv.pth"))
    assert set(got) == set(weights)


class _Call:
    """A pickle that calls print when loaded: what an untrusted file does."""

    def __reduce__(self):
        return (print, ("loaded",))


@pytest.mark.parametrize("payload", ["call", "object"])
def test_inception_pickle_refuses_other_objects(weights, tmp_path, payload,
                                                capsys):
    variables = jax.tree.map(np.asarray, convert_inception_state_dict(weights))
    variables["extra"] = (_Call() if payload == "call"
                          else collections.Counter())
    path = tmp_path / "bad.pkl"
    with open(path, "wb") as f:
        pickle.dump(variables, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        load_inception_checkpoint(str(path))
    assert "loaded" not in capsys.readouterr().out


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 320, 320, 3),
                                   (1, 48, 56, 3)])
def test_inception_preprocess_against_jax(shape):
    x = np.random.RandomState(2).uniform(-1, 1, shape).astype(np.float32)
    got = inception_preprocess(torch.from_numpy(x))
    want = jpreprocess(jnp.asarray(x))
    assert got.shape == (shape[0], 299, 299, 3)
    _close(got, want, RESIZE_TOL)


@pytest.mark.parametrize("src,dst", [((17, 23), (31, 11)), ((40, 40), (5, 9)),
                                     ((9, 7), (9, 7)), ((1, 6), (3, 1))])
def test_resize_bilinear_align_corners_against_jax(src, dst):
    x = np.random.RandomState(3).randn(2, *src, 5).astype(np.float32)
    got = ops.resize_bilinear(torch.from_numpy(x), dst, align_corners=True)
    want = jops.resize_bilinear(jnp.asarray(x), dst, align_corners=True)
    _close(got, want, RESIZE_TOL)


def test_inception_pool3_against_jax():
    x = np.random.RandomState(4).randn(2, 9, 11, 6).astype(np.float32)
    _close(ops.box_avg_pool(torch.from_numpy(x), 3),
           _avg_pool3_s1_p1(jnp.asarray(x)), RESIZE_TOL)


# ------------------------------------------------- translate_batch IS/CIS

def test_translate_batch_scores_against_jax(files, net, jax_inception,
                                            tmp_path, capsys):
    """The port draws its styles from another stream than JAX, so the
    scores are held on the port's own translations: its softmax
    predictions and IS/CIS against JAX's Inception and scores on them."""
    rng = np.random.RandomState(5)
    folder = tmp_path / "in"
    folder.mkdir()
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (SIZE, SIZE, 3),
                                    np.uint8)).save(folder / f"im{i}.png")
    conf = {"gen_state": 1, "guided": 1, "new_size": SIZE,
            "crop_image_height": SIZE, "crop_image_width": SIZE,
            "gen": dict(SMALL_GEN)}
    cfg = tmp_path / "c.yaml"
    cfg.write_text(yaml.safe_dump(conf))
    gen = str(tmp_path / "gen.pt")
    torch.save({"2": {k: torch.from_numpy(v) for k, v in
                      ref_layout_weights(SMALL_GEN, seed=1).items()}}, gen)
    args = ["--config", str(cfg), "--checkpoint", gen, "--input_folder",
            str(folder), "--output_folder", str(tmp_path / "out"),
            "--num_style", "3", "--device", "cpu", "--output_only"]
    outs = translate_batch.main(args + ["--compute_IS", "--compute_CIS",
                                        "--inception_b", files["pickle"]])
    printed = capsys.readouterr().out
    is_got = float(printed.split("Inception Score: ")[1].split()[0])
    cis_got = float(printed.split("conditional Inception Score: ")[1]
                    .split()[0])
    preds, jpreds = [], []
    for y in outs:
        assert y.shape == (3, SIZE, SIZE, 3)
        with torch.no_grad():
            preds.append(inception_probs(
                net, (torch.from_numpy(y) + 1.0) / 2.0).numpy())
        _, logits = jax_inception(((jnp.asarray(y) + 1.0) / 2.0) * 2.0 - 1.0)
        jpreds.append(np.asarray(jax.nn.softmax(logits, axis=-1)))
    np.testing.assert_allclose(np.stack(preds), np.stack(jpreds), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(is_got, jis(np.concatenate(jpreds)),
                               rtol=1e-4)
    np.testing.assert_allclose(cis_got, jcis(np.stack(jpreds)), rtol=1e-4)
    # --a2b 0 scores with domain A's Inception; none given is refused
    with pytest.raises(SystemExit, match="needs --inception_ckpt"):
        translate_batch.main(args + ["--compute_IS", "--a2b", "0",
                                     "--inception_b", files["pth"]])


# ------------------------------------------------------- flood classifier

def test_flood_classifier_against_jax():
    sd = resnet18_ref_weights(6)
    x = np.random.RandomState(7).randn(2, 64, 64, 3).astype(np.float32)
    variables = jax.tree.map(jnp.asarray,
                             jresnet18.convert_resnet18_state_dict(sd))
    want = jresnet18.FloodClassifier().apply(variables, jnp.asarray(x))
    sd["bn1.num_batches_tracked"] = np.zeros((), np.int64)
    net = resnet18.FloodClassifier()
    net.load_state_dict(resnet18.convert_resnet18_state_dict(sd))
    with torch.no_grad():
        got = net.frozen_on("cpu")(torch.from_numpy(x))
    assert got.shape == (2, 2)
    _close(got, want, TOL)


def test_flood_classifier_transform_as_jax():
    img = Image.fromarray(np.random.RandomState(8).randint(
        0, 256, (300, 260, 3), np.uint8))
    got = resnet18.flood_classifier_transform(img)
    want = jresnet18.flood_classifier_transform(img)
    assert got.shape == (224, 224, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
