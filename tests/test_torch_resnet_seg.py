"""The port's frozen ResNet34-8s segmenter (munit_tpu_torch.nn.resnet) and
the plain ops it adds against the JAX package, on the same numpy-made
weights and inputs.

The weights are a reference-layout ``resnet34_8s.*`` state dict with
randomised BN statistics (``torch_port_util.seg_ref_weights``); JAX takes
it through ``convert_resnet34_8s_state_dict``, the port through
``load_state_dict``. Logits agree within 1e-4 (they are of order 1-10;
float32 sums over 36 convolutions in another order). The conversion back
(``from_jax_resnet34_8s``) is exact; the ops agree within 1e-5 or exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from munit_tpu.core import ops as jops
from munit_tpu.nn.resnet import ResNet34_8s as JResNet
from munit_tpu.nn.resnet import convert_resnet34_8s_state_dict
from munit_tpu.nn.resnet import seg_preprocess as jseg_preprocess
from munit_tpu_torch.core import ops
from munit_tpu_torch.io.weights import (from_jax_resnet34_8s,
                                        load_segmenter_checkpoint)
from munit_tpu_torch.nn.resnet import ResNet34_8s, seg_preprocess
from tests.torch_port_util import one_torch_thread, seg_ref_weights  # noqa: F401


@pytest.fixture(scope="module")
def weights():
    sd = seg_ref_weights(0)
    net = ResNet34_8s().frozen_on("cpu")
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return sd, net, convert_resnet34_8s_state_dict(sd)


@pytest.mark.parametrize("shape", [(1, 64, 64, 3), (2, 32, 32, 3)])
def test_resnet34_8s_matches_jax(weights, shape):
    sd, net, variables = weights
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = np.asarray(JResNet(19).apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == shape[:3] + (19,)
    assert 1 < np.abs(want).max() < 100
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


def test_segmenter_is_frozen_and_passes_gradient_to_its_input(weights):
    _, net, _ = weights
    assert not net.training
    assert not any(p.requires_grad for p in net.parameters())
    x = torch.randn(1, 32, 32, 3, requires_grad=True)
    net(x).square().sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    assert all(p.grad is None for p in net.parameters())


def test_conversion_round_trip_is_exact(weights):
    sd, _, variables = weights
    back = from_jax_resnet34_8s(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_load_segmenter_checkpoint(weights, tmp_path, suffix):
    """A reference .pth (with BatchNorm2d's num_batches_tracked counters)
    or an sd:: .npz loads into the port's segmenter."""
    sd, _, _ = weights
    path = tmp_path / f"seg{suffix}"
    if suffix == ".pth":
        blob = {k: torch.from_numpy(v) for k, v in sd.items()}
        blob.update({k.replace("running_mean", "num_batches_tracked"):
                     torch.tensor(7) for k in sd if k.endswith("running_mean")})
        torch.save(blob, path)
    else:
        np.savez(path, **{f"sd::{k}": v for k, v in sd.items()})
    got = load_segmenter_checkpoint(str(path))
    net = ResNet34_8s().frozen_on("cpu")
    net.load_state_dict(got)
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    torch.save({"conv.weight": torch.zeros(1)}, tmp_path / "other.pth")
    with pytest.raises(ValueError, match="resnet34_8s"):
        load_segmenter_checkpoint(str(tmp_path / "other.pth"))


def test_seg_preprocess_matches_jax():
    x = np.random.RandomState(2).uniform(-1, 1, (2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jseg_preprocess(jnp.asarray(x)))
    got = seg_preprocess(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_batch_norm_inference_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 7, 16).astype(np.float32) * 3
    mean, beta = (rng.randn(16).astype(np.float32) for _ in range(2))
    var, gamma = (rng.uniform(0.5, 1.5, 16).astype(np.float32)
                  for _ in range(2))
    want = np.asarray(jops.batch_norm_inference(
        *map(jnp.asarray, (x, mean, var, gamma, beta))))
    got = ops.batch_norm_inference(
        *map(torch.from_numpy, (x, mean, var, gamma, beta))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("hw,size", [((5, 7), (40, 56)), ((4, 4), (32, 32)),
                                     ((3, 9), (11, 25))])
def test_resize_bilinear_matches_jax(hw, size):
    """The segmenter's x8 upsample (half-pixel centres, edges clamped) and
    odd sizes, against jax.image.resize(..., "linear")."""
    x = np.random.RandomState(4).randn(2, *hw, 19).astype(np.float32)
    want = np.asarray(jops.resize_bilinear(jnp.asarray(x), size))
    got = ops.resize_bilinear(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="upsamples"):
        ops.resize_bilinear(torch.from_numpy(x), (1, 1))


@pytest.mark.parametrize("hw,size", [((32, 32), (32, 32)), ((9, 7), (32, 24)),
                                     ((32, 32), (8, 8)), ((5, 6), (7, 13))])
def test_resize_nearest_matches_jax(hw, size):
    x = np.random.RandomState(5).rand(2, *hw, 1).astype(np.float32)
    want = np.asarray(jops.resize_nearest(jnp.asarray(x), size))
    got = ops.resize_nearest(torch.from_numpy(x), size).numpy()
    np.testing.assert_array_equal(got, want)


def test_dilated_conv_matches_jax():
    """conv2d's dilation and in-conv zero padding against the JAX package's
    pad-then-dilated-conv (the segmenter's layer3 and layer4)."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 9, 11, 8).astype(np.float32)
    w = rng.randn(3, 3, 8, 4).astype(np.float32)     # HWIO
    want = np.asarray(jops.conv2d(jops.pad2d(jnp.asarray(x), 4, "zero"),
                                  jnp.asarray(w), dilation=4))
    got = ops.conv2d(torch.from_numpy(x),
                     torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                     dilation=4, padding=4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_preprocess_constants_serve_autograd_after_inference_mode():
    """The cached ImageNet constants, made first by an inference command
    (InceptionV3's preprocessing under ``torch.inference_mode``), still
    serve a training step's autograd in the same process."""
    from munit_tpu_torch.nn import resnet
    resnet._imagenet_stats.cache_clear()
    with torch.inference_mode():
        seg_preprocess(torch.zeros(1, 4, 4, 3))
    x = torch.zeros(1, 4, 4, 3, requires_grad=True)
    seg_preprocess(x * 2).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
