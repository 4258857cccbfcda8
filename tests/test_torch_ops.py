"""The port's plain ops (munit_tpu_torch.core.ops) against munit_tpu.core.ops
on the same numpy inputs. Pads and the upsample move values only, so they
must be equal; sums (conv, pooling) may differ by float32 summation order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from PIL import Image

from munit_tpu.core import ops as jops
from munit_tpu.data import transforms as jT
from munit_tpu_torch.core import ops as tops
from munit_tpu_torch.data import transforms as tT


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("padding", [1, 3])
@pytest.mark.parametrize("mode", ["reflect", "replicate", "zero"])
def test_pad2d(mode, padding):
    x = _x((2, 9, 11, 5))
    want = np.asarray(jops.pad2d(jnp.asarray(x), padding, mode))
    got = tops.pad2d(torch.from_numpy(x), padding, mode)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad2d_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tops.pad2d(torch.zeros(1, 4, 4, 2), 1, "circular")


# (kernel, stride, cin, cout): every conv shape kind the generator has
CONVS = [(7, 1, 3, 8), (4, 2, 8, 16), (3, 1, 16, 16), (5, 1, 16, 8),
         (1, 1, 16, 4)]


@pytest.mark.parametrize("k,stride,cin,cout", CONVS)
def test_conv2d(k, stride, cin, cout):
    x = _x((2, 12, 10, cin), 1)
    w_hwio = _x((k, k, cin, cout), 2) / np.float32(np.sqrt(k * k * cin))
    bias = _x((cout,), 3)
    want = np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(w_hwio),
                                  jnp.asarray(bias), stride))
    w = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    got = tops.conv2d(torch.from_numpy(x), w, torch.from_numpy(bias), stride)
    assert got.is_contiguous() and got.shape == want.shape
    # float32 sums of up to 147 products in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_upsample_nearest():
    x = _x((2, 5, 3, 4))
    want = np.asarray(jops.upsample_nearest(jnp.asarray(x), 2))
    np.testing.assert_array_equal(
        tops.upsample_nearest(torch.from_numpy(x), 2).numpy(), want)


def test_global_avg_pool():
    x = _x((2, 16, 16, 8))
    want = np.asarray(jops.global_avg_pool(jnp.asarray(x)))
    got = tops.global_avg_pool(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["relu", "lrelu", "selu", "tanh", "none"])
def test_activation(name):
    x = _x((2, 4, 4, 8)) * 3
    want = np.asarray(jops.activation(name)(jnp.asarray(x)))
    got = tops.activation(name)(torch.from_numpy(x)).numpy()
    # transcendental functions of two libraries: a few float32 ulps
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# (H, W, mode): landscape, portrait, already at size, grayscale
IMAGES = [(36, 52, "RGB"), (70, 40, "RGB"), (32, 48, "RGB"), (45, 33, "L")]


@pytest.mark.parametrize("h,w,mode", IMAGES)
def test_transforms(h, w, mode):
    """Resize to the shorter side, crop, [0, 1] array and [-1, 1]: the same
    bytes and values as the JAX package's host transforms."""
    rng = np.random.RandomState(h * w)
    shape = (h, w) if mode == "L" else (h, w, 3)
    img = Image.fromarray(rng.randint(0, 256, shape, np.uint8), mode)
    want, got = jT.resize_shorter(img, 32), tT.resize_shorter(img, 32)
    assert got.size == want.size and min(got.size) == 32
    want, got = jT.crop(want, 1, 2, 24, 20), tT.crop(got, 1, 2, 24, 20)
    want = jT.normalize_pm1(jT.to_array01(want))
    got = tT.normalize_pm1(tT.to_array01(got))
    assert got.dtype == np.float32 and got.shape == (24, 20, 1 if mode == "L" else 3)
    np.testing.assert_array_equal(got, want)
