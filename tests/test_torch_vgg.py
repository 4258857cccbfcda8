"""The port's VGG16 perceptual-loss parts (munit_tpu_torch.nn.vgg,
losses.vgg_perceptual_loss) against the JAX package's, modules only: the
weights are made with numpy in the reference ``Vgg16`` layout (and copied
into torchvision's ``features.*`` layout), each package converts them with
its own ``convert_vgg16_state_dict``. relu5_3 of a 32 px batch within rtol
1e-4 (float32 sums over 13 convs in another order), the preprocessing and
the loss on the same features within rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from munit_tpu.losses.losses import vgg_perceptual_loss as jax_vgg_loss
from munit_tpu.nn.vgg import Vgg16 as JVgg16
from munit_tpu.nn.vgg import convert_vgg16_state_dict as jax_convert
from munit_tpu.nn.vgg import vgg_preprocess as jax_preprocess
from munit_tpu_torch.core import ops
from munit_tpu_torch.losses.losses import vgg_perceptual_loss
from munit_tpu_torch.nn.vgg import (CONV_NAMES, TORCHVISION_INDEX, Vgg16,
                                    convert_vgg16_state_dict, vgg_preprocess)
from tests.torch_port_util import (one_torch_thread,  # noqa: F401
                                   vgg_ref_weights)


def torchvision_layout(sd) -> dict:
    """The same weights under torchvision's ``features.{i}.*`` keys, with a
    classifier the converter must ignore."""
    out = {f"features.{i}.{leaf}": sd[f"{name}.{leaf}"]
           for name, i in zip(CONV_NAMES, TORCHVISION_INDEX)
           for leaf in ("weight", "bias")}
    out["classifier.0.weight"] = np.zeros((4, 8), np.float32)
    return out


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(1)
    return rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)


@pytest.fixture(autouse=True)
def parity():
    ops.set_conv_compute(None)
    yield
    ops.set_conv_compute(None)


@pytest.mark.parametrize("layout", ["reference", "torchvision"])
def test_features_match_jax(images, layout):
    ref = vgg_ref_weights()
    sd = ref if layout == "reference" else torchvision_layout(ref)
    params = jax.tree.map(jnp.asarray, jax_convert(sd))
    want = np.asarray(JVgg16().apply({"params": params},
                                     jax_preprocess(jnp.asarray(images))))
    net = Vgg16().frozen_on("cpu")
    net.load_state_dict(convert_vgg16_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}))
    with torch.no_grad():
        got = net(net.preprocess(torch.from_numpy(images))).numpy()
    assert got.shape == want.shape == (2, 4, 4, 512)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


def test_converters_agree_on_both_layouts():
    """Both layouts convert to the same weights, and into the port's keys
    the reference layout's own arrays."""
    ref = vgg_ref_weights(2)
    a = convert_vgg16_state_dict(ref)
    b = convert_vgg16_state_dict(torchvision_layout(ref))
    assert set(a) == set(b) == set(Vgg16().state_dict())
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), ref[k])
        np.testing.assert_array_equal(b[k].numpy(), ref[k])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_preprocess_matches_jax(images, dtype):
    """RGB → BGR in [0, 255] minus the Caffe means, float32 out of a bf16
    image too, as JAX promotes it."""
    x = torch.from_numpy(images)
    jx = jnp.asarray(images)
    if dtype == "bfloat16":
        x, jx = x.bfloat16(), jx.astype(jnp.bfloat16)
    got = vgg_preprocess(x)
    want = np.asarray(jax_preprocess(jx))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    net = Vgg16()
    np.testing.assert_array_equal(net.preprocess(x).numpy(), got.numpy())


def test_perceptual_loss_matches_jax():
    rng = np.random.RandomState(3)
    f1, f2 = (rng.rand(2, 4, 4, 512).astype(np.float32) * 5 for _ in range(2))
    want = float(jax_vgg_loss(jnp.asarray(f1), jnp.asarray(f2)))
    got = float(vgg_perceptual_loss(torch.from_numpy(f1),
                                    torch.from_numpy(f2)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_vgg_is_frozen_and_seeded():
    """``frozen_on`` takes every weight out of autograd; ``init`` is
    reproducible from its generator."""
    a, b = Vgg16().frozen_on("cpu"), Vgg16().frozen_on("cpu")
    assert not any(p.requires_grad for p in a.parameters())
    a.init(torch.Generator().manual_seed(4))
    b.init(torch.Generator().manual_seed(4))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    assert not a.conv1_1.bias.any()
