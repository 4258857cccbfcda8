"""The port's norm wrappers (munit_tpu_torch.kernels.norms) against the JAX
package on the same numpy inputs.

On the CPU a wrapper computes its plain version, so these tests hold that
arithmetic against the jnp ops (one-pass, clamped variance) and against the
Pallas kernels run in interpret mode (two-pass fused; one-pass unclamped
tiled), at rtol 1e-4, atol 1e-5: float32 statistics in another order. The
CUDA kernels themselves are held against the plain versions on the card by
tests/test_torch_kernels_cuda.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from munit_tpu.core import ops as jops
from munit_tpu.kernels import norms as jnorms
from munit_tpu.kernels import tiled as jtiled
from munit_tpu_torch.kernels import norms

B, H, W, C = 2, 8, 16, 128  # the Pallas tests' lane-aligned slab
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    x = rng.randn(B, H, W, C).astype(np.float32)
    gamma = rng.randn(B, C).astype(np.float32)
    beta = rng.randn(B, C).astype(np.float32)
    ln_gamma = rng.rand(C).astype(np.float32)
    ln_beta = rng.randn(C).astype(np.float32)
    return x, gamma, beta, ln_gamma, ln_beta


def _port(name, x, gamma, beta, ln_gamma, ln_beta, relu):
    t = torch.from_numpy
    if name == "instance_norm":
        return norms.instance_norm(t(x), relu)
    if name == "adain":
        return norms.adain(t(x), t(gamma), t(beta), relu)
    return norms.whole_layer_norm(t(x), t(ln_gamma), t(ln_beta), relu)


def _jnp(name, x, gamma, beta, ln_gamma, ln_beta, relu):
    j = jnp.asarray
    if name == "instance_norm":
        y = jops.instance_norm(j(x))
    elif name == "adain":
        y = jops.adain(j(x), j(gamma), j(beta))
    else:
        y = jops.whole_layer_norm(j(x), j(ln_gamma), j(ln_beta))
    return np.asarray(jnp.maximum(y, 0) if relu else y)


NORMS = ["instance_norm", "adain", "whole_layer_norm"]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("name", NORMS)
def test_plain_against_jnp_ops(data, name, relu):
    got = _port(name, *data, relu)
    assert got.dtype == torch.float32 and got.shape == (B, H, W, C)
    np.testing.assert_allclose(got.numpy(), _jnp(name, *data, relu),
                               rtol=RTOL, atol=ATOL)


PALLAS = {
    "instance_norm_fused": ("instance_norm",
                            lambda x, g, b, lg, lb, r:
                            jnorms.instance_norm_fused(x, r)),
    "adain_fused": ("adain",
                    lambda x, g, b, lg, lb, r: jnorms.adain_fused(x, g, b, r)),
    "whole_layer_norm_fused": ("whole_layer_norm",
                               lambda x, g, b, lg, lb, r:
                               jnorms.whole_layer_norm_fused(x, lg, lb, r)),
    "instance_norm_tiled": ("instance_norm",
                            lambda x, g, b, lg, lb, r:
                            jtiled.instance_norm_tiled(x, r)),
    "adain_tiled": ("adain",
                    lambda x, g, b, lg, lb, r: jtiled.adain_tiled(x, g, b, r)),
}


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("kernel", sorted(PALLAS))
def test_plain_against_pallas_interpret(data, kernel, relu):
    name, fn = PALLAS[kernel]
    want = np.asarray(fn(*map(jnp.asarray, data), relu))
    np.testing.assert_allclose(_port(name, *data, relu).numpy(), want,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NORMS)
def test_plain_stats_on_offset_input(data, name):
    """A conv output with a large bias: the two-pass statistics keep the
    float64 answer where a one-pass sum of squares would cancel."""
    x, gamma, beta, ln_gamma, ln_beta = data
    xo = (x * 0.05 + 40.0).astype(np.float32)
    x64 = xo.astype(np.float64)
    if name == "whole_layer_norm":
        mean = x64.mean(axis=(1, 2, 3), keepdims=True)
        std = x64.reshape(B, -1).std(axis=1, ddof=1)[:, None, None, None]
        want = (x64 - mean) / (std + 1e-5) * ln_gamma + ln_beta
    else:
        mean = x64.mean(axis=(1, 2), keepdims=True)
        var = x64.var(axis=(1, 2), keepdims=True)
        want = (x64 - mean) / np.sqrt(var + 1e-5)
        if name == "adain":
            want = want * gamma[:, None, None] + beta[:, None, None]
    got = _port(name, xo, gamma, beta, ln_gamma, ln_beta, False).numpy()
    # the float32 mean of 128 values near 40 carries ~2e-5 of rounding,
    # scaled by 1 / std = 20; the one-pass E[x^2] - mean^2 is off by O(1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name", NORMS)
def test_plain_bf16(data, name):
    """bf16 in, bf16 out, f32 statistics: within one bf16 ulp at |y| = 4 of
    the f32 result."""
    x, gamma, beta, ln_gamma, ln_beta = data
    xb = torch.from_numpy(x).bfloat16()
    args = [xb.float().numpy(), gamma, beta, ln_gamma, ln_beta, True]
    want = _port(name, *args).numpy()
    t = torch.from_numpy
    if name == "instance_norm":
        got = norms.instance_norm(xb, True)
    elif name == "adain":
        got = norms.adain(xb, t(gamma), t(beta), True)
    else:
        got = norms.whole_layer_norm(xb, t(ln_gamma), t(ln_beta), True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


def test_cpu_wrappers_launch_nothing(data):
    norms.reset_launches()
    for name in NORMS:
        _port(name, *data, True)
    assert set(norms.launches) == {k + s for k in NORMS for s in ("", "_bwd")}
    assert not any(norms.launches.values())


@pytest.mark.parametrize("name", NORMS)
def test_no_fallback_off_the_cpu(name):
    """A tensor that is on neither the CPU nor a CUDA card has no kernel:
    the wrapper raises instead of computing the plain version."""
    x = torch.empty((1, 4, 4, 8), device="meta")
    g2, g1 = torch.empty((1, 8), device="meta"), torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        if name == "instance_norm":
            norms.instance_norm(x)
        elif name == "adain":
            norms.adain(x, g2, g2)
        else:
            norms.whole_layer_norm(x, g1, g1)


@pytest.mark.parametrize("name,gshape", [("adain", (8,)),
                                         ("adain", (2, 4)),
                                         ("whole_layer_norm", (2, 8))])
def test_wrappers_check_affine_shapes(name, gshape):
    x = torch.zeros(2, 4, 4, 8)
    g = torch.zeros(gshape)
    fn = norms.adain if name == "adain" else norms.whole_layer_norm
    with pytest.raises(ValueError, match="gamma"):
        fn(x, g, g)


def test_wrappers_check_rank():
    with pytest.raises(ValueError, match="NHWC"):
        norms.instance_norm(torch.zeros(4, 4, 8))


# Every norm shape on the config_256 path, batch 1 and 8, f32 and bf16.
PATH_SHAPES = [(b, h, h, c) for b in (1, 8)
               for h, c in ((256, 64), (128, 128), (64, 256))]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_plan_covers_every_row(shape, itemsize):
    b, h, w, c = shape
    vec, splits, rows = norms.plan(b, h * w, c, itemsize, 0, 132)
    assert vec * itemsize == 16 and c % vec == 0
    assert (splits - 1) * rows < h * w <= splits * rows
    assert c // vec <= 256
    # one block per SM at least, or at least 8 rows per thread
    assert b * splits >= 132 or rows >= (256 // (c // vec)) * 8


def test_plan_narrows_vectors_to_alignment():
    assert norms.plan(1, 64, 64, 4, 8, 132)[0] == 2     # 8-byte aligned
    assert norms.plan(1, 64, 3, 4, 0, 132)[0] == 1      # C = 3
    assert norms.plan(1, 64, 24, 2, 0, 132)[0] == 8     # bf16, C = 24
    with pytest.raises(ValueError):
        norms.plan(1, 64, 4096, 4, 0, 132)
