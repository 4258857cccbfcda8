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


# ----------------------------------------------------------- cluster_plan
# Pure Python: which design each path call takes, and the cluster
# design's cut of the slab. The kernels themselves are held against the
# plain versions on the card (tests/test_torch_kernels_cuda.py).
SMS = 132


def _assert_cluster_plan(cp, b, hw, c, itemsize, tiles):
    """Every row and channel covered exactly once, the tiles within the
    budget, at most 16 blocks a cluster, no block empty."""
    assert cp.cg * itemsize == 128 and cp.vec * itemsize <= 16
    assert c % cp.vec == 0 and cp.cg % cp.vec == 0
    groups = -(-c // cp.cg)
    assert (groups - 1) * cp.cg < c <= groups * cp.cg
    assert 1 <= cp.k <= 16
    assert (cp.k - 1) * cp.rows < hw <= cp.k * cp.rows
    assert cp.smem == tiles * cp.rows * cp.cg * itemsize
    assert cp.smem <= norms._CLUSTER_BUDGET
    # at least one block per SM, unless the rows are as few as 16 blocks
    # (or one row a block) allow
    assert b * groups * cp.k >= SMS or cp.rows == -(-hw // min(16, hw))


@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("b", [1, 2, 8, 16])
def test_cluster_plan_at_the_decoders_shape(b, itemsize, tiles):
    """IN and AdaIN at (B, 64, 64, 256), every batch the path runs (2B for
    the wide decodes), take the cluster design with 16-byte loads."""
    cp = norms.cluster_plan(b, 64 * 64, 256, itemsize, 0, SMS, tiles)
    assert cp is not None and cp.vec * itemsize == 16
    _assert_cluster_plan(cp, b, 64 * 64, 256, itemsize, tiles)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("hwc", [(256, 256, 64), (128, 128, 128)])
def test_cluster_plan_leaves_large_slabs_to_the_split_design(hwc, itemsize):
    """IN at 128^2 and 256^2: 2 MB and 8 MB a (sample, group) slab, more
    than 16 blocks hold; the whole-LN reduces over a whole sample. These
    calls take the grid design now (``grid_plan``, below); the split
    design is no longer chosen for any shape."""
    h, w, c = hwc
    for tiles in (1, 2):
        assert norms.cluster_plan(1, h * w, c, itemsize, 0, SMS, tiles) is None
        assert norms.cluster_plan(1, 64 * 64, 256, itemsize, 0, SMS, tiles,
                                  whole=True) is None


@pytest.mark.parametrize("shape,itemsize,ptr", [
    ((3, 12, 20, 24), 4, 0),    # C below one group
    ((3, 12, 20, 24), 2, 4),    # bf16, 4-byte aligned: 2-channel loads
    ((2, 7, 5, 40), 4, 0),      # H*W = 35 over the blocks; C = 32 + 8
    ((1, 9, 1, 3), 4, 8),       # fewer rows than 16 blocks; C = 3
    ((16, 64, 64, 200), 2, 0),  # a partial last group of 8 channels
])
def test_cluster_plan_ragged_rows_and_channels(shape, itemsize, ptr):
    b, h, w, c = shape
    for tiles in (1, 2):
        cp = norms.cluster_plan(b, h * w, c, itemsize, ptr, SMS, tiles)
        assert cp is not None
        _assert_cluster_plan(cp, b, h * w, c, itemsize, tiles)
        assert cp.vec == norms.plan(b, h * w, c, itemsize, ptr, SMS)[0]


# -------------------------------------------------------------- grid_plan
# Pure Python: the grid design's cut of a call into segments and blocks.
# The kernels are held against the plain versions on the card
# (tests/test_torch_kernels_cuda.py).


def _assert_grid_plan(gp, b, hw, c, itemsize, tiles):
    """Every row of every sample in exactly one segment, no segment
    straddling two samples, every block resident at once, the tiles within
    the budget and the kernel's shared-memory cap."""
    assert c % gp.vec == 0 and gp.vec * itemsize <= 16
    assert 1 <= gp.splits <= hw and 1 <= gp.rows <= hw
    assert (gp.splits - 1) * gp.rows < hw <= gp.splits * gp.rows
    assert gp.blocks == min(b * gp.splits, SMS * norms._GRID_PER_SM)
    covered = {}
    for seg in range(b * gp.splits):
        sample, s = divmod(seg, gp.splits)
        lo, hi = s * gp.rows, min((s + 1) * gp.rows, hw)
        assert lo < hi, "an empty segment"
        # one contiguous byte range of one sample
        assert sample * hw + hi <= (sample + 1) * hw
        covered.setdefault(sample, []).append((lo, hi))
    for sample in range(b):
        spans = sorted(covered[sample])
        assert spans[0][0] == 0 and spans[-1][1] == hw
        assert all(p[1] == q[0] for p, q in zip(spans, spans[1:]))
    assert 0 <= gp.res <= gp.rows
    assert gp.smem == tiles * gp.res * c * itemsize
    assert gp.smem <= norms._GRID_BUDGET <= 200 * 1024
    # a row per thread's lane at least, unless one segment is all there is
    lanes = 256 // (c // gp.vec)
    assert gp.splits == 1 or gp.rows >= lanes


@pytest.mark.parametrize("whole", [False, True])
@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("b", [1, 2, 8, 16])
@pytest.mark.parametrize("hwc", [(256, 256, 64), (128, 128, 128)])
def test_grid_plan_at_the_path_shapes(hwc, b, itemsize, tiles, whole):
    """IN and AdaIN at 128^2 and 256^2, and the LN, at every batch the path
    runs (2B for the wide decodes), forward and backward, take the grid
    design with 16-byte loads; at batch 1 the whole tensor stays on chip
    forward (8 and 16 MB over 132 blocks)."""
    h, w, c = hwc
    gp = norms.choose(b, h * w, c, itemsize, 0, SMS, tiles, whole)
    assert isinstance(gp, norms.GridPlan) and gp.vec * itemsize == 16
    _assert_grid_plan(gp, b, h * w, c, itemsize, tiles)
    if b == 1 and tiles == 1:
        assert gp.res == gp.rows and gp.blocks == gp.splits


@pytest.mark.parametrize("shape,itemsize,ptr", [
    ((1, 129, 131, 40), 4, 0),   # ragged rows; 10 groups of 4 over 256 threads
    ((2, 7, 5, 40), 4, 0),       # H*W = 35: one segment a sample
    ((1, 9, 1, 3), 4, 8),        # C = 3: one-channel loads, 85 lanes
    ((3, 12, 20, 24), 2, 4),     # bf16, 4-byte aligned: 2-channel loads
    ((300, 4, 4, 8), 4, 0),      # more samples than blocks: several a block
    ((1, 64, 64, 1024), 4, 0),   # C = 1024: 256 vectors, one lane
])
def test_grid_plan_ragged_rows_and_channels(shape, itemsize, ptr):
    b, h, w, c = shape
    for tiles in (1, 2):
        gp = norms.grid_plan(b, h * w, c, itemsize, ptr, SMS, tiles)
        assert gp is not None
        _assert_grid_plan(gp, b, h * w, c, itemsize, tiles)
        assert gp.vec == norms.plan(b, h * w, c, itemsize, ptr, SMS)[0]


def test_grid_plan_keeps_what_fits_on_chip():
    """Above what the blocks hold, each keeps as many rows as the budget
    allows and re-reads the rest; backward holds half as many (x and dy)."""
    fwd = norms.grid_plan(8, 256 * 256, 64, 4, 0, SMS, 1)
    bwd = norms.grid_plan(8, 256 * 256, 64, 4, 0, SMS, 2)
    assert fwd.res < fwd.rows and bwd.res == fwd.res // 2
    assert fwd.smem == bwd.smem == fwd.res * 64 * 4


def test_choose_takes_cluster_then_grid_and_raises_beyond():
    """The cluster design where it fits (IN and AdaIN at the decoders'
    shape), the grid design for everything else, and a raise for a C that
    no block's threads can cover: no split design, no fallback."""
    assert isinstance(norms.choose(1, 64 * 64, 256, 4, 0, SMS),
                      norms.ClusterPlan)
    assert isinstance(norms.choose(1, 64 * 64, 256, 4, 0, SMS, whole=True),
                      norms.GridPlan)
    assert isinstance(norms.choose(1, 128 * 128, 128, 4, 0, SMS),
                      norms.GridPlan)
    assert norms.grid_plan(1, 64, 4096, 4, 0, SMS) is None
    with pytest.raises(ValueError, match="too wide"):
        norms.choose(1, 64 * 64, 4096, 4, 0, SMS, whole=True)
