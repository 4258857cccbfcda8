"""The moments kernels' plain versions (munit_tpu_torch.kernels.moments) and
the port's whole-LN probe (munit_tpu_torch.tools.normprobe) on the CPU.

The JAX package's probe kernels (P1a, P1b, P2, P3a) are closures inside
each ``tools/normprobe*.py`` script's ``main()``, written for the TPU's
VMEM, and ``tools/`` does not change; so these tests hold the port against
the probes' own yardstick, not against the Pallas calls: the sums against
float64 numpy, and the LayerNorm built from them against
``munit_tpu.core.ops.whole_layer_norm``, the form the TPU probes compare
their variants with. The CUDA kernels themselves are held against these
plain versions on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).

Tolerances: the sums within 1e-6 of the summed magnitudes (float32 sums
against float64); the apply f32 1e-6, bf16 one bf16 ulp; the LayerNorm from
the one-pass moments f32 1e-4 of the output's scale, bf16 two bf16 ulps of
it; the closed-form backward 1e-5 of the largest gradient.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from munit_tpu.core import ops as jops
from munit_tpu_torch.core import ops
from munit_tpu_torch.kernels import moments
from munit_tpu_torch.tools import normprobe
from tests.torch_port_util import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
BF16_ULP = 2**-8


def _x(shape, dtype, seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 2 + 0.5
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_b", [False, True])
def test_sample_sums_plain_against_float64(dtype, with_b):
    a = _x((3, 8, 6, 16), dtype)
    b = _x((3, 8, 6, 16), dtype, seed=1) if with_b else None
    a64 = a.double().numpy().reshape(3, -1)
    b64 = a64 if b is None else b.double().numpy().reshape(3, -1)
    want = np.stack([a64.sum(1), (a64 * b64).sum(1)], 1)
    scale = np.stack([np.abs(a64).sum(1), np.abs(a64 * b64).sum(1)], 1)
    got = moments.sample_sums(a, b)
    assert got.dtype == torch.float32 and got.shape == (3, 2)
    assert np.all(np.abs(got.double().numpy() - want) <= 1e-6 * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
def test_sample_affine_plain_against_float64(dtype, relu):
    rng = np.random.RandomState(2)
    x = _x((2, 5, 4, 8), dtype)
    mean, inv = rng.randn(2), rng.uniform(0.5, 1.5, 2)
    gamma, beta = rng.rand(8), rng.randn(8) * 0.1
    y = ((x.double().numpy() - mean[:, None, None, None])
         * inv[:, None, None, None] * gamma + beta)
    want = np.maximum(y, 0) if relu else y
    got = moments.sample_affine(
        x, *(torch.from_numpy(t.astype(np.float32))
             for t in (mean, inv, gamma, beta)), relu)
    assert got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else BF16_ULP
    np.testing.assert_allclose(got.double().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (1, 8, 8, 128)])
def test_layer_norm_from_sums_matches_jax(dtype, shape):
    """moments.whole_layer_norm (the one-pass moments of sample_sums, then
    sample_affine: the probes' v3) against the JAX package's
    ops.whole_layer_norm, the TPU probes' reference."""
    x = _x(shape, dtype)
    rng = np.random.RandomState(3)
    gamma = rng.rand(shape[3]).astype(np.float32)
    beta = (0.01 * rng.randn(shape[3])).astype(np.float32)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16 if dtype == torch.bfloat16
                     else jnp.float32)
    want = np.asarray(jops.whole_layer_norm(xj, jnp.asarray(gamma),
                                            jnp.asarray(beta)), np.float32)
    got = moments.whole_layer_norm(x, torch.from_numpy(gamma),
                                   torch.from_numpy(beta)).float().numpy()
    scale = np.abs(want).max()
    tol = 1e-4 if dtype == torch.float32 else 2 * BF16_ULP
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_closed_form_backward_matches_autograd():
    """P3's v2 (LNFromSums): the forward from the moments, the backward in
    closed form on sample_sums(ĝ, y − mean), against autograd of the plain
    LayerNorm + ReLU, float32."""
    y = _x((2, 8, 8, 16), torch.float32, seed=4)
    rng = np.random.RandomState(5)
    gamma = torch.from_numpy(rng.rand(16).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.randn(16)).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 8, 8, 16).astype(np.float32))
    grads = []
    for fn in (normprobe.LNFromSums.apply,
               lambda t, gm, bt: torch.relu(ops.whole_layer_norm(t, gm, bt))):
        yy = y.clone().requires_grad_(True)
        out = fn(yy, gamma, beta)
        grads.append((out.detach(), torch.autograd.grad(out, yy, g)[0]))
    (o1, d1), (o2, d2) = grads
    torch.testing.assert_close(o1, o2, rtol=1e-5, atol=1e-5)
    scale = d2.abs().max().item()
    torch.testing.assert_close(d1, d2, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", normprobe.P1_SHAPES)
@pytest.mark.parametrize("channels", [False, True])
def test_plan_takes_16_byte_vectors_at_the_probe_shapes(shape, itemsize,
                                                        channels):
    """Both kernels read 16 bytes per access at every probe shape: the sums
    (no channel row to respect) as well as the apply (C a multiple of the
    vector)."""
    b, h, w, c = shape
    n = h * w * c
    vec, splits, chunk = moments.plan(b, n, itemsize, 0, 132,
                                      c if channels else None)
    assert vec * itemsize == 16
    assert chunk % vec == 0 and (splits - 1) * chunk < n <= splits * chunk
    assert b * splits >= 132


def test_plan_narrows_vectors_to_alignment_and_channels():
    assert moments.plan(1, 4096, 4, 8, 132)[0] == 2          # 8-byte aligned
    assert moments.plan(1, 4096, 2, 0, 132, 3)[0] == 1       # apply, C = 3
    assert moments.plan(1, 4096, 2, 0, 132, 12)[0] == 4      # apply, C = 12
    assert moments.plan(1, 4098, 2, 0, 132)[0] == 2          # n = 2 mod 8


def test_wrappers_on_cpu_count_no_launch():
    moments.reset_launches()
    x = _x((1, 4, 4, 8), torch.float32)
    moments.whole_layer_norm(x, torch.ones(8), torch.zeros(8), relu=True)
    assert moments.launches == {"sample_sums": 0, "sample_affine": 0}


def test_normprobe_cli_small_on_cpu():
    """python -m munit_tpu_torch.tools.normprobe --device cpu --small, end
    to end: every probe's variants, host times (no device metric on the
    CPU) and errors against the plain variant."""
    out = subprocess.run(
        [sys.executable, "-m", "munit_tpu_torch.tools.normprobe",
         "--device", "cpu", "--small", "--k", "1", "--reps", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = json.loads(out.stdout.strip().splitlines()[-1])["rows"]
    assert {r["probe"] for r in rows} == {"P1", "P2", "P3"}
    assert len(rows) == 3 * 5 + 2 * 5 + 3
    assert all("host_ms" in r and "ms" not in r for r in rows)
    for r in rows:
        err = r.get("max_err_vs_plain")
        if err is None:
            continue
        scale = r.get("plain_scale", 1.0)
        tol = {"P1": 2 * BF16_ULP, "P2": 1e-4, "P3": 1e-5}[r["probe"]]
        assert err <= tol * scale, r
    p3 = [r for r in rows if r["probe"] == "P3"]
    assert all(r["plain_rerun_err"] == 0 for r in p3)
    assert all(r["block_err_vs_plain"] <= 2e-2 for r in p3)


def test_normprobe_defaults_to_the_card():
    """The default device is cuda; without a card the probe raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        normprobe.run()
