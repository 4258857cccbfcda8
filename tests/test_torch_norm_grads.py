"""The gradients of the port's norm wrappers (munit_tpu_torch.kernels.norms)
against the JAX package's backward rules, on the same numpy inputs.

On the CPU a wrapper's backward is its plain closed form, the arithmetic the
CUDA backward kernels implement. It is held against ``jax.vjp`` of the JAX
package's norms: the jnp forms with the recompute-stats rules
(``instance_norm_ref``, ``adain_ref``: ``_in_bwd``, ``_adain_bwd``), autodiff
of ``ops.whole_layer_norm`` (what ``_ln_bwd`` takes), and the Pallas forms
run in interpret mode (``instance_norm_fused``, ``adain_fused``,
``whole_layer_norm_fused``). Tolerance rtol 1e-4, atol 1e-5: float32
statistics in another order (JAX's one-pass moments, the port's two-pass).
The inputs keep every pre-activation 0.3 |gamma| or more away from the ReLU's
threshold, so the two packages' recomputed masks agree. A float64
``gradcheck`` holds the closed form against finite differences of the
forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from munit_tpu.core import ops as jops
from munit_tpu.kernels import norms as jnorms
from munit_tpu_torch.kernels import norms
from tests.torch_port_util import one_torch_thread  # noqa: F401

SHAPE = (2, 8, 8, 16)
RTOL, ATOL = 1e-4, 1e-5


def gap_inputs(shape, rng):
    """x, (B, C) and (C,) gamma, beta with |x̂ + beta / gamma| >= ~0.3 and
    |gamma| >= 0.5 (AdaIN) or in [0.5, 1.5) (LN); dy ~ N(0, 1)."""
    b, _, _, c = shape
    x = rng.randn(*shape)
    x = np.sign(x) * (1 + np.abs(x)) + 0.5

    def affine(*s):
        g = np.where(rng.rand(*s) < 0.5, -1.0, 1.0) * (0.5 + rng.rand(*s))
        return g, g * (rng.rand(*s) * 0.4 - 0.2)

    g2, b2 = affine(b, c)
    g1, b1 = affine(c)
    g1, b1 = np.abs(g1), np.abs(g1) * (b1 / g1)
    dy = rng.randn(*shape)
    return [a.astype(np.float32) for a in (x, g2, b2, g1, b1, dy)]


@pytest.fixture(scope="module")
def data():
    return gap_inputs(SHAPE, np.random.RandomState(0))


def _port_grads(name, x, g2, b2, g1, b1, dy, relu):
    """(dx, dgamma, dbeta) through the wrapper's autograd Function."""
    t = lambda a: torch.from_numpy(a).requires_grad_(True)  # noqa: E731
    xt = t(x)
    if name == "instance_norm":
        y = norms.instance_norm(xt, relu)
        return [g.numpy() for g in torch.autograd.grad(y, xt,
                                                       torch.from_numpy(dy))]
    g, b = (t(g2), t(b2)) if name == "adain" else (t(g1), t(b1))
    fn = norms.adain if name == "adain" else norms.whole_layer_norm
    y = fn(xt, g, b, relu)
    assert y.grad_fn is not None
    return [v.numpy() for v in torch.autograd.grad(y, [xt, g, b],
                                                   torch.from_numpy(dy))]


def _relu(y, relu):
    return jnp.maximum(y, 0.0) if relu else y


JAX_FORMS = {
    # the nets' default jnp forms with the JAX package's custom VJPs
    ("instance_norm", "ref"): lambda x, g, b, r: jnorms.instance_norm_ref(x, r),
    ("adain", "ref"): lambda x, g, b, r: jnorms.adain_ref(x, g, b, r),
    ("whole_layer_norm", "ref"):
        lambda x, g, b, r: _relu(jops.whole_layer_norm(x, g, b), r),
    # the Pallas kernels in interpret mode, with their custom VJPs
    ("instance_norm", "pallas"):
        lambda x, g, b, r: jnorms.instance_norm_fused(x, r),
    ("adain", "pallas"): lambda x, g, b, r: jnorms.adain_fused(x, g, b, r),
    ("whole_layer_norm", "pallas"):
        lambda x, g, b, r: jnorms.whole_layer_norm_fused(x, g, b, r),
}


def _jax_grads(name, form, x, g2, b2, g1, b1, dy, relu):
    g, b = (g2, b2) if name == "adain" else (g1, b1)
    fn = JAX_FORMS[(name, form)]
    if name == "instance_norm":
        _, vjp = jax.vjp(lambda x: fn(x, None, None, relu), jnp.asarray(x))
    else:
        _, vjp = jax.vjp(lambda x, g, b: fn(x, g, b, relu),
                         *map(jnp.asarray, (x, g, b)))
    return [np.asarray(v) for v in vjp(jnp.asarray(dy))]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("form", ["ref", "pallas"])
@pytest.mark.parametrize("name", ["instance_norm", "adain", "whole_layer_norm"])
def test_backward_matches_jax_rules(data, name, form, relu):
    got = _port_grads(name, *data, relu)
    want = _jax_grads(name, form, *data, relu)
    assert len(got) == len(want) == (1 if name == "instance_norm" else 3)
    for part, g, w in zip(("dx", "dgamma", "dbeta"), got, want):
        assert g.shape == w.shape, part
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {form} {part}")


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("name", ["instance_norm", "adain", "whole_layer_norm"])
def test_closed_form_backward_gradcheck(name, relu):
    """Finite differences of the float64 forward against the closed form."""
    x, g2, b2, g1, b1, _ = gap_inputs((2, 4, 5, 3), np.random.RandomState(1))
    t = lambda a: torch.from_numpy(a.astype(np.float64)).requires_grad_(True)  # noqa: E731
    if name == "instance_norm":
        fn, args = (lambda x: norms.instance_norm(x, relu)), (t(x),)
    elif name == "adain":
        fn = lambda x, g, b: norms.adain(x, g, b, relu)  # noqa: E731
        args = (t(x), t(g2), t(b2))
    else:
        fn = lambda x, g, b: norms.whole_layer_norm(x, g, b, relu)  # noqa: E731
        args = (t(x), t(g1), t(b1))
    assert torch.autograd.gradcheck(fn, args)


def test_bf16_backward_keeps_the_types():
    """bf16 x gives a bf16 dx and f32 affine grads for f32 gamma, beta."""
    x, g2, b2, *_ = gap_inputs(SHAPE, np.random.RandomState(2))
    xb = torch.from_numpy(x).bfloat16().requires_grad_(True)
    g = torch.from_numpy(g2).requires_grad_(True)
    b = torch.from_numpy(b2).requires_grad_(True)
    y = norms.adain(xb, g, b, True)
    dx, dg, db = torch.autograd.grad(y, [xb, g, b], torch.ones_like(y))
    assert (dx.dtype, dg.dtype, db.dtype) == (torch.bfloat16, torch.float32,
                                              torch.float32)
