"""The port's training step (munit_tpu_torch.train.trainer) against the JAX
package's ``MUNITTrainer``: the gradients of one fused dis+gen step.

Small widths (``small_gen_params``, ``small_dis_params``), 32 px, batch 2,
``recon_mask: 1`` with seeded masks, ``adv_lambda: 6``, ``dfeat_lambda:
1``, ``semantic_w: 0``. The port starts from the JAX trainer's seeded
state, carried by ``munit_tpu_torch.io.weights``. Gradients agree leaf by
leaf within 2e-4 of each leaf's largest |g| (float32 sums in another order
through ~40 layers forward and back, and JAX's space-to-depth and packed
rewrites against the port's plain convolutions). The port's own fused step
equals its unfused pair, as tests/test_fused_step.py pins for JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from munit_tpu.config import validate as jvalidate
from munit_tpu.train import MUNITTrainer as JTrainer
from munit_tpu_torch.config import validate
from munit_tpu_torch.io.weights import from_jax_dis, from_jax_params
from munit_tpu_torch.nn.blocks import ConvBlock
from munit_tpu_torch.train.trainer import MUNITTrainer
from tests.torch_port_util import (load_jax_state, one_torch_thread,  # noqa: F401
                                   small_train_spec, train_batch)

GRAD_TOL = 2e-4


@pytest.fixture(scope="module")
def jax_grads():
    """One JAX trainer: its seeded state and its dis_gen_grads."""
    jtr = JTrainer(jvalidate(small_train_spec()), jax.random.PRNGKey(0))
    batch = train_batch(1)
    grads_d, grads_g = jtr.dis_gen_grads(*map(jnp.asarray, batch))
    want = {f"{d}.{k}": v.numpy() for d in ("a", "b")
            for k, v in from_jax_dis(grads_d[d]).items()}
    want.update({k: v.numpy() for k, v in from_jax_params(grads_g).items()})
    return jtr.state, batch, want


def _port(state):
    tr = MUNITTrainer(validate(small_train_spec()), "cpu")
    load_jax_state(tr, state)
    return tr


def _removed_by_a_norm(tr):
    """Names of the conv biases that an instance norm or AdaIN removes."""
    return {f"{n}.conv.bias" for n, m in tr.gen.module.named_modules()
            if isinstance(m, ConvBlock) and m.norm_type in ("in", "adain")}


def test_dis_gen_grads_match_jax(jax_grads):
    state, batch, want = jax_grads
    tr = _port(state)
    grads_d, grads_g = tr.dis_gen_grads(*map(torch.from_numpy, batch))
    got = {**grads_d, **grads_g}
    assert set(got) == set(want)
    zero = _removed_by_a_norm(tr)
    net_scale = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        g = got[k].numpy()
        if k in zero:
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-6 * net_scale, k
            continue
        scale = np.abs(w).max()
        assert scale > 0, f"{k}: JAX gradient is all zero"
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=k)


def test_every_generator_parameter_gets_a_gradient(jax_grads):
    """The norms are autograd Functions: the gradient reaches every
    parameter upstream of them, the content encoders' first convs too."""
    tr = _port(jax_grads[0])
    _, grads_g = tr.dis_gen_grads(*map(torch.from_numpy, jax_grads[1]))
    assert set(grads_g) == set(tr.gen_params())
    scale = max(g.abs().max().item() for g in grads_g.values())
    zero = _removed_by_a_norm(tr)
    assert len(zero) == 2 * (3 + 4) + 2 * 4     # small gen: n_res 2
    dead = [k for k, g in grads_g.items()
            if k not in zero and not g.abs().max().item() > 1e-5 * scale]
    assert not dead, dead


def test_fused_step_matches_unfused_pair(jax_grads):
    """dis_gen_update ≡ dis_update then gen_update at the same iteration."""
    state, batch, _ = jax_grads
    x_a, x_b, m_a, m_b = map(torch.from_numpy, batch)
    t1, t2 = _port(state), _port(state)
    for it in range(2):
        t1.iterations = t2.iterations = it
        m_sep = dict(t1.dis_update(x_a, x_b))
        m_sep.update(t1.gen_update(x_a, x_b, m_a, m_b))
        m_fused = t2.dis_gen_update(x_a, x_b, m_a, m_b)
        for k in ("loss_dis_total", "loss_gen_total", "loss_gen_adv_a",
                  "loss_gen_cycrecon_x_a", "loss_classifier_adv_sr"):
            np.testing.assert_allclose(float(m_fused[k]), float(m_sep[k]),
                                       rtol=1e-5, err_msg=f"{k} it={it}")
    for name in ("gen_params", "dis_params"):
        p1, p2 = getattr(t1, name)(), getattr(t2, name)()
        for k in p1:
            np.testing.assert_allclose(p1[k].detach().numpy(),
                                       p2[k].detach().numpy(), rtol=1e-4,
                                       atol=2.5e-4, err_msg=k)


@pytest.mark.parametrize("key,value", [
    ("guided", 0), ("grad_accum", 2),
    ("adaptation", {"adv_lambda": 6, "dfeat_lambda": 1, "sem_seg_lambda": 1}),
    ("vgg_w", 1), ("domain_adv_w", 1), ("recon_synth_w", 1)])
def test_unported_options_raise(key, value):
    with pytest.raises(NotImplementedError, match="not ported"):
        MUNITTrainer(validate(small_train_spec(**{key: value})), "cpu")


def test_collapsed_discriminator_pyramid_raises():
    with pytest.raises(ValueError, match="pyramid"):
        MUNITTrainer(validate(small_train_spec(crop_image_height=8,
                                               crop_image_width=8)), "cpu")
