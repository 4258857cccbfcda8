"""The port's discriminator, domain classifier, losses, pools and optimizers
against the JAX package on the same inputs (numpy, from a seed).

Weights are the JAX package's seeded init, carried into the port by
``munit_tpu_torch.io.weights.from_jax_dis`` / ``from_jax_classifier``.
Forwards agree within rtol 1e-4, atol 1e-5 (float32 sums in another
order); losses and optimizer steps within rtol 1e-5 (the same arithmetic
up to rounding: the port takes Adam's bias corrections in float64, JAX in
float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from munit_tpu import losses as jlosses
from munit_tpu.core import ops as jops
from munit_tpu.io.torch_import import export_dis_state_dict
from munit_tpu.nn import MsImageDis as JDis
from munit_tpu.nn.classifiers import DomainClassifier as JCls
from munit_tpu.nn.classifiers import convert_domain_classifier_state_dict
from munit_tpu.optim import extra_adam_init as j_init
from munit_tpu.optim import extra_adam_update as j_update
from munit_tpu.optim.schedule import from_config as j_schedule
from munit_tpu_torch.core import ops
from munit_tpu_torch.io.weights import from_jax_classifier, from_jax_dis
from munit_tpu_torch.losses import losses
from munit_tpu_torch.nn.classifiers import DomainClassifier
from munit_tpu_torch.nn.discriminator import MsImageDis
from munit_tpu_torch.optim.extra_adam import (adam, extra_adam_init,
                                              extra_adam_update)
from munit_tpu_torch.optim.schedule import from_config as schedule
from tests.torch_mirror import small_dis_params
from tests.torch_port_util import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
D = small_dis_params()


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("size", [32])
def test_discriminator_matches_jax(size):
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    jdis = JDis(input_dim=3, n_layer=D["n_layer"], dim=D["dim"],
                num_scales=D["num_scales"])
    # jitted: one compile instead of one per eager op
    params = jax.jit(jdis.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = jax.jit(jdis.apply)({"params": params}, jnp.asarray(x))
    dis = MsImageDis(3, D["n_layer"], D["dim"], D["norm"], D["activ"],
                     D["num_scales"], D["pad_type"])
    sd = from_jax_dis(params)
    assert set(sd) == set(export_dis_state_dict(params, D))
    assert set(sd) == set(dis.state_dict())
    dis.load_state_dict(sd)
    with torch.no_grad():
        got = dis(torch.from_numpy(x))
    assert len(got) == len(want) == D["num_scales"]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("size", [7, 8])
def test_pools_match_jax(size):
    x = np.random.RandomState(1).randn(2, size, size, 5).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(_np(ops.avg_pool_3x3_s2(t)),
                               np.asarray(jops.avg_pool_3x3_s2(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(ops.max_pool(t, 2, 2)),
                               np.asarray(jops.max_pool(jnp.asarray(x), 2, 2)))


@pytest.fixture(scope="module")
def classifier():
    rng = np.random.RandomState(2)
    c = rng.randn(2, 8, 8, 64).astype(np.float32)
    jcls = JCls()
    v = jax.jit(jcls.init)(jax.random.PRNGKey(3), jnp.asarray(c))
    # non-trivial running statistics, so their update is visible
    stats = jax.tree.map(lambda a: a + 0.1 * rng.rand(*a.shape).astype(
        np.float32), v["batch_stats"])
    cls = DomainClassifier(64)
    cls.load_state_dict(from_jax_classifier(v["params"], stats))
    return jcls, v["params"], stats, cls, c


def test_classifier_forward_and_batch_stats_match_jax(classifier):
    jcls, params, stats, cls, c = classifier
    want, upd = jax.jit(lambda v, c: jcls.apply(v, c, True,
                                                mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(c))
    before = {k: v.clone() for k, v in cls.state_dict().items()}
    with torch.no_grad():
        fool = cls(torch.from_numpy(c))         # the gen step: stats discarded
    for k, v in cls.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    with torch.no_grad():
        got = cls(torch.from_numpy(c), update_stats=True)
    assert tuple(got.shape) == want.shape == (2, 1)
    np.testing.assert_allclose(_np(fool), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    new = from_jax_classifier(params, upd["batch_stats"])
    sd = cls.state_dict()
    for k in new:
        if "running" in k:
            np.testing.assert_allclose(_np(sd[k]), _np(new[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_classifier_carrier_inverts_the_reference_converter(classifier):
    _, params, stats, cls, _ = classifier
    sd = {k: _np(v) for k, v in from_jax_classifier(params, stats).items()}
    back = convert_domain_classifier_state_dict(sd)
    for a, b in zip(jax.tree.leaves(back["params"]), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert set(sd) == set(cls.state_dict())


LOSSES = ["recon_l1", "recon_l1_masked", "dis_gan_loss:lsgan",
          "dis_gan_loss:nsgan", "gen_gan_loss:lsgan", "gen_gan_loss:nsgan",
          "classifier_sr_loss:fool", "classifier_sr_loss:real",
          "classifier_sr_loss:synth", "dis_sr_loss", "gen_sr_loss",
          "domain_adv_loss:minimize", "domain_adv_loss:anonymize"]


@pytest.mark.parametrize("name", LOSSES)
def test_losses_match_jax(name):
    rng = np.random.RandomState(4)
    a, b = (rng.randn(2, 6, 6, 3).astype(np.float32) for _ in range(2))
    mask = (rng.rand(2, 6, 6, 1) > 0.5).astype(np.float32)
    outs = [rng.randn(2, s, s, 1).astype(np.float32) for s in (4, 2)]
    outs_r = [rng.randn(2, s, s, 1).astype(np.float32) for s in (4, 2)]
    logits = [rng.randn(2, 1).astype(np.float32) for _ in range(2)]
    t, j = (lambda v: [torch.from_numpy(o) for o in v]), \
        (lambda v: [jnp.asarray(o) for o in v])
    fn, _, arg = name.partition(":")
    if fn == "recon_l1":
        got, want = losses.recon_l1(*t([a, b])), jlosses.recon_l1(*j([a, b]))
    elif fn == "recon_l1_masked":
        got = losses.recon_l1_masked(*t([a, b, mask]))
        want = jlosses.recon_l1_masked(*j([a, b, mask]))
    elif fn == "dis_gan_loss":
        got = losses.dis_gan_loss(t(outs), t(outs_r), arg)
        want = jlosses.dis_gan_loss(j(outs), j(outs_r), arg)
    elif fn == "gen_gan_loss":
        got, want = (losses.gen_gan_loss(t(outs), arg),
                     jlosses.gen_gan_loss(j(outs), arg))
    elif fn == "dis_sr_loss":
        got = losses.dis_sr_loss(t(outs), t(outs_r))
        want = jlosses.dis_sr_loss(j(outs), j(outs_r))
    elif fn == "gen_sr_loss":
        got, want = losses.gen_sr_loss(t(outs)), jlosses.gen_sr_loss(j(outs))
    elif fn == "domain_adv_loss":
        kw = dict(minimize=arg == "minimize")
        got = losses.domain_adv_loss(*t(logits), **kw)
        want = jlosses.domain_adv_loss(*j(logits), **kw)
    else:
        kw = dict(domain_synth=arg == "synth", fool=arg == "fool")
        got = losses.classifier_sr_loss(*t(logits), **kw)
        want = jlosses.classifier_sr_loss(*j(logits), **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("optimizer", ["adam", "extra_adam"])
def test_optimizer_steps_match_jax(optimizer):
    """Six half-steps (three even and three odd with ExtraAdam) from the
    same start and gradients, with L2 weight decay and a step lr."""
    rng = np.random.RandomState(5)
    start = {"w": rng.randn(3, 4).astype(np.float32),
             "b": rng.randn(4).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) * 10 ** -i
              for k, v in start.items()} for i in range(6)]
    hp = {"lr": 0.01, "lr_policy": "step", "step_size": 3, "gamma": 0.5}
    kw = dict(b1=0.5, b2=0.999, eps=1e-8, weight_decay=1e-4)
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    js = j_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    ts = extra_adam_init(tp)
    for it, g in enumerate(grads):
        lr = schedule(hp)(it)
        assert lr == j_schedule(hp)(it)
        extrapolate = optimizer == "extra_adam" and it % 2 == 0
        jp, js = j_update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                          lr, extrapolate, **kw)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        if optimizer == "adam":
            ts = adam(tg, ts, tp, lr, **kw)
        else:
            ts = extra_adam_update(tg, ts, tp, lr, extrapolate, **kw)
        assert ts.count == int(js.count) and ts.has_copy == bool(js.has_copy)
        for k in start:
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(_np(ts.mu[k]), np.asarray(js.mu[k]),
                                       rtol=1e-5, atol=1e-9)
            np.testing.assert_allclose(_np(ts.params_copy[k]),
                                       np.asarray(js.params_copy[k]),
                                       rtol=1e-5, atol=1e-7)
