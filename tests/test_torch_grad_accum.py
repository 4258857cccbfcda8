"""Gradient accumulation (``grad_accum: K``, ROADMAP item 13) in the port
against the JAX package's (``munit_tpu/train/trainer.py:638-686``,
``:885-1023``; docs/PARITY.md #12, #12b), at small widths, 32 px, batch 4,
K = 2, with the masked cycle loss, the frozen segmenter (``semantic_w: 3``,
the numpy-made weights of ``torch_port_util.seg_ref_weights``) and the
sim/real classifier's fool term (``adv_lambda: 6``), whose train-mode batch
norm takes each micro-batch's own statistics in both packages.

- JAX trainers at K = 2, guided 1 and guided 0. Each step in lockstep:
  the port starts from the JAX state before it. Guided 1: the dis step
  (plain, and with ``accum_chunk_dis``), the gen step, the fused step
  (exact, and with ``accum_shared_fwd``); guided 0: the exact fused step on
  JAX's own draws, rebuilt from the state's ``rng``. Every loss within
  rtol 1e-4 (atol 1e-7), each update held to JAX's (``update_errors``:
  within 1e-2 lr but for at most 1 % of a net's weights, none past 2 lr),
  every other net unmoved. The JAX trainer reads its switches when it
  traces its steps, so each setting has a trainer of its own. The guided
  steps again in two other orders (OTHER_ORDERS), each from its JAX state,
  the port in float32 and float64: the losses as above, each update held
  to JAX's in one precision or the other (``past_in_both``).
- Torch only, at adv_lambda 0 (every term a full-count mean): K = 2
  against K = 1 from one state, each step kind and variant, the losses
  within rtol 2e-5 and the updates held as above; the accumulated
  gradients against the full batch's within 1e-4 of each leaf's largest;
  ``_accum`` against an exact chunk mean; one micro-batch's forward live
  at a time.
- ``MUNIT_GRAD_ACCUM`` and the two switches over the config keys, JAX's
  validation messages, and the warning of the classifier term with its
  absence at K = 1.
"""

import gc
import warnings
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from munit_tpu.config import validate as jvalidate
from munit_tpu.nn.resnet import convert_resnet34_8s_state_dict
from munit_tpu.train import MUNITTrainer as JTrainer
from munit_tpu_torch.config import validate
from munit_tpu_torch.core import ops
from munit_tpu_torch.io import checkpoint
from munit_tpu_torch.nn.blocks import ConvBlock
from munit_tpu_torch.train.trainer import MUNITTrainer
from tests.torch_port_util import (MOVED, SMALL_GEN,  # noqa: F401
                                   UPDATE_SHARE, check_update, jax_draws,
                                   net_groups, one_torch_thread,
                                   past_in_both, port_state,
                                   seg_ref_weights, small_train_spec,
                                   train_batch, update_errors)

LR = 1e-4
B, K = 4, 2
# (label, step kind, the switches it runs with), in the lockstep's order.
GUIDED_STEPS = (("dis", "dis", {}),
                ("dis chunk_dis", "dis", {"accum_chunk_dis": 1}),
                ("gen", "gen", {}),
                ("fused shared_fwd", "dis_gen", {"accum_shared_fwd": 1}),
                ("fused", "dis_gen", {}))
STEPS = {s[0]: s for s in GUIDED_STEPS}
# The same steps in two other orders, so from other JAX states: the exact
# fused step before the shared-forward one (the first three steps are
# GUIDED_STEPS'), and the two dis steps swapped. There the port's float32
# update of the generator parts from JAX's in 1.6-8.2 % of its weights in
# three steps, and its float64 one (from the same state) in 0.05-0.36 %;
# in a fourth the float64 one parts (6.5 %) and the float32 one holds
# (0.09 %). Each gap is one to five ReLU inputs within 5e-8 to 1.2e-6 of 0
# (of their input's largest |x|) that one precision puts on the other side
# of the kink; Adam passes such a gradient change on once its moments hold
# a step. The port's float32 crosses kinks more often than JAX's, and its
# CPU convolution (oneDNN) is why: it rounds 2.4x coarser than XLA's at
# 3x3 and 1.7x at 5x5, and over 12 seeds of the fused step's gradients the
# port's float32 crossed 6 times (5 on the inputs matched to JAX's, where
# JAX's crossed once); with each of its convolutions computed in float64
# and rounded, once (0 on the matched). ``python -m tests.test_torch_semantic
# [--exact-conv]`` and ``python -m tests.test_torch_grad_accum`` print
# these readings. In those orders each update is held to JAX's in the
# float32 or the float64 port (``past_in_both``): a fault of the port's
# math parts in both.
OTHER_ORDERS = (("fused first", ("dis", "dis chunk_dis", "gen", "fused",
                                 "fused shared_fwd")),
                ("dis swapped", ("dis chunk_dis", "dis", "gen",
                                 "fused shared_fwd", "fused")))
UNGUIDED_STEPS = (("fused guided 0", "dis_gen", {}),)
UPDATED = {"dis": ("dis",), "gen": ("gen",), "dis_gen": ("gen", "dis")}
SWITCHES = ("accum_chunk_dis", "accum_shared_fwd")


@pytest.fixture(autouse=True)
def parity():
    ops.set_conv_compute(None)
    yield
    ops.set_conv_compute(None)


def spec(**over):
    """small_train_spec at batch 4, K = 2, with the segmenter."""
    return small_train_spec(**{"batch_size": B, "grad_accum": K,
                               "semantic_w": 3, **over})


def port_trainer(conf, seg=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        tr = MUNITTrainer(conf, "cpu")
    tr.init(torch.Generator().manual_seed(0))
    if seg is not None:
        tr.load_segmenter({k: torch.from_numpy(v) for k, v in seg.items()})
    return tr


def run_step(tr, kind, batch, styles=None):
    x_a, x_b, m_a, m_b = batch
    if kind == "dis":
        return tr.dis_update(x_a, x_b, styles=styles)
    if kind == "gen":
        return tr.gen_update(x_a, x_b, m_a, m_b, styles=styles)
    return tr.dis_gen_update(x_a, x_b, m_a, m_b, styles=styles)


def jax_step(jtr, kind, batch):
    x_a, x_b, m_a, m_b = batch
    if kind == "dis":
        return jtr.dis_update(x_a, x_b)
    if kind == "gen":
        return jtr.gen_update(x_a, x_b, m_a, m_b)
    return jtr.dis_gen_update(x_a, x_b, m_a, m_b)


def jax_trainers(raw, guided, seg, steps):
    """A JAX trainer at K = 2 for each setting of the switches that
    ``steps`` take. The JAX trainer reads its switches when it traces its
    steps, so each setting gets a trainer of its own, set before any trace;
    the lockstep hands the state from one to the next."""
    out = {}
    for _, _, switches in steps:
        flags = tuple(bool(switches.get(s)) for s in SWITCHES)
        if flags in out:
            continue
        with pytest.warns(UserWarning, match="chunk statistics"):
            jtr = JTrainer(jvalidate(raw), jax.random.PRNGKey(guided))
        assert jtr.grad_accum == K and jtr.fused
        jtr.load_segmenter(jax.tree.map(jnp.asarray,
                                        convert_resnet34_8s_state_dict(seg)))
        if any(flags):
            for s, v in zip(SWITCHES, flags):
                setattr(jtr, s, v)
            jtr._build_steps()
        out[flags] = jtr
    return out


def jax_steps(trainers, steps, state, jb):
    """Each of ``steps`` in turn from ``state`` (numpy), on the trainer of
    its switches: (label, kind, switches, JAX's metrics, state before,
    state after)."""
    out = []
    for label, kind, switches in steps:
        jtr = trainers[tuple(bool(switches.get(s)) for s in SWITCHES)]
        jtr.state = jax.tree.map(jnp.asarray, state)
        jtr.iterations = 0
        want = {k: float(v) for k, v in jax_step(jtr, kind, jb).items()}
        after = jax.tree.map(np.array, jtr.state)
        out.append((label, kind, switches, want, state, after))
        state = after
    return out


def to_float64(tr):
    """The port trainer's nets, segmenter and optimizer state in float64."""
    for net in (*tr._nets().values(), tr.segmenter):
        if net is not None:
            net.double()
    for o in tr._opts().values():
        for f in ("mu", "nu", "params_copy"):
            setattr(o, f, {k: v.double() for k, v in getattr(o, f).items()})


def port_step(raw, seg, rec, tb, guided, dtype=torch.float32):
    """The port's step of a JAX step record, from JAX's state before it:
    (metrics, {net: {name: float32 numpy}} after)."""
    label, kind, switches, _, before, _ = rec
    tr = port_trainer(validate(dict(raw, **switches)), seg)
    assert (tr.accum_chunk_dis, tr.accum_shared_fwd) == tuple(
        bool(switches.get(s)) for s in SWITCHES)
    tr.load_state_dict(port_state(before, 0))
    if dtype == torch.float64:
        to_float64(tr)
    draws = (None if guided else
             jax_draws(before, kind, B, SMALL_GEN["style_dim"]))
    got = {k: float(v) for k, v in run_step(
        tr, kind, [t.to(dtype) for t in tb],
        None if draws is None else [d.to(dtype) for d in draws]).items()}
    nets = {k: {n: v.float() for n, v in d.items()}
            for k, d in tr.state_dict()["nets"].items()}
    return got, net_groups(nets)


def groups(rec, i):
    """JAX's nets before (i = 4) or after (i = 5) a step, per net."""
    return net_groups(port_state(rec[i], 0)["nets"])


@pytest.fixture(scope="module")
def runs():
    """Two JAX trainers at K = 2 (guided 1 and 0); each step from the JAX
    state before it, the port in lockstep: GUIDED_STEPS and
    UNGUIDED_STEPS in float32, and the steps of OTHER_ORDERS that differ
    from GUIDED_STEPS' in float32 and float64."""
    seg = seg_ref_weights(0)
    batch = train_batch(5, B)
    jb = list(map(jnp.asarray, batch))
    tb = [torch.from_numpy(a) for a in batch]
    out, other = [], {}
    for guided, steps in ((1, GUIDED_STEPS), (0, UNGUIDED_STEPS)):
        raw = spec(guided=guided)
        trainers = jax_trainers(raw, guided, seg, steps)
        start = jax.tree.map(np.array, next(iter(trainers.values())).state)
        recs = jax_steps(trainers, steps, start, jb)
        for rec in recs:
            got, nets = port_step(raw, seg, rec, tb, guided)
            out.append((rec[0], rec[1], rec[3], got, update_errors(
                groups(rec, 4), groups(rec, 5), nets, LR, {})))
        if not guided:
            continue
        for order, labels in OTHER_ORDERS:
            shared = next(i for i, (a, b) in enumerate(
                zip(labels, (s[0] for s in steps))) if a != b)
            for rec in jax_steps(
                    trainers, [STEPS[x] for x in labels[shared:]],
                    recs[shared - 1][5] if shared else start, jb):
                runs_ = [port_step(raw, seg, rec, tb, guided, dt)
                         for dt in (torch.float32, torch.float64)]
                before, after = groups(rec, 4), groups(rec, 5)
                other[(order, rec[0])] = (
                    rec[1], rec[3], runs_[0][0],
                    update_errors(before, after, runs_[0][1], LR, {}),
                    update_errors(before, after, runs_[1][1], LR, {}),
                    past_in_both(before, after, runs_[0][1], runs_[1][1],
                                 LR))
    return out, other


ALL_STEPS = GUIDED_STEPS + UNGUIDED_STEPS


@pytest.mark.parametrize("i", range(len(ALL_STEPS)),
                         ids=[s[0] for s in ALL_STEPS])
def test_step_matches_jax_at_k2(runs, i):
    """The step's losses within rtol 1e-4 of JAX's, its update held to
    JAX's, the nets it does not update unmoved; the classifier's fool term
    (per-chunk statistics in both) and the semantic loss above 0."""
    label, kind, want, got, errs = runs[0][i]
    assert label == ALL_STEPS[i][0]
    assert set(got) <= set(want), set(got) - set(want)
    if kind != "dis":
        assert got["loss_classifier_adv_sr"] > 0 and got["loss_sem_seg"] > 0
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-7,
                                   err_msg=f"{k} {label}")
    for net, e in errs.items():
        check_update(e, net in UPDATED[kind], f"{label} {net}")


OTHER_STEPS = [(order, label) for order, labels in OTHER_ORDERS
               for i, label in enumerate(labels)
               if labels[:i + 1] != tuple(s[0] for s in GUIDED_STEPS)[:i + 1]]


@pytest.mark.parametrize("order,label", OTHER_STEPS,
                         ids=[f"{o}-{x}" for o, x in OTHER_STEPS])
def test_step_matches_jax_at_k2_in_other_orders(runs, order, label):
    """A step of OTHER_ORDERS: the float32 port's losses within rtol 1e-4
    of JAX's; in each net it updates, at most UPDATE_SHARE of the weights
    part from JAX's update in both the float32 and the float64 port, the
    float32 update moved and its statistics held; every other net
    unmoved in both."""
    kind, want, got, e32, e64, both = runs[1][(order, label)]
    assert set(got) <= set(want), set(got) - set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-7,
                                   err_msg=f"{k} {order} {label}")
    for net, e in e32.items():
        tag = f"{order} {label} {net}"
        assert e["stats"] <= 1.0 and e64[net]["stats"] <= 1.0, (tag, e)
        if net in UPDATED[kind]:
            assert both[net] <= UPDATE_SHARE, (tag, both[net], e, e64[net])
            assert e["moved"] >= MOVED, (tag, e)
        else:
            assert e["still"] == e64[net]["still"] == 0.0, (tag, e)


# --------------------------------------------------- K = 2 against K = 1

def full_mean_spec(k, **over):
    """Every term a full-count mean: no classifier fool term."""
    return small_train_spec(batch_size=B, grad_accum=k, semantic_w=3,
                            adaptation={"adv_lambda": 0, "dfeat_lambda": 1,
                                        "classif_frequency": 2}, **over)


@pytest.fixture(scope="module")
def k1_runs():
    """Each step kind at K = 1 from one seeded state: (state before,
    metrics, nets after), for gan_w 3 and 0."""
    seg = seg_ref_weights(1)
    batch = [torch.from_numpy(a) for a in train_batch(6, B)]
    out = {}
    for gan_w in (3, 0):
        tr = port_trainer(validate(full_mean_spec(1, gan_w=gan_w)), seg)
        start = checkpoint.to_host(tr.state_dict())
        for kind in ("dis", "gen", "dis_gen"):
            tr.load_state_dict(start)
            m = {k: float(v) for k, v in run_step(tr, kind, batch).items()}
            out[(gan_w, kind)] = (m, net_groups(tr.state_dict()["nets"]))
        out[gan_w] = start
    return seg, batch, out


K_CASES = (("dis", {}, 3), ("dis", {"accum_chunk_dis": 1}, 3),
           ("gen", {}, 3), ("dis_gen", {}, 3),
           ("dis_gen", {"accum_chunk_dis": 1}, 3),
           ("dis_gen", {"accum_shared_fwd": 1}, 0))


@pytest.mark.parametrize("kind,switches,gan_w", K_CASES,
                         ids=[f"{k}-{'-'.join(s) or 'exact'}-gan_w{g}"
                              for k, s, g in K_CASES])
def test_k2_equals_k1_on_full_count_mean_terms(k1_runs, kind, switches,
                                               gan_w):
    """At adv_lambda 0 the port's K = 2 step is its K = 1 step up to
    float32 reassociation: the losses within rtol 2e-5 and the updates
    held to K = 1's. The shared-forward variant takes its adversarial
    terms against the D before its update (PARITY #12b): with gan_w 0
    there are none, and it equals K = 1 too."""
    seg, batch, out = k1_runs
    tr = port_trainer(validate(full_mean_spec(K, gan_w=gan_w, **switches)),
                      seg)
    start = out[gan_w]
    tr.load_state_dict(start)
    got = {k: float(v) for k, v in run_step(tr, kind, batch).items()}
    want, nets = out[(gan_w, kind)]
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=2e-5, atol=1e-7,
                                   err_msg=k)
    errs = update_errors(net_groups(start["nets"]), nets,
                         net_groups(tr.state_dict()["nets"]), LR, {})
    for net, e in errs.items():
        check_update(e, net in UPDATED[kind], f"{kind} {net}")


@pytest.mark.parametrize("part", ["dis", "gen"])
def test_accumulated_gradients_equal_the_full_batch(k1_runs, part):
    """The chunk mean of D's and of the generator's gradients (no
    optimizer in the way) against the full batch's: every leaf within 1e-4
    of its largest gradient, but the conv biases that a norm takes out,
    whose gradient is zero: below 1e-5 of the largest in both."""
    seg, batch, out = k1_runs
    trs = [port_trainer(validate(full_mean_spec(k)), seg) for k in (1, K)]
    grads = []
    for tr in trs:
        tr.load_state_dict(out[3])
        if part == "dis":
            fn, args = tr._dis_chunk, batch[:2]
        else:
            fn = lambda *a: tr._gen_chunk(False, False, *a)  # noqa: E731
            args = (*batch, None, None)
        g, _ = tr._accum(fn, args)
        grads.append(g)
    assert grads[0].keys() == grads[1].keys()
    # a conv bias that an IN or AdaIN takes out has a zero gradient, of
    # which both runs hold float32 noise
    removed = {f"{n}.conv.bias" for n, m in trs[0].gen.module.named_modules()
               if isinstance(m, ConvBlock) and m.norm_type in ("in", "adain")}
    top = max(g.abs().max().item() for g in grads[0].values())
    for k, want in grads[0].items():
        if k in removed:
            for g in (want, grads[1][k]):
                assert g.abs().max().item() <= 1e-5 * top, k
            continue
        scale = want.abs().max().item()
        err = (grads[1][k] - want).abs().max().item()
        assert err <= 1e-4 * scale, (k, err, scale)


def test_accum_is_the_exact_chunk_mean():
    """``_accum`` over K = 4 slices: the mean of the chunks' gradients and
    metrics, summed from zero and times 1/K, a None input passed through,
    and a batch that K does not divide refused."""
    tr = port_trainer(validate(small_train_spec(batch_size=8,
                                                grad_accum=4)))
    x = torch.arange(8.0).reshape(8, 1)
    seen = []

    def chunk(x, none):
        seen.append(none)
        return {"g": x * 2.0}, {"m": x.mean() + 100.0}
    g, m = tr._accum(chunk, (x, None))
    assert seen == [None] * 4
    want = (np.arange(8.0) * 2).reshape(4, 2, 1).mean(axis=0)
    np.testing.assert_array_equal(g["g"].numpy(), want)
    assert float(m["m"]) == np.arange(8.0).mean() + 100.0
    with pytest.raises(ValueError, match="not divisible by grad_accum 4"):
        tr._accum(chunk, (torch.zeros(6, 1), None))


def test_one_micro_batch_of_the_forward_is_live_at_a_time():
    """Each chunk's generator forward is freed before the next chunk's
    starts, in the gen step and the fused step's both variants: what the
    graphs' pool reuses on a card."""
    for switches in ({}, {"accum_shared_fwd": 1}):
        tr = port_trainer(validate(spec(semantic_w=0, **switches)))
        refs, forward = [], tr._gen_forward

        def spy(*a, **k):
            gc.collect()
            assert all(r() is None for r in refs), switches
            fw = forward(*a, **k)
            refs.extend(weakref.ref(v) for v in fw.values())
            return fw
        tr._gen_forward = spy
        batch = [torch.from_numpy(a) for a in train_batch(2, B)]
        tr.gen_update(*batch)
        tr.dis_gen_update(*batch)
        assert len(refs) == 2 * K * 14


# ---------------------------------------------------------------- knobs

@pytest.mark.parametrize("env,key,want", [
    ("2", 1, 2), ("1", 2, 1), (None, 2, 2), ("4", 1, 4)])
def test_munit_grad_accum_over_the_key(monkeypatch, env, key, want):
    if env is None:
        monkeypatch.delenv("MUNIT_GRAD_ACCUM", raising=False)
    else:
        monkeypatch.setenv("MUNIT_GRAD_ACCUM", env)
    tr = port_trainer(validate(spec(grad_accum=key)))
    assert tr.grad_accum == want


@pytest.mark.parametrize("name", ["accum_shared_fwd", "accum_chunk_dis"])
@pytest.mark.parametrize("env,key,want", [
    (None, 0, False), (None, 1, True), ("1", 0, True), ("0", 1, False)])
def test_accum_switches_env_over_key(monkeypatch, name, env, key, want):
    """Each switch as the JAX trainer reads it (trainer.py:308-321), with
    its default 0 in both packages' configs."""
    var = "MUNIT_" + name.upper()
    if env is None:
        monkeypatch.delenv(var, raising=False)
    else:
        monkeypatch.setenv(var, env)
    assert validate({})[name] == jvalidate({})[name] == 0
    tr = port_trainer(validate(spec(**{name: key})))
    assert getattr(tr, name) is want


@pytest.mark.parametrize("env", ["0", "3"])
def test_grad_accum_validation_messages_match_jax(monkeypatch, env):
    """MUNIT_GRAD_ACCUM bypasses the config's validation: both trainers
    re-check it with the same message (not positive; batch 4 not divisible
    by 3). The JAX trainer raises before it builds anything."""
    monkeypatch.setenv("MUNIT_GRAD_ACCUM", env)
    raw = small_train_spec(batch_size=B)
    with pytest.raises(ValueError) as port:
        MUNITTrainer(validate(raw), "cpu")
    with pytest.raises(ValueError) as ref:
        JTrainer(jvalidate(raw), jax.random.PRNGKey(0))
    assert str(port.value) == str(ref.value)
    assert ("positive" if env == "0" else "divisible") in str(port.value)


@pytest.mark.parametrize("adaptation,domain_adv_w,k,warns", [
    ({"adv_lambda": 6}, 0, 2, True), ({"adv_lambda": 0}, 1, 2, True),
    ({"adv_lambda": 6}, 0, 1, False), ({"adv_lambda": 0}, 0, 2, False)])
def test_classifier_chunk_statistics_warning(adaptation, domain_adv_w, k,
                                             warns):
    """JAX's warning (trainer.py:322-331), word for word, at K > 1 with a
    train-mode batch-norm classifier term; none at K = 1 or without one."""
    conf = validate(small_train_spec(
        batch_size=B, grad_accum=k, domain_adv_w=domain_adv_w,
        adaptation={**adaptation, "dfeat_lambda": 1,
                    "classif_frequency": 2}))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        MUNITTrainer(conf, "cpu")
    texts = [str(w.message) for w in seen if w.category is UserWarning]
    if warns:
        assert len(texts) == 1 and texts[0].startswith(
            "grad_accum > 1 with a train-mode BatchNorm classifier loss")
        assert "chunk statistics" in texts[0] and "PARITY" in texts[0]
    else:
        assert not texts


# ------------------------------------------------------------- readings

def gen_grads(before, after, beta1):
    """A step's generator gradients (weight decay included) from Adam's
    first moment in two port states: (mu' - beta1 mu) / (1 - beta1)."""
    mu = before["opt"]["gen"]["mu"]
    return {k: (v.double().numpy() - beta1 * mu[k].double().numpy())
            / (1 - beta1) for k, v in after["opt"]["gen"]["mu"].items()}


def readings():
    """Per step of GUIDED_STEPS and of OTHER_ORDERS, from JAX's state
    before it: the generator's gradients of JAX's float32 and the port's
    float32 step against the port's float64 one (relative L2 per leaf,
    median and largest, the conv biases that a norm removes left out),
    the share of each net's weights whose update parts from JAX's (float32,
    float64, both), and the activation inputs whose sign differs between
    the port's float32 and float64 runs."""
    from tests.test_torch_semantic import _ReluInputs, _sign_flips
    seg, batch = seg_ref_weights(0), train_batch(5, B)
    jb = list(map(jnp.asarray, batch))
    tb = [torch.from_numpy(a) for a in batch]
    raw = spec(guided=1)
    beta1 = validate(raw)["beta1"]
    trainers = jax_trainers(raw, 1, seg, GUIDED_STEPS)
    start = jax.tree.map(np.array, next(iter(trainers.values())).state)
    lock = jax_steps(trainers, GUIDED_STEPS, start, jb)
    orders = {"lockstep": lock}
    for order, labels in OTHER_ORDERS:
        shared = next(i for i, (a, b) in enumerate(
            zip(labels, (s[0] for s in GUIDED_STEPS))) if a != b)
        orders[order] = lock[:shared] + jax_steps(
            trainers, [STEPS[x] for x in labels[shared:]],
            lock[shared - 1][5] if shared else start, jb)
    with _ReluInputs() as acts:     # the port binds activations when built
        for order, recs in orders.items():
            for rec in recs:
                label, kind, switches, _, before, after = rec
                out = {}
                for dtype in (torch.float32, torch.float64):
                    tr = port_trainer(validate(dict(raw, **switches)), seg)
                    tr.load_state_dict(port_state(before, 0))
                    if dtype == torch.float64:
                        to_float64(tr)
                    for name, net in tr._nets().items():
                        acts.watch(name, getattr(net, "module", net))
                    acts.calls, acts.modules = [], []
                    run_step(tr, kind, [t.to(dtype) for t in tb])
                    nets = {k: {n: v.float() for n, v in d.items()}
                            for k, d in tr.state_dict()["nets"].items()}
                    out[dtype] = (tr.state_dict(), net_groups(nets),
                                  acts.calls, acts.modules)
                pb, pa = port_state(before, 0), port_state(after, 0)
                gb, ga = net_groups(pb["nets"]), net_groups(pa["nets"])
                s32, n32, c32, m32 = out[torch.float32]
                s64, n64, c64, _ = out[torch.float64]
                row = {"order": order, "step": label, "update_share": {
                    "port32": {k: e["share"] for k, e in update_errors(
                        gb, ga, n32, LR, {}).items()},
                    "port64": {k: e["share"] for k, e in update_errors(
                        gb, ga, n64, LR, {}).items()},
                    "both": past_in_both(gb, ga, n32, n64, LR)}}
                if "gen" in UPDATED[kind]:
                    removed = {f"{n}.conv.bias" for n, m in
                               tr.gen.module.named_modules()
                               if isinstance(m, ConvBlock)
                               and m.norm_type in ("in", "adain")}
                    g64 = gen_grads(pb, s64, beta1)
                    for who, g in (("jax32", gen_grads(pb, pa, beta1)),
                                   ("port32", gen_grads(pb, s32, beta1))):
                        r = [np.linalg.norm(g[k] - w) / np.linalg.norm(w)
                             for k, w in g64.items() if k not in removed]
                        row[f"gen_grads_{who}_vs_port64"] = {
                            "median": float(np.median(r)),
                            "max": float(np.max(r))}
                row["port32_vs_port64_sign_flips"] = _sign_flips(
                    c32, c64, m32)
                yield row


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python -m tests.test_torch_grad_accum
    import json
    torch.set_num_threads(1)
    ops.set_conv_compute(None)
    for r in readings():
        print(json.dumps(r), flush=True)
