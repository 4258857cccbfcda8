"""The captured training steps (munit_tpu_torch/train/graphs.py and the
trainer's split into host bookkeeping and a device body), on the CPU.

A CUDA graph runs only on a card; here a stand-in graph (``ReplayGraph``)
records the step's body at its capture and runs it again at each replay,
with what a capture leaves behind on a card: no device work (the trainer's
state is put back after the capture pass) and the body's output buffer
overwritten by each replay. Through it, a 10-iteration cadence on a small
trainer equals the eager steps bit for bit, the lr is read from its device
scalar, and the metrics returned are copies. The keys each iteration asks
for are read from a recording stand-in that runs no body. The launch-count
accounting is held with a fake launcher, and the ExtraAdam half-step with
tensor scalars against the JAX package's. Torch only, but for one small
JAX ExtraAdam run; no JAX trainer. The card's counterparts are in
tests/test_torch_graphs_cuda.py.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from munit_tpu.optim import extra_adam_update as jax_extra_adam_update
from munit_tpu.optim.extra_adam import ExtraAdamState as JaxExtraAdamState
from munit_tpu_torch.config import validate
from munit_tpu_torch.core import ops
from munit_tpu_torch.kernels import moments, norms
from munit_tpu_torch.optim.extra_adam import (ExtraAdamState,
                                              bias_correction,
                                              extra_adam_advance,
                                              extra_adam_apply)
from munit_tpu_torch.train import graphs
from munit_tpu_torch.train.trainer import (MUNITTrainer, cadence_steps,
                                           capture_warmup, step_variants,
                                           train_steps)
from tests.torch_port_util import (one_torch_thread,  # noqa: F401
                                   small_train_spec, train_batch)

# config_256's cadence at small widths: a fused step every 5th iteration,
# the classifier_sr step every 15th
BENCH_CADENCE = dict(optimizer="extra_adam", ratio_disc_gen=5,
                     adaptation={"adv_lambda": 6, "dfeat_lambda": 1,
                                 "classif_frequency": 15})
OPTS = {"dis": ("dis",), "dis_gen": ("dis", "gen"),
        "classifier_sr": ("classif_sr",)}


@pytest.fixture(autouse=True)
def parity_numerics():
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    ops.set_conv_compute(None)
    yield
    ops.set_conv_compute(None)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        flags


def _batch():
    return [torch.from_numpy(a) for a in train_batch()]


def _trainer(**over):
    tr = MUNITTrainer(validate(small_train_spec(**over)), "cpu")
    tr.init(torch.Generator().manual_seed(0))
    return tr


class Recording:
    """A StepGraphs stand-in that records the key of each step and runs no
    body: the host's bookkeeping alone."""

    def __init__(self):
        self.keys = []

    def run(self, key, body, tensors):
        self.keys.append(key)
        return {}


def _recording(tr):
    tr._capture, tr._graphs = True, Recording()
    return tr._graphs


def _expected_keys(conf, iterations, has_copy):
    """(kind, extrapolate, the updated optimizers' anchor flags) each step
    must ask for; ``has_copy`` is advanced as the optimizers would."""
    out = []
    for it in iterations:
        for kind, phase in cadence_steps(conf, it):
            assert phase == (it % 2 == 0)
            out.append((kind, phase, tuple(has_copy[o] for o in OPTS[kind])))
            for o in OPTS[kind]:
                has_copy[o] = phase
    return out


def test_keys_follow_the_cadence_and_its_resume():
    """30 iterations of bench.py's cadence from 0 ask for the key of their
    phase and anchor flags: 6 keys at one shape (dis, fused and
    classifier_sr in both phases), each with the flag that the other phase
    leaves. A resume at an odd iteration asks for the same keys as the
    uninterrupted run; other conv numerics or TF32 give other keys."""
    tr = _trainer(**BENCH_CADENCE)
    rec = _recording(tr)
    batch = _batch()
    train_steps(tr, *batch, range(11))
    saved = copy.deepcopy(tr.state_dict())
    train_steps(tr, *batch, range(11, 30))
    has_copy = {"dis": False, "gen": False, "classif_sr": False}
    want = _expected_keys(tr.conf, range(30), has_copy)
    got = [k[:3] for k in rec.keys]
    assert got == want
    assert len(set(rec.keys)) == 6
    assert all(hc == (not phase,) * len(hc) for _, phase, hc in got)
    assert {k[3] for k in rec.keys} == {graphs.signature(batch[:2]),
                                        graphs.signature(batch)}

    resumed = _trainer(**BENCH_CADENCE)
    resumed.load_state_dict(saved)
    rec2 = _recording(resumed)
    train_steps(resumed, *batch, range(11, 30))
    assert rec2.keys == rec.keys[-len(rec2.keys):]
    assert saved["opt"]["dis"]["has_copy"]       # saved mid-extrapolation

    first = rec.keys[0]
    resumed.iterations = 0
    for switch in (lambda: ops.set_conv_compute(torch.bfloat16),
                   lambda: setattr(torch.backends.cudnn, "allow_tf32", True),
                   lambda: setattr(torch.backends.cuda.matmul, "allow_tf32",
                                   True)):
        ops.set_conv_compute(None)
        switch()
        resumed.dis_opt.has_copy = False
        resumed.dis_update(*batch[:2])
        assert rec2.keys[-1][:4] == first[:4]
        assert rec2.keys[-1] != first
    ops.set_conv_compute(None)
    resumed.dis_opt.has_copy = False
    resumed.dis_update(*batch[:2])
    assert rec2.keys[-1] == first


class ReplayGraph:
    """A CUDA graph's stand-in on the CPU. ``capture(fn)`` runs fn once, as
    a capture runs the step's Python, then puts the trainer's state back:
    a capture does no device work. ``replay()`` runs fn again and writes
    its output into the buffer that the capture returned."""

    def __init__(self, trainer):
        self.trainer = trainer

    def capture(self, fn):
        saved = copy.deepcopy(self.trainer.state_dict())
        self.fn, self.out = fn, fn()
        self.trainer.load_state_dict(saved)
        return self.out

    def replay(self):
        self.out.copy_(self.fn())


def _through_graphs(tr):
    tr._capture = True
    tr._graphs = graphs.StepGraphs("cpu", make_graph=lambda: ReplayGraph(tr))
    return tr._graphs


def _leaves(tr):
    out = {}

    def walk(state, prefix):
        for k, v in state.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}/{k}")
            else:
                out[f"{prefix}/{k}"] = v.clone() if torch.is_tensor(v) else v
    walk(tr.state_dict(), "")
    return out


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if torch.is_tensor(w):
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
        else:
            assert got[k] == w, k


def test_device_body_path_equals_the_eager_steps_bitwise():
    """10 iterations (a fused and a classifier_sr step every 2nd, ExtraAdam)
    through the captured path (first call eager, second captured, then
    replays; lr and bias corrections written as tensors) equal the eager
    steps bit for bit, in every metric and every state leaf. The metrics
    are compared after the last iteration: each is a copy that no later
    replay overwrote."""
    eager = _trainer(optimizer="extra_adam")
    eager._capture = False
    captured = _trainer(optimizer="extra_adam")
    steps = _through_graphs(captured)
    batch = _batch()
    want = train_steps(eager, *batch, range(10))
    got = train_steps(captured, *batch, range(10))
    assert len(steps) == 3          # dis, fused, classifier_sr: one phase each
    for g, w in zip(got, want):
        _assert_same(g, w)
    _assert_same(_leaves(captured), _leaves(eager))


# configs/final_test's cadence at small widths, with ExtraAdam, the DANN,
# the output-level classifiers and the seg head: a real and a synthetic
# fused step every iteration, both classifier_sr steps every 2nd
SIM2REAL = dict(optimizer="extra_adam", ratio_disc_gen=1,
                synthetic_frequency=1, synthetic_seg_gt=1, recon_synth_w=1,
                domain_adv_w=1,
                adaptation={"adv_lambda": 6, "dfeat_lambda": 1,
                            "classif_frequency": 2,
                            "output_classifier_lambda": 1,
                            "output_adv_lambda": 1, "sem_seg_lambda": 1})


def _synth_batch():
    x_a, x_b, m_a, _ = _batch()
    x_b = x_a.clone()
    x_b[:, :8] = -x_b[:, :8]
    labels = torch.randint(0, 9, x_a.shape[:3],
                           generator=torch.Generator().manual_seed(2))
    return {"image_a": x_a, "image_b": x_b, "mask": m_a,
            "sem_a": labels, "sem_b": labels.flip(1)}


def _cadence_kind(key):
    """The cadence's name for the step a key belongs to."""
    kind, static = key[0], key[4]
    synth = ((kind == "dis_gen" and static[0])
             or (kind == "classifier_sr" and static[0]))
    return kind + "_synth" if synth else kind


def test_synthetic_cadence_keys_anchor_and_warmup():
    """On an even iteration of the sim→real cadence with ExtraAdam, the real
    fused step extrapolates with no anchor held and the synthetic one with
    the anchor the real one set: a key config_256's cadence never makes.
    The keys asked for are ``step_variants``' (the output-level classifier
    step never extrapolates); ``capture_warmup`` reaches every one of them
    twice. Eagerly, the second extrapolation keeps the first's anchor (the
    parameters before the iteration, JAX extra_adam.py:86-91)."""
    tr = _trainer(**SIM2REAL)
    rec = _recording(tr)
    batch, synth = _batch(), _synth_batch()
    warm = capture_warmup(tr.conf, synth=True)
    train_steps(tr, *batch, range(warm), synth)
    got = [(_cadence_kind(k), k[1], k[2]) for k in rec.keys]
    assert got == list(step_variants(tr.conf, range(warm), synth=True))
    assert ("dis_gen_synth", True, (True, True)) in got
    assert ("output_classifier_sr", True, (False,)) not in got
    seen = {}
    for key in rec.keys:
        seen[key] = seen.get(key, 0) + 1
    steady = set(rec.keys[len(rec.keys) // 2:])
    assert all(seen[k] >= 2 for k in steady)

    eager = _trainer(**SIM2REAL)
    before = {k: v.detach().clone() for k, v in eager.gen_params().items()}
    train_steps(eager, *batch, [0], synth)
    assert eager.gen_opt.has_copy and eager.gen_opt.count == 2
    for k, v in before.items():
        assert torch.equal(eager.gen_opt.params_copy[k], v), k


def test_synthetic_cadence_through_the_graphs_equals_eager_bitwise():
    """4 iterations of the sim→real cadence through the captured path
    equal the eager steps bit for bit, in every metric and state leaf."""
    eager = _trainer(**SIM2REAL)
    eager._capture = False
    captured = _trainer(**SIM2REAL)
    steps = _through_graphs(captured)
    batch, synth = _batch(), _synth_batch()
    want = train_steps(eager, *batch, range(4), synth)
    got = train_steps(captured, *batch, range(4), synth)
    assert len(steps) == len(set(step_variants(captured.conf, range(4),
                                               synth=True)))
    for g, w in zip(got, want):
        _assert_same(g, w)
    _assert_same(_leaves(captured), _leaves(eager))


# upstream MUNIT at small widths: two auto-encoders, random styles, the VGG
# loss, ExtraAdam, a fused step every iteration (ratio_disc_gen: 1, the
# package default) and a classifier_sr step every 2nd
VANILLA = dict(gen_state=0, guided=0, vgg_w=1, optimizer="extra_adam",
               ratio_disc_gen=1)


def test_vanilla_cadence_keys_warmup_and_draws_through_the_graphs():
    """With ratio_disc_gen: 1 every iteration is a fused step, its key
    following the ExtraAdam phase: the keys asked for are
    ``step_variants``', and ``capture_warmup`` reaches every one of the
    steady state's twice. Through the stand-in graphs (first call eager,
    second captured, replays), 6 iterations equal the eager steps bit for
    bit, metrics and state leaves, the style stream's state included: the
    random styles are drawn outside the step and reach it as inputs."""
    tr = _trainer(**VANILLA)
    rec = _recording(tr)
    warm = capture_warmup(tr.conf)
    train_steps(tr, *_batch(), range(warm))
    got = [(k[0], k[1], k[2]) for k in rec.keys]
    assert got == list(step_variants(tr.conf, range(warm)))
    assert [k for k, *_ in got if k != "classifier_sr"] == ["dis_gen"] * warm
    steady = set(rec.keys[len(rec.keys) // 2:])
    assert all(rec.keys.count(k) >= 2 for k in steady)

    eager = _trainer(**VANILLA)
    eager._capture = False
    captured = _trainer(**VANILLA)
    steps = _through_graphs(captured)
    batch = _batch()
    want = train_steps(eager, *batch, range(6))
    got = train_steps(captured, *batch, range(6))
    assert len(steps) == len(set(step_variants(captured.conf, range(6))))
    for g, w in zip(got, want):
        _assert_same(g, w)
    _assert_same(_leaves(captured), _leaves(eager))


# bench.py's cadence at batch 4 with gradient accumulation (K = 2): a
# fused and a classifier_sr step every 2nd iteration
ACCUM = dict(optimizer="extra_adam", ratio_disc_gen=2, batch_size=4,
             adaptation={"adv_lambda": 6, "dfeat_lambda": 1,
                         "classif_frequency": 2})


def _accum_trainer(**over):
    with pytest.warns(UserWarning, match="chunk statistics"):
        return _trainer(**{**ACCUM, "grad_accum": 2, **over})


def _batch4():
    return [torch.from_numpy(a) for a in train_batch(3, 4)]


def test_grad_accum_cadence_asks_for_the_keys_of_k1():
    """K and the two accumulation switches are fixed per trainer, so a
    K = 2 trainer's steps ask for the keys that the same cadence (bench.py's,
    at batch 4) asks for at K = 1, one graph each: 30 iterations, 6 keys
    (dis, fused and classifier_sr in both ExtraAdam phases), and
    ``capture_warmup`` the same."""
    cadence = dict(BENCH_CADENCE, batch_size=4)
    k1 = _trainer(**cadence)
    rec1 = _recording(k1)
    k2 = _accum_trainer(accum_shared_fwd=1, **cadence)
    rec2 = _recording(k2)
    batch = _batch4()
    for tr in (k1, k2):
        train_steps(tr, *batch, range(30))
    assert rec2.keys == rec1.keys and len(set(rec2.keys)) == 6
    assert capture_warmup(k2.conf) == capture_warmup(k1.conf)


@pytest.mark.parametrize("switches", [{}, {"accum_shared_fwd": 1},
                                      {"accum_chunk_dis": 1}],
                         ids=["exact", "shared_fwd", "chunk_dis"])
def test_grad_accum_steps_through_the_graphs_equal_eager_bitwise(switches):
    """6 iterations at K = 2 (each of the fused step's variants) through
    the captured path equal the eager steps bit for bit, in every metric
    and state leaf: the K chunks run inside the captured body."""
    eager = _accum_trainer(**switches)
    eager._capture = False
    captured = _accum_trainer(**switches)
    steps = _through_graphs(captured)
    batch = _batch4()
    want = train_steps(eager, *batch, range(6))
    got = train_steps(captured, *batch, range(6))
    assert len(steps) == len(set(step_variants(captured.conf, range(6))))
    for g, w in zip(got, want):
        _assert_same(g, w)
    _assert_same(_leaves(captured), _leaves(eager))


def test_the_replay_reads_the_lr_scalar():
    """After its capture, a replay with twice the lr (and nothing else
    changed: the same key, no new capture) moves the discriminators twice
    as far as the same step at the lr of the capture. The moves are
    differences of float32 parameters, so they carry half an ulp of each
    parameter."""
    runs = {}
    for name, scale in (("lr", 1.0), ("twice", 2.0)):
        # dis steps only: the extrapolation at 0 runs eagerly, 2 captures
        tr = _trainer(optimizer="extra_adam", ratio_disc_gen=100,
                      adaptation={"adv_lambda": 6, "dfeat_lambda": 1,
                                  "classif_frequency": 100})
        steps = _through_graphs(tr)
        train_steps(tr, *_batch(), range(4))
        before = {k: v.clone() for k, v in tr.dis_params().items()}
        n = len(steps)
        base = tr.lr_schedule
        tr.lr_schedule = lambda it: scale * base(it)
        train_steps(tr, *_batch(), [4])            # the dis step, replayed
        assert len(steps) == n
        runs[name] = {k: (v.double() - before[k].double(), before[k])
                      for k, v in tr.dis_params().items()}
    eps = torch.finfo(torch.float32).eps
    for k, (d, p) in runs["lr"].items():
        assert d.abs().max() > 0, k
        torch.testing.assert_close(runs["twice"][k][0], 2 * d, rtol=0,
                                   atol=2 * eps * p.abs().max().item())


class OutputGraph:
    """A stand-in graph whose capture runs the body's Python (launches
    counted, outputs made) and whose replay runs no Python: it writes the
    next output of ``values`` into the captured buffer, as a replay
    rewrites a graph's output on the device."""

    def __init__(self, values):
        self.values = values

    def capture(self, fn):
        self.out = fn()
        return self.out

    def replay(self):
        self.out.copy_(self.values.pop(0))


def fake_launcher(x):
    """What a step's wrappers count on the host: two AdaIN forward launches
    on the cluster design, one grid backward, a dy copy and a moments
    launch."""
    norms.launches["adain"] += 2
    norms.design_launches["adain"]["cluster"] += 2
    norms.launches["whole_layer_norm_bwd"] += 1
    norms.design_launches["whole_layer_norm_bwd"]["grid"] += 1
    norms.bf16_launches["adain"] += 2
    norms.dy_copies["adain"] += 1
    moments.launches["sample_sums"] += 1
    return {"loss": x.sum(), "y": x * 2}


def _counts():
    return [dict(d) for d in (*norms.counter_dicts(),
                              *moments.counter_dicts())]


def test_replays_add_the_launches_that_the_capture_counted():
    """Five calls of one key (eager, capture and replay, three replays)
    count what five eager calls count: the capture pass's own counts are
    put back, and each replay adds them."""
    x = torch.arange(6.0).reshape(2, 3)
    norms.reset_launches()
    moments.reset_launches()
    for _ in range(5):
        fake_launcher(x)
    want = _counts()
    norms.reset_launches()
    moments.reset_launches()
    steps = graphs.StepGraphs("cpu", make_graph=lambda: OutputGraph(
        [torch.zeros(1) for _ in range(4)]))
    for i in range(5):
        steps.run(("k",), lambda t: {"loss": fake_launcher(t)["loss"]}, [x])
        assert norms.launches["adain"] == 2 * (i + 1)
    assert _counts() == want
    assert moments.launches["sample_sums"] == 5
    norms.reset_launches()
    moments.reset_launches()


class FailingGraph:
    """A capture that fails once the step's Python has run (as a capture
    does at a call the stream cannot record)."""

    def capture(self, fn):
        fn()
        raise RuntimeError("operation not permitted when stream is capturing")


def test_a_failed_capture_raises_and_keeps_no_graph():
    """The second call's capture fails: the call raises, the counts are put
    back, and the next call tries the capture again: nothing runs the step
    eagerly in its place."""
    x = torch.arange(6.0).reshape(2, 3)
    norms.reset_launches()
    steps = graphs.StepGraphs("cpu", make_graph=FailingGraph)

    def body(t):
        return {"loss": fake_launcher(t)["loss"]}
    steps.run(("k",), body, [x])
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            steps.run(("k",), body, [x])
        assert len(steps) == 0 and norms.launches["adain"] == 2
    norms.reset_launches()
    moments.reset_launches()


def test_captured_outputs_are_copies():
    """Each call's outputs keep their values after later replays rewrite
    the graph's buffer, with their names, shapes and types."""
    x = torch.arange(6.0).reshape(2, 3)
    body_out = {"loss": x.sum(), "y": (x * 2).to(torch.bfloat16)}
    later = [{"loss": (x + i).sum(), "y": ((x + i) * 2).to(torch.bfloat16)}
             for i in range(1, 4)]
    flat = [torch.cat([v.reshape(-1).float() for v in m.values()])
            for m in later]
    steps = graphs.StepGraphs("cpu", make_graph=lambda: OutputGraph(flat))
    outs = [steps.run(("k",), lambda t: dict(body_out), [x])
            for _ in range(4)]
    assert len(steps) == 1
    for o, want in zip(outs, [body_out, *later]):
        assert o.keys() == want.keys()
        for k, w in want.items():
            assert o[k].dtype == w.dtype and o[k].shape == w.shape
            assert torch.equal(o[k], w), k


def test_extra_adam_with_device_scalars_matches_jax():
    """The half-step with lr and bias correction as 0-dim tensors against
    the JAX package's ExtraAdam over step, extrapolate, step, extrapolate,
    from a state that holds an anchor (has_copy True, count 3), with L2
    weight decay."""
    rng = np.random.RandomState(3)
    shapes = {"w": (3, 4), "b": (4,)}
    start = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    state = {f: {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for f in ("mu", "nu", "params_copy")}
    state["nu"] = {k: np.abs(v) for k, v in state["nu"].items()}
    grads = [{k: rng.randn(*s).astype(np.float32) * 10 ** -i
              for k, s in shapes.items()} for i in range(4)]
    kw = dict(b1=0.5, b2=0.999, eps=1e-8, weight_decay=1e-4)
    lr = 2e-3

    tp = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    ts = ExtraAdamState(3, *({k: torch.from_numpy(v.copy()) for k, v in
                              state[f].items()}
                             for f in ("mu", "nu", "params_copy")), True)
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    js = JaxExtraAdamState(jnp.asarray(3, jnp.int32),
                           *({k: jnp.asarray(v) for k, v in state[f].items()}
                             for f in ("mu", "nu", "params_copy")),
                           jnp.asarray(True))
    lr_t = torch.tensor(lr)
    for i, g in enumerate(grads):
        extrapolate = i % 2 == 1
        corr = torch.tensor(bias_correction(ts.count + 1, kw["b1"], kw["b2"]))
        extra_adam_apply({k: torch.from_numpy(v) for k, v in g.items()}, ts,
                         tp, lr_t, corr, extrapolate, **kw)
        extra_adam_advance(ts, extrapolate)
        jp, js = jax_extra_adam_update(
            {k: jnp.asarray(v) for k, v in g.items()}, js, jp, lr,
            extrapolate, **kw)
        assert ts.count == int(js.count) and ts.has_copy == bool(js.has_copy)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(ts.params_copy[k].numpy(),
                                       np.asarray(js.params_copy[k]),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]),
                                       rtol=1e-5, atol=1e-9)
