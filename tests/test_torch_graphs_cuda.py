"""The captured training steps on the card: each norm kernel design
captured and replayed, forward and backward, bit for bit against its eager
launch, and a small training cadence captured against eager.

Needs a CUDA card and nvcc; skips without a card. It imports no JAX:

    python -m pytest tests/test_torch_graphs_cuda.py --noconftest -q
"""

import pytest
import torch

from munit_tpu_torch.config import validate
from munit_tpu_torch.core import ops
from munit_tpu_torch.kernels import norms
from munit_tpu_torch.train import graphs
from munit_tpu_torch.train.trainer import MUNITTrainer, train_steps
# the card's machine may install a package named "tests": import the helpers
# from this directory, which pytest puts on the path
from torch_port_util import small_train_spec, train_batch

# (wrapper, shape, the design the plan picks there): the training path's
# shapes of each design at batch 2
DESIGN_CASES = [("instance_norm", (2, 64, 64, 256), "cluster"),
                ("adain", (2, 64, 64, 256), "cluster"),
                ("instance_norm", (2, 128, 128, 128), "grid"),
                ("whole_layer_norm", (2, 256, 256, 64), "grid")]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def norm_step(name, relu=True):
    """A norm's forward and its backward to x and the affine, as one body
    of ``StepGraphs.run``."""
    def body(x, g, b, dy):
        x = x.detach().requires_grad_(True)
        wrt = [x]
        if name == "instance_norm":
            y = norms.instance_norm(x, relu)
        else:
            g, b = (t.detach().requires_grad_(True) for t in (g, b))
            wrt += [g, b]
            y = getattr(norms, name)(x, g, b, relu)
        grads = torch.autograd.grad(y, wrt, dy)
        return {"y": y, **{f"d{i}": t for i, t in enumerate(grads)}}
    return body


def norm_inputs(name, shape, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    b, _, _, c = shape
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to("cuda", dtype)
    dy = torch.randn(shape, generator=gen).to("cuda", dtype)
    affine = (b, c) if name == "adain" else (c,)
    g, bt = (torch.randn(affine, generator=gen).cuda() for _ in range(2))
    return [x, g, bt, dy]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,design", DESIGN_CASES)
def test_each_norm_design_replays_its_eager_launch_bitwise(name, shape,
                                                           design, dtype):
    """Eager, then through StepGraphs: the first call (eager on a side
    stream), the capture and its replay, and a replay on other inputs, each
    bit for bit equal to the eager launch on the same inputs; each call
    counts one launch of the design each way."""
    _card()
    dt = getattr(torch, dtype)
    body = norm_step(name)
    runs = [norm_inputs(name, shape, dt, seed) for seed in (0, 0, 0, 1)]
    want = [body(*t) for t in runs]
    norms.reset_launches()
    steps = graphs.StepGraphs("cuda")
    got = [steps.run(("norm",), body, t) for t in runs]
    torch.cuda.synchronize()
    assert len(steps) == 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k
    assert not torch.equal(got[0]["y"], got[3]["y"])
    for way in (name, name + "_bwd"):
        assert norms.design_launches[way] == {
            d: 4 * (d == design) for d in norms.DESIGNS}, way
    norms.reset_launches()


def _state(tr):
    out = {}

    def walk(state, prefix):
        for k, v in state.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}/{k}")
            elif torch.is_tensor(v):
                out[f"{prefix}/{k}"] = v.detach().double().clone()
    walk(tr.state_dict(), "")
    return out


def _largest(a, b):
    return max((a[k] - b[k]).abs().max().item() for k in a)


@pytest.mark.cuda
def test_captured_cadence_matches_eager_on_card():
    """10 iterations at small width (ExtraAdam, the semantic term; a fused
    and a classifier_sr step every 2nd), parity numerics with cuDNN
    deterministic, captured against eager from one seeded state: the same
    launch counts, every loss and state leaf as close to the eager run as a
    second eager run is (bit for bit where two eager runs are: the reflect
    pads' backward adds with atomics)."""
    _card()
    conf = validate(small_train_spec(optimizer="extra_adam", semantic_w=3))
    ops.set_conv_compute(None)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        batch = [torch.from_numpy(a).cuda() for a in train_batch()]
        runs = {}
        for name, capture in (("eager", False), ("eager2", False),
                              ("captured", True)):
            tr = MUNITTrainer(conf, "cuda", _capture=capture)
            tr.init(torch.Generator().manual_seed(0))
            norms.reset_launches()
            metrics = train_steps(tr, *batch, range(10))
            torch.cuda.synchronize()
            runs[name] = (metrics, _state(tr), dict(norms.launches),
                          len(tr._graphs))
    finally:
        torch.backends.cudnn.deterministic = det
        norms.reset_launches()
    eager, eager2, captured = (runs[k] for k in ("eager", "eager2",
                                                 "captured"))
    assert captured[3] == 3 and eager[3] == 0
    assert captured[2] == eager[2]
    assert _largest(captured[1], eager[1]) <= 2 * _largest(eager2[1],
                                                            eager[1])

    def loss_diff(a, b):
        assert all(x.keys() == y.keys() for x, y in zip(a, b))
        return max(abs(float(x[k]) - float(y[k])) for x, y in zip(a, b)
                   for k in x)
    assert loss_diff(captured[0], eager[0]) <= 2 * loss_diff(eager2[0],
                                                             eager[0])


@pytest.mark.cuda
def test_profiler_sees_the_kernels_of_a_replay():
    """torch.profiler attributes device time to the norm kernels that a
    graph replays, by name, as the fused step's profile needs."""
    _card()
    from torch.profiler import ProfilerActivity, profile
    body = norm_step("adain")
    inputs = norm_inputs("adain", (2, 64, 64, 256), torch.float32)
    steps = graphs.StepGraphs("cuda")
    for _ in range(2):
        steps.run(("norm",), body, inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps.run(("norm",), body, inputs)
        torch.cuda.synchronize()
    seen = {ev.key: ev.count for ev in prof.key_averages()
            if getattr(ev, "self_device_time_total", 0) > 0}
    assert any("norm_cluster_fwd" in k for k in seen), seen
    assert any("norm_cluster_bwd" in k for k in seen), seen


# vanilla MUNIT at small width: two auto-encoders, random styles, VGG
VANILLA = dict(gen_state=0, guided=0, vgg_w=1)


def _vanilla_trainer(conf, capture):
    tr = MUNITTrainer(conf, "cuda", _capture=capture)
    tr.init(torch.Generator().manual_seed(0))
    tr.seed_styles(3)
    return tr


def _spy_draws(tr):
    calls, draw = [], tr.draw_style

    def spy(bsz, dtype):
        t = draw(bsz, dtype)
        calls.append(t.detach().clone())
        return t
    tr.draw_style = spy
    return calls


@pytest.mark.cuda
def test_guided0_replays_see_fresh_draws():
    """A guided: 0 fused step called three times on a captured trainer
    (eager, captured, replayed): each call's four draws differ from the
    last call's, and an eager trainer loaded with the same state before
    each call (its style stream too) draws the same styles bit for bit and
    takes the same losses before its updates (D's) bit for bit."""
    _card()
    conf = validate(small_train_spec(ratio_disc_gen=1, **VANILLA))
    ops.set_conv_compute(None)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        batch = [torch.from_numpy(a).cuda() for a in train_batch()]
        tr, ref = (_vanilla_trainer(conf, c) for c in (True, False))
        got, want = _spy_draws(tr), _spy_draws(ref)
        seen = []
        for _ in range(3):
            ref.load_state_dict(tr.state_dict())
            m = tr.dis_gen_update(*batch)
            w = ref.dis_gen_update(*batch)
            torch.cuda.synchronize()
            for k in ("loss_dis_a", "loss_dis_b", "loss_dis_total"):
                assert float(m[k]) == float(w[k]), k
            seen.append(torch.stack(got[-4:]))
            assert torch.equal(seen[-1], torch.stack(want[-4:]))
        assert len(tr._graphs) == 1
        assert not torch.equal(seen[1], seen[2])
        assert not torch.equal(seen[0], seen[1])
    finally:
        torch.backends.cudnn.deterministic = det


@pytest.mark.cuda
def test_guided0_captured_lockstep_with_eager():
    """5 iterations of the vanilla cadence at small width (a dis step, then
    a fused and a classifier_sr step, in turn), captured and eager in
    lockstep: before each iteration the captured trainer loads the eager
    one's state, style stream included; D's losses, which each step takes
    before its own updates, bit for bit (parity numerics, cuDNN
    deterministic), as chip_smoke.py's phase 8c holds config_256."""
    _card()
    conf = validate(small_train_spec(**VANILLA))
    ops.set_conv_compute(None)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        batch = [torch.from_numpy(a).cuda() for a in train_batch()]
        eager, captured = (_vanilla_trainer(conf, c) for c in (False, True))
        for it in range(5):
            captured.load_state_dict(eager.state_dict())
            w = train_steps(eager, *batch, [it])[0]
            g = train_steps(captured, *batch, [it])[0]
            torch.cuda.synchronize()
            keys = [k for k in w if k.startswith("loss_dis")]
            assert keys
            for k in keys:
                assert float(g[k]) == float(w[k]), (it, k)
        assert len(captured._graphs) > 0
    finally:
        torch.backends.cudnn.deterministic = det
