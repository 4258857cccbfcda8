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
