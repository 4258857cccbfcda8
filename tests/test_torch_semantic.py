"""The semantic loss of the port (munit_tpu_torch.losses, the trainer's
frozen-segmenter terms) against the JAX package's ``MUNITTrainer``.

``small_train_spec(semantic_w=3)``: small widths, 32 px, batch 2, masked
cycle loss, ``adv_lambda: 6``, the classifier step every 15th iteration as
in config_256 (none in these 3); both trainers load the same numpy-made
segmenter (``torch_port_util.seg_ref_weights``), the port from the JAX
trainer's seeded state.

- The cross-entropy losses and their logit gradients agree within 1e-5.
- The pseudo-labels (argmax of 19 logits) agree on at least 99.9 % of the
  pixels. A label that flips decides a pixel's whole CE term, so the
  gradient and trajectory checks give the port JAX's labels (they are a
  function of the real images only, the same at every step).
- One fused step's gradients agree leaf by leaf within 2e-4 of each leaf's
  largest |g|, as tests/test_torch_trainer.py holds them without the term.
- A 3-iteration trajectory's losses, ``loss_sem_seg`` included, agree
  within rtol 1e-4.
- ``full_adaptation: 1`` takes the unmasked CE, as JAX does (rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from munit_tpu.config import validate as jvalidate
from munit_tpu.losses import losses as jlosses
from munit_tpu.nn.resnet import convert_resnet34_8s_state_dict
from munit_tpu.train import MUNITTrainer as JTrainer
from munit_tpu_torch.config import validate
from munit_tpu_torch.io.weights import from_jax_dis, from_jax_params
from munit_tpu_torch.losses import losses
from munit_tpu_torch.train.trainer import MUNITTrainer, train_steps
from tests.torch_port_util import (jax_steps, load_jax_state,  # noqa: F401
                                   one_torch_thread, seg_ref_weights,
                                   small_train_spec, train_batch)

GRAD_TOL = 2e-4
ITERS = 3
ADAPTATION = {"adv_lambda": 6, "dfeat_lambda": 1, "classif_frequency": 15}


def _spec(**adaptation):
    return small_train_spec(semantic_w=3,
                            adaptation=dict(ADAPTATION, **adaptation))


def _port(state, seg, **adaptation):
    tr = MUNITTrainer(validate(_spec(**adaptation)), "cpu")
    load_jax_state(tr, state)
    tr.load_segmenter({k: torch.from_numpy(v) for k, v in seg.items()})
    return tr


def _share_targets(tr, targets):
    """Give a port trainer fixed pseudo-labels (JAX's)."""
    fixed = tuple(torch.from_numpy(np.asarray(t)).long() for t in targets)
    tr._semantic_targets = lambda x_a, x_b: fixed


@pytest.fixture(scope="module")
def runs():
    """One JAX trainer with the segmenter: its pseudo-labels, its fused
    step's gradients (initial state) and then a 3-iteration trajectory;
    two port trainers from the same initial state."""
    seg = seg_ref_weights(0)
    jtr = JTrainer(jvalidate(_spec()), jax.random.PRNGKey(0))
    jtr.load_segmenter(jax.tree.map(jnp.asarray,
                                    convert_resnet34_8s_state_dict(seg)))
    batch = train_batch(1)     # tests/test_torch_trainer.py's batch
    jbatch = list(map(jnp.asarray, batch))
    ports = [_port(jtr.state, seg) for _ in range(2)]
    targets = jtr._semantic_targets(jbatch[0], jbatch[1], None, None, False,
                                    jtr.frozen)
    grads_d, grads_g = jtr.dis_gen_grads(*jbatch)
    want = {f"{d}.{k}": v.numpy() for d in ("a", "b")
            for k, v in from_jax_dis(grads_d[d]).items()}
    want.update({k: v.numpy() for k, v in from_jax_params(grads_g).items()})
    traj = jax_steps(jtr, jbatch, ITERS)
    return dict(jtr=jtr, seg=seg, batch=batch, ports=ports,
                targets=[np.asarray(t) for t in targets], grads=want,
                traj=traj)


def test_cross_entropy_matches_jax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(2, 6, 5, 19) * 3).astype(np.float32)
    labels = rng.randint(0, 19, (2, 6, 5))
    jl = lambda z: jlosses.cross_entropy_loss(z, jnp.asarray(labels))  # noqa: E731
    want, want_g = jl(jnp.asarray(logits)), jax.grad(jl)(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    got = losses.cross_entropy_loss(z, torch.from_numpy(labels))
    got_g, = torch.autograd.grad(got, z)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-5)


def test_masked_semantic_loss_matches_jax():
    """Masked pixels relabelled to class 19, their logits zeroed and the
    mask appended as a 20th logit channel."""
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, 6, 5, 19) * 3).astype(np.float32)
    labels = rng.randint(0, 19, (2, 6, 5))
    mask = (rng.rand(2, 6, 5) > 0.6).astype(np.float32)
    jl = lambda z: jlosses.semantic_seg_loss_masked(  # noqa: E731
        z, jnp.asarray(labels), jnp.asarray(mask), 19)
    want, want_g = jl(jnp.asarray(logits)), jax.grad(jl)(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    got = losses.semantic_seg_loss_masked(z, torch.from_numpy(labels),
                                          torch.from_numpy(mask), 19)
    got_g, = torch.autograd.grad(got, z)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-5)
    assert np.abs(got_g.numpy()[mask > 0]).max() == 0


def test_pseudo_labels_agree_with_jax(runs):
    tr = runs["ports"][0]
    x_a, x_b = (torch.from_numpy(t) for t in runs["batch"][:2])
    got = tr._semantic_targets(x_a, x_b)
    for g, w in zip(got, runs["targets"]):
        assert g.shape == w.shape
        assert (g.numpy() == w).mean() >= 0.999


def test_dis_gen_grads_with_semantic_loss_match_jax(runs):
    tr = runs["ports"][0]
    _share_targets(tr, runs["targets"])
    grads_d, grads_g = tr.dis_gen_grads(*map(torch.from_numpy, runs["batch"]))
    got, want = {**grads_d, **grads_g}, runs["grads"]
    assert set(got) == set(want)
    net_scale = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        g, scale = got[k].numpy(), np.abs(w).max()
        if scale < 1e-6 * net_scale:   # conv biases a norm removes
            assert np.abs(g).max() < 1e-6 * net_scale, k
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=k)


def test_trajectory_losses_with_semantic_loss_match_jax(runs):
    tr = runs["ports"][1]
    _share_targets(tr, runs["targets"])
    got = train_steps(tr, *map(torch.from_numpy, runs["batch"]), range(ITERS))
    sem = float(got[1]["loss_sem_seg"])
    assert np.isfinite(sem) and sem > 0
    for it, (w, g) in enumerate(zip(runs["traj"], got)):
        for k, v in g.items():
            np.testing.assert_allclose(float(v), w[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"{k} it={it}")


def test_full_adaptation_takes_the_unmasked_loss(runs):
    """full_adaptation: 1 ignores the masks (trainer.py:760-763), as JAX
    does; 0 does not (its masked loss is held against JAX in the
    trajectory). One segmenter pass over [x_ab | x_ba] on both sides."""
    jtr, seg = runs["jtr"], runs["seg"]
    x_ab, x_ba, m_a, m_b = runs["batch"]
    t_a, t_b = runs["targets"]
    jtr.full_adaptation = True
    want = float(jtr._semantic_loss_pair(
        jnp.asarray(x_ab), jnp.asarray(t_a), jnp.asarray(m_a),
        jnp.asarray(x_ba), jnp.asarray(t_b), jnp.asarray(m_b), False,
        jtr.frozen))
    jtr.full_adaptation = False
    got = {}
    for fa in (0, 1):
        with torch.no_grad():
            got[fa] = float(_port(jtr.state, seg, full_adaptation=fa)
                            ._semantic_loss_pair(
                                *map(torch.from_numpy, (x_ab, x_ba)),
                                (torch.from_numpy(t_a), torch.from_numpy(t_b)),
                                *map(torch.from_numpy, (m_a, m_b))))
    np.testing.assert_allclose(got[1], want, rtol=1e-5)
    assert got[0] != got[1]


def test_ground_truth_targets_raise(runs):
    """Ground-truth targets (the synthetic-pair step's), refused until
    ROADMAP item 11 was ported, now run: the semantic loss takes the given
    labels against the 19 logits merged into 10 meta-classes, as JAX's
    ``has_sem_gt`` does (rtol 1e-5), masked and unmasked; and both update
    steps take them."""
    jtr, seg = runs["jtr"], runs["seg"]
    x_ab, x_ba, m_a, m_b = runs["batch"]
    rng = np.random.RandomState(3)
    gt_a, gt_b = (rng.randint(0, 10, x_ab.shape[:3]).astype(np.int32)
                  for _ in range(2))
    for fa in (0, 1):
        jtr.full_adaptation = bool(fa)
        want = float(jtr._semantic_loss_pair(
            *map(jnp.asarray, (x_ab, gt_a, m_a, x_ba, gt_b, m_b)), True,
            jtr.frozen))
        with torch.no_grad():
            got = float(_port(jtr.state, seg, full_adaptation=fa)
                        ._semantic_loss_pair(
                            *map(torch.from_numpy, (x_ab, x_ba)),
                            (torch.from_numpy(gt_a), torch.from_numpy(gt_b)),
                            *map(torch.from_numpy, (m_a, m_b)), has_gt=True))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"fa={fa}")
    jtr.full_adaptation = False
    tr = _port(jtr.state, seg)
    x_a, x_b, m_a, m_b = map(torch.from_numpy, runs["batch"])
    gt = torch.from_numpy(gt_a)
    for step in (tr.gen_update, tr.dis_gen_update):
        loss = step(x_a, x_b, m_a, m_b, sem_gt_a=gt, sem_gt_b=gt)[
            "loss_sem_seg"]
        assert torch.isfinite(loss) and loss > 0


def _worst_leaf(got, want):
    """(max over leaves of max |g - w| / max |w|, that leaf, leaves over
    GRAD_TOL); leaves whose gradient is ~0 (biases a norm removes) skipped."""
    net = max(float(np.abs(w).max()) for w in want.values())
    rows = sorted((float(np.abs(got[k] - w).max() / np.abs(w).max()), k)
                  for k, w in want.items() if np.abs(w).max() >= 1e-6 * net)
    return rows[-1][0], rows[-1][1], sum(e > GRAD_TOL for e, _ in rows)


class _ReluInputs:
    """Records the input of every F.relu and F.leaky_relu call while
    inside (the port's activations and the norms' fused ReLUs), so two runs
    of one net can be compared sign by sign, and the innermost module of a
    watched net (``watch``) that made each call."""

    def __init__(self):
        self.calls, self.modules, self._stack = [], [], []

    def watch(self, prefix, net):
        for name, m in net.named_modules():
            if not any(True for _ in m.children()):
                continue            # leaves (a Conv2d) call no activation
            m.register_forward_pre_hook(
                lambda m, a, n=f"{prefix}.{name}": self._stack.append(n))
            m.register_forward_hook(lambda m, a, o: self._stack.pop() and None)

    def __enter__(self):
        self._saved = F.relu, F.leaky_relu
        relu, lrelu = self._saved

        def rec(fn):
            def wrapped(x, *a, **k):
                self.calls.append(x.detach().double().clone())
                self.modules.append(self._stack[-1] if self._stack else "?")
                return fn(x, *a, **k)
            return wrapped
        F.relu, F.leaky_relu = rec(relu), rec(lrelu)
        return self

    def __exit__(self, *exc):
        F.relu, F.leaky_relu = self._saved


def _sign_flips(calls32, calls64, modules):
    """[{call, module, shape, flips, at}] of the activation inputs whose
    sign differs between two runs; ``at``: the largest |x| of the flipped
    elements in the float64 run over that input's largest |x|."""
    out = []
    for i, (a, b) in enumerate(zip(calls32, calls64)):
        d = (a > 0) != (b > 0)
        if d.any():
            out.append({"call": i, "module": modules[i],
                        "shape": list(a.shape), "flips": int(d.sum()),
                        "at": float(b[d].abs().max() / b.abs().max())})
    return out


class _JaxReluInputs:
    """Records, while inside, the input of every ReLU and LeakyReLU that
    the JAX package's blocks apply: the activations (``blocks._act``) and
    the pre-activations of the IN and AdaIN calls that fuse a ReLU, through
    ordered debug callbacks, so a jitted step reports them each time it
    runs. Its stem's packed IN (``ops.packed_instance_norm``) is not
    seen. A trainer must be built and traced inside."""

    def __init__(self):
        self.calls = []

    def _tap(self, x):
        jax.debug.callback(
            lambda v: self.calls.append(np.asarray(v, np.float64).copy()),
            x, ordered=True)

    def __enter__(self):
        from munit_tpu.kernels import norms as jnorms
        from munit_tpu.nn import blocks as jblocks
        self._saved = (jnorms, jnorms.maybe_instance_norm, jnorms.maybe_adain,
                       jblocks, jblocks._act)
        inorm, adain, act = self._saved[1], self._saved[2], self._saved[4]

        def maybe_instance_norm(x, relu=False):
            if relu:
                self._tap(inorm(x, False))
            return inorm(x, relu)

        def maybe_adain(x, g, b, relu=False):
            if relu:
                self._tap(adain(x, g, b, False))
            return adain(x, g, b, relu)

        def _act(module, name, x):
            if name in ("relu", "lrelu"):
                self._tap(x)
            return act(module, name, x)
        jnorms.maybe_instance_norm = maybe_instance_norm
        jnorms.maybe_adain = maybe_adain
        jblocks._act = _act
        return self

    def __exit__(self, *exc):
        jnorms, inorm, adain, jblocks, act = self._saved
        jnorms.maybe_instance_norm, jnorms.maybe_adain = inorm, adain
        jblocks._act = act


def _matched_flips(jcalls, calls32, calls64, modules):
    """Each port float64 activation input matched to the JAX call of its
    shape nearest to it (within 1e-4 of its largest |x|, each JAX call
    used once); the sign flips against float64 of the port's float32 and
    of JAX's float32 on the matched calls: (matched, port flips, JAX
    flips), each flip as ``_sign_flips`` gives it."""
    used, port, ref = set(), [], []
    for i, (a32, a64) in enumerate(zip(calls32, calls64)):
        a32, a64 = a32.numpy(), a64.numpy()
        near = [(np.abs(x - a64).max(), j) for j, x in enumerate(jcalls)
                if j not in used and x.shape == a64.shape]
        if not near or min(near)[0] > 1e-4 * np.abs(a64).max():
            continue
        j = min(near)[1]
        used.add(j)
        for out, x in ((port, a32), (ref, jcalls[j])):
            d = (x > 0) != (a64 > 0)
            if d.any():
                out.append({"call": i, "module": modules[i],
                            "shape": list(a64.shape), "flips": int(d.sum()),
                            "at": float(np.abs(a64[d]).max()
                                        / np.abs(a64).max())})
    return len(used), port, ref


def exact_convs():
    """Every float32 convolution of the port computed in float64 and
    rounded to float32 (the readings' ``--exact-conv``)."""
    from munit_tpu_torch.core import ops
    conv = ops.conv2d

    def conv2d(x, weight, bias=None, *args, **kw):
        if x.dtype != torch.float32:
            return conv(x, weight, bias, *args, **kw)
        return conv(x.double(), weight.double(),
                    None if bias is None else bias.double(), *args,
                    **kw).float()
    ops.conv2d = conv2d


def op_accuracy(seed=0):
    """Relative RMS error against float64 of each float32 op the
    pre-activations come from, JAX's and the port's, on seeded inputs at the
    small generator's shapes: the convs (XLA's against oneDNN's on the CPU)
    and the norms (JAX's one-pass statistics, E[x^2] - mean^2 with a clamp,
    against the port's two-pass ones)."""
    from munit_tpu.core import ops as jops
    from munit_tpu_torch.core import ops
    rng = np.random.RandomState(seed)

    def rms(a, ref):
        return float(np.sqrt(np.mean((np.asarray(a, np.float64) - ref) ** 2)
                             / np.mean(ref ** 2)))

    rows = []
    for h, cin, cout, k in ((38, 3, 16, 7), (18, 16, 32, 4), (10, 64, 64, 3),
                            (36, 32, 16, 5)):
        x = rng.randn(2, h, h, cin).astype(np.float32)
        w = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(
            np.float32)
        wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
        ref = ops.conv2d(torch.from_numpy(x).double(), wt.double()).numpy()
        rows.append({"op": f"conv {k}x{k} {cin}->{cout} at {h}px",
                     "jax": rms(jops.conv2d(jnp.asarray(x), jnp.asarray(w)),
                                ref),
                     "port": rms(ops.conv2d(torch.from_numpy(x), wt), ref)})
    for shape in ((2, 32, 32, 16), (2, 8, 8, 64)):
        x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
        g2 = (rng.rand(shape[0], shape[-1]) + 0.5).astype(np.float32)
        b2 = (rng.randn(shape[0], shape[-1]) * 0.5).astype(np.float32)
        g1 = rng.rand(shape[-1]).astype(np.float32)
        b1 = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
        for name, args in (("instance_norm", ()), ("adain", (g2, b2)),
                           ("whole_layer_norm", (g1, b1))):
            ref = getattr(ops, name)(torch.from_numpy(x).double(), *(
                torch.from_numpy(a).double() for a in args)).numpy()
            rows.append({
                "op": f"{name} {shape}",
                "jax": rms(getattr(jops, name)(jnp.asarray(x), *map(
                    jnp.asarray, args)), ref),
                "port": rms(getattr(ops, name)(torch.from_numpy(x), *map(
                    torch.from_numpy, args)), ref)})
    return rows


def grad_seed_readings(seeds, semantic_ws=(0, 3)):
    """One fused step's gradients per seeded batch (``train_batch(seed)``)
    and semantic weight, from one seeded state: JAX in float32 against the
    port in float32, and each of them against the port in float64 (JAX's
    pseudo-labels on every side), with the activation inputs whose sign
    differs between the port's float32 and float64 runs, and those of
    JAX's float32 run against the port's float64 one on the calls that
    match. A pre-activation within a few float32 ulps of 0 that float32
    rounding moves across the ReLU's kink changes the gradient by that
    element's whole term."""
    seg = seg_ref_weights(0)
    # the port binds activations when built, JAX's taps when traced
    with _ReluInputs() as acts, _JaxReluInputs() as jacts:
        for sw in semantic_ws:
            spec = small_train_spec(semantic_w=sw,
                                    adaptation=dict(ADAPTATION))
            jtr = JTrainer(jvalidate(spec), jax.random.PRNGKey(0))
            if sw:
                jtr.load_segmenter(jax.tree.map(
                    jnp.asarray, convert_resnet34_8s_state_dict(seg)))
            ports = {}
            for dtype in (torch.float32, torch.float64):
                tr = MUNITTrainer(validate(spec), "cpu")
                load_jax_state(tr, jtr.state)
                if sw:
                    tr.load_segmenter({k: torch.from_numpy(v)
                                       for k, v in seg.items()})
                for net in (tr.gen.module, tr.dis_a, tr.dis_b,
                            tr.classifier_sr_a, tr.classifier_sr_b,
                            tr.segmenter):
                    if net is not None:
                        net.to(dtype)
                if dtype == torch.float32:
                    for name in ("gen", "dis_a", "dis_b", "classifier_sr_a",
                                 "classifier_sr_b"):
                        net = getattr(tr, name)
                        acts.watch(name, getattr(net, "module", net))
                ports[dtype] = tr
            for seed in seeds:
                yield _seed_row(jtr, ports, acts, jacts, seed, sw)


def _seed_row(jtr, ports, acts, jacts, seed, sw):
    batch = train_batch(seed)
    jbatch = list(map(jnp.asarray, batch))
    if sw:
        targets = [np.asarray(t) for t in jtr._semantic_targets(
            jbatch[0], jbatch[1], None, None, False, jtr.frozen)]
        for tr in ports.values():
            _share_targets(tr, targets)
    jacts.calls = []
    gd, gg = jtr.dis_gen_grads(*jbatch)
    jax.effects_barrier()
    want = {f"{d}.{k}": v.numpy() for d in ("a", "b")
            for k, v in from_jax_dis(gd[d]).items()}
    want.update({k: v.numpy() for k, v in from_jax_params(gg).items()})
    got, calls, modules = {}, {}, {}
    for dtype, tr in ports.items():
        acts.calls, acts.modules = [], []
        rd, rg = tr.dis_gen_grads(*(torch.from_numpy(t).to(dtype)
                                    for t in batch))
        got[dtype] = {k: v.double().numpy() for k, v in {**rd, **rg}.items()}
        calls[dtype], modules[dtype] = acts.calls, acts.modules
    f32, f64 = got[torch.float32], got[torch.float64]
    row = {"seed": seed, "semantic_w": sw}
    for name, a, b in (("jax32_vs_port32", f32, want),
                       ("jax32_vs_port64", want, f64),
                       ("port32_vs_port64", f32, f64)):
        err, leaf, over = _worst_leaf(a, b)
        row[name] = {"max": err, "leaf": leaf, "leaves_over_tol": over}
    row["port32_vs_port64_sign_flips"] = _sign_flips(
        calls[torch.float32], calls[torch.float64], modules[torch.float32])
    matched, port, ref = _matched_flips(
        jacts.calls, calls[torch.float32], calls[torch.float64],
        modules[torch.float32])
    row["matched_calls"] = {"jax": len(jacts.calls), "port": len(
        calls[torch.float64]), "matched": matched}
    row["on_matched_calls"] = {"port32_vs_port64": port,
                               "jax32_vs_port64": ref}
    row["forward_drift"] = _forward_drift(jtr, ports, batch)
    return row


def _forward_drift(jtr, ports, batch):
    """The gen step's generator forward (every tensor that both packages
    return) of JAX and of the port in float32 against the port in
    float64: the largest relative L2 error over those tensors, each
    side."""
    fw = {}
    for dtype, tr in ports.items():
        with torch.no_grad():
            out = tr._gen_forward(*(torch.from_numpy(t).to(dtype)
                                    for t in batch[:2]))
        fw[dtype] = {k: v.double().numpy() for k, v in out.items()}
    ref = fw[torch.float64]
    jout = jtr._gen_forward(jtr.state["gen"], *map(jnp.asarray, batch[:2]),
                            None, None, True)

    def drift(got):
        return max(float(np.linalg.norm(np.asarray(got[k], np.float64) - v)
                         / np.linalg.norm(v))
                   for k, v in ref.items() if k in jout)
    return {"jax32": drift(jout), "port32": drift(fw[torch.float32])}


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python -m tests.test_torch_semantic
    #     [--exact-conv] [SEED ...]
    import json
    import sys
    torch.set_num_threads(1)
    args = sys.argv[1:]
    if "--exact-conv" in args:
        args.remove("--exact-conv")
        exact_convs()
    for r in op_accuracy():
        print(json.dumps(r), flush=True)
    for r in grad_seed_readings([int(s) for s in args] or range(8)):
        print(json.dumps(r), flush=True)
