"""The port's sim→real training path against the JAX package's, on one
JAX ``MUNITTrainer`` with every term of ROADMAP item 11 on: the frozen
segmenter (``semantic_w: 4``, the numpy-made weights of
``torch_port_util.seg_ref_weights``) with ground-truth targets on the
synthetic pairs (``synthetic_seg_gt: 1``), the synthetic-pair loss
(``recon_synth_w: 1``), the DANN (``domain_adv_w: 1``), the feature-level
classifiers (``adv_lambda: 6``, ``dfeat_lambda: 1``), the output-level
ones (``output_classifier_lambda: 1``, ``output_adv_lambda: 1``) and the
seg head (``sem_seg_lambda: 1``); small widths, 32 px, batch 2, a fused
step every iteration and a synthetic one too (``configs/final_test``'s
cadence), Adam. The port starts from the JAX trainer's seeded state,
carried over by ``io/weights.py``.

- The seg head's forward and its running statistics after an a then b
  pass: rtol 1e-4, atol 1e-5.
- ``synthetic_transform`` and the synthetic loader's batches: bitwise
  (numpy and PIL only).
- 3 fixed-batch iterations of the cadence: the real fused step, the DANN
  step, the output classifier step, the synthetic fused step with ground
  truth, both classifier_sr steps (iteration 1) and the seg-head step, the
  port in lockstep (each step from the JAX state before it, optimizer
  states included), with Adam; then iterations 0-1 again with ExtraAdam on
  the same JAX trainer (iteration 0 extrapolates, and its synthetic fused
  step keeps the real one's anchor). Every loss of every step within rtol
  1e-4 (float32 sums in another order). Each step's update, not the state
  after it, is held (``update_errors``): per net, the weights whose update
  differs from JAX's by more than 1e-2 lr (plus the float32 rounding of
  the stored weight) are at most 1 % of the net (``UPDATE_RTOL`` says
  why), no weight by more than 2 lr; each updated net moved by a median of
  at least lr/10 (an ExtraAdam update step moves from the extrapolated
  point, by the difference of two updates); every other net did not move
  at all. Running statistics within rtol 1e-4; with ExtraAdam each
  optimizer's count, anchor flag and anchor exactly as JAX's.
- Both loops over 4 iterations reading the same seeded A, B and synthetic
  lists, free-running at lr 1e-6 (``LOOP_LR`` says why): the same losses
  at every step, and the updates of the 4 iterations held as the steps'
  are, per update of their net.
- A whole-state checkpoint with the new nets resumes bitwise (port only).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from munit_tpu.cli.train import build_loaders as jax_build_loaders
from munit_tpu.config import validate as jvalidate
from munit_tpu.data import transforms as jT
from munit_tpu.nn.resnet import (SegmentationHead as JaxSegHead,
                                 convert_resnet34_8s_state_dict)
from munit_tpu.optim.schedule import from_config as jax_schedule
from munit_tpu.train import MUNITTrainer as JTrainer
from munit_tpu.train.loop import train_loop as jax_train_loop
from munit_tpu_torch.cli import train as cli_train
from munit_tpu_torch.config import validate
from munit_tpu_torch.data import transforms as T
from munit_tpu_torch.io import checkpoint
from munit_tpu_torch.io.weights import (from_jax_classifier, from_jax_dis,
                                        from_jax_params, from_jax_seg_head)
from munit_tpu_torch.nn.resnet import SegmentationHead
from munit_tpu_torch.train.loop import train_loop
from munit_tpu_torch.train.trainer import (MUNITTrainer, cadence_step,
                                           cadence_steps, train_steps)
from tests.torch_port_util import (CROP, check_update,  # noqa: F401
                                   one_torch_thread, seg_ref_weights,
                                   small_train_spec, train_batch,
                                   update_errors)

ITERS, LOOP_ITERS = 3, 4
LR = 1e-4
# Adam's first half-step moves every weight by lr whatever its gradient's
# size, so a weight whose gradient is rounding noise moves by ±lr at
# random: after the first generator update the two packages' generators
# differ by 2 lr in ~0.2 % of their weights, and their losses by up to
# 4e-4 relative at lr 1e-4 (3e-3 after 4 free-running iterations). The
# steps therefore run in lockstep at the configs' lr; the free-running
# loops run at 1e-6, where that drift stays below the 1e-4 the losses are
# held to.
LOOP_LR = 1e-6
SEM_VALUES = (0, 29, 55, 76, 133, 149, 178, 200, 255)
ADAPTATION = {"adv_lambda": 6, "dfeat_lambda": 1, "classif_frequency": 2,
              "output_classifier_lambda": 1, "output_adv_lambda": 1,
              "sem_seg_lambda": 1}
# updates of each net in the loop's 4 iterations: a real and a synthetic
# fused step an iteration, both classifier_sr steps on iterations 1 and 3
UPDATES = {"gen": 8, "dis": 8, "classifier": 4, "dann": 4,
           "output_classifier": 4, "seg_head": 4}


def _spec(**over):
    return small_train_spec(
        semantic_w=4, recon_synth_w=1, domain_adv_w=1, synthetic_frequency=1,
        synthetic_seg_gt=1, ratio_disc_gen=1, adaptation=dict(ADAPTATION),
        **over)


# ------------------------------------------------------------------ data

def _pair(rng, h, w):
    """A seeded image and its twin equal to it outside a band of rows."""
    a = rng.randint(0, 256, (h, w, 3), np.uint8)
    b = a.copy()
    b[h // 3:h // 2] = rng.randint(0, 256, (h // 2 - h // 3, w, 3), np.uint8)
    return a, b


def _semantic(rng, h, w):
    return np.asarray(SEM_VALUES, np.uint8)[rng.randint(0, 9, (h, w))]


def _write_lists(root, name, paths):
    (root / f"{name}.txt").write_text("\n".join(map(str, paths)) + "\n")
    return str(root / f"{name}.txt")


def write_data(root):
    """4 seeded JPEGs and PNG masks per domain, and 4 synthetic PNG pairs
    with masks and semantic maps in the reference's gray values (two
    aspect ratios); returns the config's data keys."""
    rng = np.random.RandomState(0)
    keys = {}
    for dom in ("a", "b"):
        imgs, masks = [], []
        for i in range(4):
            h, w = (40, 46) if i % 2 else (44, 36)
            p, m = root / f"{dom}{i}.jpg", root / f"{dom}{i}_mask.png"
            Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(p)
            Image.fromarray(((rng.rand(h, w) > 0.6) * 255).astype(
                np.uint8)).save(m)
            imgs.append(p)
            masks.append(m)
        keys.update({f"data_list_train_{dom}": _write_lists(root, dom, imgs),
                     f"data_list_test_{dom}": str(root / f"{dom}.txt"),
                     f"data_folder_train_{dom}": "/",
                     f"data_folder_test_{dom}": "/",
                     f"data_list_train_{dom}_seg":
                         _write_lists(root, f"{dom}_seg", masks)})
    synth = {k: [] for k in ("a", "b", "mask", "sem_a", "sem_b")}
    for i in range(4):
        h, w = (42, 38) if i % 2 else (36, 48)
        a, b = _pair(rng, h, w)
        arrays = {"a": a, "b": b,
                  "mask": ((rng.rand(h, w) > 0.5) * 255).astype(np.uint8),
                  "sem_a": _semantic(rng, h, w), "sem_b": _semantic(rng, h, w)}
        for k, arr in arrays.items():
            path = root / f"s{i}_{k}.png"
            Image.fromarray(arr).save(path)
            synth[k].append(path)
    keys.update({
        "data_list_train_a_synth": _write_lists(root, "sa", synth["a"]),
        "data_list_train_b_synth": _write_lists(root, "sb", synth["b"]),
        "data_list_train_b_seg_synth": _write_lists(root, "sm", synth["mask"]),
        "seg_list_a": _write_lists(root, "ssa", synth["sem_a"]),
        "seg_list_b": _write_lists(root, "ssb", synth["sem_b"])})
    return keys


def synth_batch(seed=5, b=2):
    """{image_a, image_b, mask, sem_a, sem_b} as numpy: a pair equal
    outside a band, a 50 % mask, class ids 0-8."""
    rng = np.random.RandomState(seed)
    x_a = rng.uniform(-1, 1, (b, CROP, CROP, 3)).astype(np.float32)
    x_b = x_a.copy()
    x_b[:, 8:16] = rng.uniform(-1, 1, (b, 8, CROP, 3))
    return {"image_a": x_a, "image_b": x_b,
            "mask": (rng.rand(b, CROP, CROP, 1) > 0.5).astype(np.float32),
            "sem_a": rng.randint(0, 9, (b, CROP, CROP)).astype(np.int32),
            "sem_b": rng.randint(0, 9, (b, CROP, CROP)).astype(np.int32)}


# ------------------------------------------------------------- the state

def _pair_of(convert, tree):
    return {f"{d}.{k}": v for d in ("a", "b")
            for k, v in convert(tree[d]).items()}


# each port optimizer: the converter of its trees (the JAX state's
# ``<name>_opt``)
OPT_TREES = {
    "gen": from_jax_params, "dis": lambda t: _pair_of(from_jax_dis, t),
    "classif_sr": lambda t: _pair_of(from_jax_classifier, t),
    "dann": from_jax_classifier,
    "output_classif_sr": lambda t: _pair_of(from_jax_dis, t),
    "seg": from_jax_seg_head}


def port_state(state, iterations):
    """A JAX trainer's whole state (numpy) as a port ``state_dict()``:
    every net with its statistics, every ExtraAdam state."""
    nets = {"gen": from_jax_params(state["gen"]),
            "dann": from_jax_classifier(state["dann"], state["dann_stats"]),
            "seg_head": from_jax_seg_head(state["seg_head"],
                                          state["seg_head_stats"])}
    for d in ("a", "b"):
        nets[f"dis_{d}"] = from_jax_dis(state[f"dis_{d}"])
        nets[f"classifier_sr_{d}"] = from_jax_classifier(
            state[f"classifier_sr_{d}"], state[f"classifier_sr_{d}_stats"])
        nets[f"output_classifier_sr_{d}"] = from_jax_dis(
            state[f"output_classifier_sr_{d}"])
    opt = {}
    for name, convert in OPT_TREES.items():
        o = state[f"{name}_opt"]
        opt[name] = {"count": int(o.count), "has_copy": bool(o.has_copy),
                     **{f: convert(getattr(o, f))
                        for f in ("mu", "nu", "params_copy")}}
    return {"iterations": iterations, "nets": nets, "opt": opt}


def load_jax_sim2real(tr, state, seg, iterations=0):
    """The JAX state (numpy) and the segmenter into a port trainer."""
    tr.load_state_dict(port_state(state, iterations))
    tr.load_segmenter({k: torch.from_numpy(v) for k, v in seg.items()})


def net_groups(nets):
    """A port ``state_dict()["nets"]`` as numpy copies, per net of
    ``UPDATES``: the a and b halves of a pair under one name."""
    out = {"gen": nets["gen"], "dann": nets["dann"],
           "seg_head": nets["seg_head"]}
    for net, name in (("dis", "dis"), ("classifier", "classifier_sr"),
                      ("output_classifier", "output_classifier_sr")):
        out[net] = {f"{d}.{k}": v for d in ("a", "b")
                    for k, v in nets[f"{name}_{d}"].items()}
    return {n: {k: v.detach().numpy().copy() for k, v in d.items()}
            for n, d in out.items()}


def jax_step(jtr, conf, kind, batch, bs):
    """One step of the JAX loop's iteration (munit_tpu/train/loop.py:
    183-227, fused) on fixed batches; its metrics as floats."""
    ad = conf["adaptation"]
    x_a, x_b, m_a, m_b = batch
    steps = {
        "dis_gen": lambda: jtr.dis_gen_update(x_a, x_b, m_a, m_b),
        "dann": lambda: jtr.domain_classifier_update(x_a, x_b),
        "classifier_sr": lambda: jtr.domain_classifier_sr_update(
            x_a, x_b, domain_synth=False, lamb=ad["dfeat_lambda"]),
        "output_classifier_sr": lambda: jtr.output_domain_classifier_sr_update(
            x_a, bs["image_a"], x_b, bs["image_b"]),
        "dis_gen_synth": lambda: jtr.dis_gen_update(
            bs["image_a"], bs["image_b"], bs["mask"], bs["mask"], synth=True,
            sem_gt_a=bs["sem_a"], sem_gt_b=bs["sem_b"]),
        "classifier_sr_synth": lambda: jtr.domain_classifier_sr_update(
            bs["image_a"], bs["image_b"], domain_synth=True,
            lamb=ad["dfeat_lambda"]),
        "seg_head": lambda: jtr.segmentation_head_update(
            bs["image_a"], bs["image_b"], bs["sem_a"], bs["sem_b"])}
    return {n: float(v) for n, v in steps[kind]().items()}


# the nets each step kind updates; every other net must not move
UPDATED = {"dis_gen": ("gen", "dis"), "dis_gen_synth": ("gen", "dis"),
           "dann": ("dann",), "classifier_sr": ("classifier",),
           "classifier_sr_synth": ("classifier",),
           "output_classifier_sr": ("output_classifier",),
           "seg_head": ("seg_head",)}
def lockstep(jtr, jconf, conf, iterations, seg, batches):
    """The cadence's steps over ``iterations`` on fixed batches, the port
    in lockstep: each step from the JAX state before it. Per step (kind,
    JAX's metrics, the port's, ``update_errors``, the optimizers' (count,
    has_copy, params_copy) of JAX and of the port)."""
    jb, jbs, tb, tbs = batches
    tr = MUNITTrainer(conf, "cpu")
    tr.load_segmenter({k: torch.from_numpy(v) for k, v in seg.items()})
    before = port_state(jax.tree.map(np.asarray, jtr.state), 0)
    steps = []
    for it in iterations:
        for kind, _ in cadence_steps(conf, it, synth=True):
            jtr.iterations = it
            want = jax_step(jtr, jconf, kind, jb, jbs)
            tr.load_state_dict(dict(before, iterations=it))
            got = {n: float(v) for n, v in cadence_step(
                tr, conf, kind, *tb, tbs).items()}
            after = port_state(jax.tree.map(np.asarray, jtr.state), it)
            errs = update_errors(net_groups(before["nets"]),
                                 net_groups(after["nets"]),
                                 net_groups(tr.state_dict()["nets"]), LR, {})
            steps.append((kind, want, got, errs,
                          (anchors(after["opt"]),
                           anchors(tr.state_dict()["opt"]))))
            before = after
    return steps


def anchors(opt):
    return {name: (o["count"], o["has_copy"],
                   {k: v.detach().numpy().copy()
                    for k, v in o["params_copy"].items()})
            for name, o in opt.items()}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_data(tmp_path_factory.mktemp("data"))


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """One JAX trainer with the segmenter. The steps: 3 iterations of the
    cadence on fixed batches from its seeded state, the port in lockstep
    (each step from the JAX state before it), then iterations 0-1 from
    that state with ExtraAdam. Then both loops from that state,
    free-running, at lr 1e-6."""
    seg = seg_ref_weights(0)
    loop_keys = dict(num_workers=2, log_iter=1, max_iter=LOOP_ITERS,
                     snapshot_save_iter=1000, image_save_iter=1000,
                     image_display_iter=1000)
    spec = dict(_spec(**data), **loop_keys)
    jconf, conf = jvalidate(spec), validate(spec)
    jtr = JTrainer(jconf, jax.random.PRNGKey(0))
    jtr.load_segmenter(jax.tree.map(jnp.asarray,
                                    convert_resnet34_8s_state_dict(seg)))
    init = jax.tree.map(np.asarray, jtr.state)   # the steps donate it
    batch, bs = train_batch(3), synth_batch()
    jb, jbs = list(map(jnp.asarray, batch)), {k: jnp.asarray(v)
                                              for k, v in bs.items()}
    tb = [torch.from_numpy(a) for a in batch]
    tbs = {k: torch.from_numpy(v) for k, v in bs.items()}
    batches = (jb, jbs, tb, tbs)
    out = {"steps": lockstep(jtr, jconf, conf, range(ITERS), seg, batches)}

    # iterations 0-1 again with ExtraAdam, on the same JAX trainer
    jtr.state, jtr.use_extra = jax.tree.map(jnp.asarray, init), True
    out["extra_adam"] = lockstep(
        jtr, jconf, validate(dict(spec, optimizer="extra_adam")), range(2),
        seg, batches)
    jtr.use_extra = False

    # the same JAX trainer (its compiled steps) at the loop's lr
    jconf, conf = (fn(dict(spec, lr=LOOP_LR)) for fn in (jvalidate, validate))
    jtr.lr_schedule = jax_schedule(jconf)
    jtr.state, jtr.iterations = jax.tree.map(jnp.asarray, init), 0
    jpath = str(tmp_path_factory.mktemp("jax_run"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MUNIT_LOADER_UINT8", "0")
        jax_train_loop(jtr, jconf, jax_build_loaders(jconf, seed=4), jpath)
    tr = MUNITTrainer(conf, "cpu")
    load_jax_sim2real(tr, init, seg)
    path = str(tmp_path_factory.mktemp("port_run"))
    loaders = cli_train.build_loaders(conf, seed=4)
    assert sorted(loaders) == ["a", "b", "synth"]
    assert train_loop(tr, conf, loaders, path, device="cpu") == LOOP_ITERS
    out["loop"] = (_losses(jpath), _losses(path), update_errors(
        net_groups(port_state(init, 0)["nets"]),
        net_groups(port_state(jax.tree.map(np.asarray, jtr.state),
                              LOOP_ITERS)["nets"]),
        net_groups(tr.state_dict()["nets"]), LOOP_LR, UPDATES))
    return out


def _losses(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return {m["step"]: {k: v for k, v in m.items() if k != "step"}
            for m in lines if "loss_dis_total" in m}


# ------------------------------------------------------------------ tests

def test_seg_head_and_its_statistics_match_jax():
    """One head, a then b in train mode: each output against JAX's, and
    the running statistics after the b pass, which starts from what the a
    pass wrote."""
    rng = np.random.RandomState(2)
    c_a, c_b = (rng.randn(2, 8, 8, 16).astype(np.float32) for _ in range(2))
    jhead = JaxSegHead(num_classes=10)
    v = jhead.init(jax.random.PRNGKey(3), jnp.asarray(c_a))
    head = SegmentationHead(16, 10)
    head.load_state_dict(from_jax_seg_head(v["params"], v["batch_stats"]))
    stats = v["batch_stats"]
    for c in (c_a, c_b):
        want, upd = jhead.apply({"params": v["params"], "batch_stats": stats},
                                jnp.asarray(c), mutable=["batch_stats"])
        stats = upd["batch_stats"]
        with torch.no_grad():
            got = head(torch.from_numpy(c), update_stats=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    want_sd = from_jax_seg_head(v["params"], stats)
    assert set(want_sd) == set(head.state_dict())
    for k, w in want_sd.items():
        np.testing.assert_allclose(head.state_dict()[k].numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_synthetic_transform_and_loader_match_jax_bitwise(data):
    """The transform on seeded PIL images for several draws, and the
    loaders' first batches: every array equal, types too."""
    paths = {k: open(data[key]).read().split() for k, key in (
        ("a", "data_list_train_a_synth"), ("b", "data_list_train_b_synth"),
        ("mask", "data_list_train_b_seg_synth"), ("sem_a", "seg_list_a"),
        ("sem_b", "seg_list_b"))}
    for i in range(4):
        imgs = [Image.open(paths["a"][i]).convert("RGB"),
                Image.open(paths["b"][i]).convert("RGB")] + [
            Image.open(paths[k][i]).convert("L")
            for k in ("mask", "sem_a", "sem_b")]
        for seed in range(3):
            got = T.synthetic_transform(np.random.default_rng(seed), *imgs,
                                        32, 32, 32)
            want = jT.synthetic_transform(np.random.default_rng(seed), *imgs,
                                          32, 32, 32)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
    conf = validate(_spec(**data, num_workers=2))
    jloader = jax_build_loaders(jvalidate(_spec(**data, num_workers=2)),
                                seed=4)["synth"]
    loader = cli_train.build_loaders(conf, seed=4)["synth"]
    for got, want in zip(loader.iter_from(1), jloader.iter_from(1)):
        assert sorted(got) == sorted(want) == [
            "image_a", "image_b", "mask", "sem_a", "sem_b"]
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        break


STEP_KINDS = ["dis_gen", "dann", "output_classifier_sr", "dis_gen_synth",
              "seg_head", "dis_gen", "dann", "classifier_sr",
              "output_classifier_sr", "dis_gen_synth", "classifier_sr_synth",
              "seg_head", "dis_gen", "dann", "output_classifier_sr",
              "dis_gen_synth", "seg_head"]


def _check_losses(want, got, label):
    assert set(got) <= set(want), set(got) - set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-7,
                                   err_msg=f"{k} {label}")


def test_losses_match_jax_at_every_step(runs):
    """Every step kind of 3 iterations, each from the same state."""
    steps = runs["steps"]
    assert [kind for kind, *_ in steps] == STEP_KINDS
    synth = steps[3][2]
    for k in ("loss_gen_recon_synth", "loss_sem_seg",
              "loss_output_classifier_adv_sr", "domain_adv_loss_gen"):
        assert synth[k] > 0, k
    for i, (kind, want, got, *_) in enumerate(steps):
        _check_losses(want, got, f"step {i} {kind}")


def test_extra_adam_steps_match_jax(runs):
    """Iterations 0-1 with ExtraAdam: the losses, and each optimizer's
    count, anchor flag and (where the flag is set) anchor after every step
    exactly as JAX's.
    Iteration 0 extrapolates: its real fused step takes the anchor, its
    synthetic one keeps it; the output classifier step never
    extrapolates; iteration 1 steps from the anchors."""
    steps = runs["extra_adam"]
    assert [kind for kind, *_ in steps] == STEP_KINDS[:12]
    for i, (kind, want, got, _, (jopt, popt)) in enumerate(steps):
        _check_losses(want, got, f"step {i} {kind}")
        assert set(popt) == set(jopt)
        for name, (count, has_copy, copy) in jopt.items():
            assert popt[name][:2] == (count, has_copy), (i, kind, name)
            for k, v in copy.items() if has_copy else ():   # else unread
                np.testing.assert_array_equal(popt[name][2][k], v,
                                              err_msg=f"{i} {kind} {name}")
    jopt = steps[3][4][0]                  # after iteration 0's synth step
    assert jopt["gen"][:2] == (2, True) and jopt["dis"][:2] == (2, True)
    assert jopt["output_classif_sr"][:2] == (1, False)


@pytest.mark.parametrize("kind", ["steps", "extra_adam", "loop"])
@pytest.mark.parametrize("net", list(UPDATES))
def test_parameters_match_jax_after_the_steps(runs, kind, net):
    """Each step's update of the net against JAX's (``update_errors``):
    within 1e-2 lr but for at most 1 % of its weights, none past 2 lr, a
    median move of lr/10 or more where the step updates the net, and no
    move where it does not; running statistics within rtol 1e-4. The
    loop: the 4 iterations' updates, per update of the net."""
    if kind == "loop":
        check_update(runs["loop"][2][net], True, "loop")
        return
    for i, (step, *_, errs, _) in enumerate(runs[kind]):
        check_update(errs[net], net in UPDATED[step], f"{kind} {i} {step}")


def test_checkpoint_with_the_new_nets_resumes_bitwise(tmp_path):
    """2 iterations, a save, a trainer of another seed restored from it and
    1 more iteration, against 3 uninterrupted: every net, buffer and
    optimizer leaf equal, the new nets' and their optimizers' too."""
    conf = validate(_spec(optimizer="extra_adam"))
    batch = [torch.from_numpy(a) for a in train_batch(3)]
    synth = {k: torch.from_numpy(v) for k, v in synth_batch().items()}

    def trainer(seed):
        tr = MUNITTrainer(conf, "cpu")
        tr.init(torch.Generator().manual_seed(seed))
        cli_train.load_segmenter(tr, conf)   # as the CLI re-makes it
        return tr

    full = trainer(0)
    train_steps(full, *batch, range(2), synth)
    ckpt = str(tmp_path / "checkpoints")
    checkpoint.save_checkpoint(ckpt, full.state_dict(), 2)
    train_steps(full, *batch, [2], synth)
    resumed = trainer(1)
    assert checkpoint.resume(resumed, ckpt) == 2
    train_steps(resumed, *batch, [2], synth)
    state, other = full.state_dict(), resumed.state_dict()
    assert {"dann", "output_classifier_sr_a", "seg_head"} <= set(
        state["nets"])
    assert {"dann", "output_classif_sr", "seg"} <= set(state["opt"])
    assert state["opt"]["seg"]["has_copy"]       # iteration 2 extrapolated
    for net, sd in state["nets"].items():
        for k, v in sd.items():
            assert torch.equal(other["nets"][net][k], v), (net, k)
    for name, opt in state["opt"].items():
        for field in ("mu", "nu", "params_copy"):
            for k, v in opt[field].items():
                assert torch.equal(other["opt"][name][field][k], v), (
                    name, field, k)
        assert (other["opt"][name]["count"], other["opt"][name]["has_copy"]
                ) == (opt["count"], opt["has_copy"])
