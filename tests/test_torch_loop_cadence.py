"""The port's training loop (munit_tpu_torch.train.loop) against the JAX
package's, with a spy trainer as in tests/test_loop_cadence.py: the same
update and sample calls at the same iterations over 30 iterations of
config_256's cadence (a fused step every 5th, the classifier_sr step every
15th, grids every 5th and 10th, a snapshot every 12th), the same
metrics.jsonl steps and keys, and the port's divergence and stop paths.
Then the final_test configs' sim→real cadence with a synthetic loader:
the same calls, the synthetic ones (with or without ground truth) told
apart. No net runs: the spy's steps return numbers."""

import json
import os
import threading
from pathlib import Path

import numpy as np
import pytest

from munit_tpu.config import validate as jvalidate
from munit_tpu.train.loop import train_loop as jax_train_loop
from munit_tpu_torch.config import get_config, validate
from munit_tpu_torch.io import checkpoint
from munit_tpu_torch.train.loop import TrainingDiverged, train_loop

ITERS = 30
CADENCE = {"image_save_iter": 10, "image_display_iter": 5,
           "snapshot_save_iter": 12, "log_iter": 1, "display_size": 1}


class SpyTrainer:
    """Logs each step and sample call; each step returns its losses."""

    def __init__(self, conf, nan_at=None):
        self.calls = []
        self.iterations = 0
        self.fused = True
        self.nan_at = nan_at
        ad = conf["adaptation"]
        self.use_classifier_sr = ad["dfeat_lambda"] > 0
        self.use_output_classifier_sr = ad["output_classifier_lambda"] > 0
        self.train_seg = ad["sem_seg_lambda"] > 0
        self.state = {"gen": 0}

    def state_dict(self):
        return {"iterations": self.iterations}

    def update_learning_rate(self):
        pass

    def _log(self, name, *keys):
        self.calls.append((self.iterations, name))
        v = float("nan") if self.iterations == self.nan_at else \
            1.0 + self.iterations
        return {k: v for k in keys}

    def dis_update(self, *a, **k):
        return self._log("dis", "loss_dis_total")

    def gen_update(self, *a, **k):
        return self._log("gen", "loss_gen_total")

    def dis_gen_update(self, *a, synth=False, sem_gt_a=None, **k):
        name = "dis_gen"
        if synth:
            name += " synth" + (" gt" if sem_gt_a is not None else "")
        return self._log(name, "loss_dis_total", "loss_gen_total")

    def domain_classifier_sr_update(self, *a, domain_synth=False, **k):
        return self._log("sr synth" if domain_synth else "sr",
                         "loss_classifier_sr")

    def domain_classifier_update(self, *a, **k):
        return self._log("dann", "domain_class_loss")

    def output_domain_classifier_sr_update(self, *a, **k):
        return self._log("output_sr", "loss_output_classifier_sr")

    def segmentation_head_update(self, *a, **k):
        return self._log("seg_head", "loss_semantic_head")

    def sample(self, x_a, x_b):
        self.calls.append((self.iterations, f"sample {x_a[0, 0, 0, 0]}"))
        return tuple(np.zeros((1, 4, 4, 3), np.float32) for _ in range(8))


class FakeLoader:
    def __iter__(self):
        while True:
            yield {"image": np.zeros((1, 4, 4, 3), np.float32),
                   "mask": np.zeros((1, 4, 4, 1), np.float32)}


class SynthLoader:
    def __iter__(self):
        while True:
            yield {"image_a": np.zeros((1, 4, 4, 3), np.float32),
                   "image_b": np.zeros((1, 4, 4, 3), np.float32),
                   "mask": np.zeros((1, 4, 4, 1), np.float32),
                   "sem_a": np.zeros((1, 4, 4), np.int32),
                   "sem_b": np.zeros((1, 4, 4), np.int32)}


CONFIG = Path(__file__).resolve().parents[1] / "configs" / "config_256.yaml"
FINAL_TEST = CONFIG.parent / "final_test"


def _conf(validate_fn, **over):
    return validate_fn({**get_config(str(CONFIG)), **CADENCE, **over})


def _display():
    # train_a, train_b, test_a, test_b, told apart by their first value
    return tuple(np.full((1, 4, 4, 3), v, np.float32) for v in range(4))


def _metrics(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    out = {}
    for name, loop, vfn in (("jax", jax_train_loop, jvalidate),
                            ("port", train_loop, validate)):
        conf = _conf(vfn)
        tr = SpyTrainer(conf)
        path = str(tmp_path_factory.mktemp(name))
        kw = {"device": "cpu"} if name == "port" else {}
        end = loop(tr, conf, {"a": FakeLoader(), "b": FakeLoader()}, path,
                   max_iter=ITERS, display_batches=_display(), **kw)
        out[name] = (end, tr.calls, _metrics(path), path)
    return out


def test_both_loops_make_the_same_calls(both_runs):
    jend, jcalls, _, _ = both_runs["jax"]
    end, calls, _, _ = both_runs["port"]
    assert end == jend == ITERS
    assert calls == jcalls
    assert [it for it, n in calls if n == "dis_gen"] == [4, 9, 14, 19, 24, 29]
    assert [it for it, n in calls if n == "sr"] == [14, 29]
    # grids: test then train at 10, 20, 30; train_current every 5th
    assert [(it, n) for it, n in calls if n.startswith("sample")][:4] == [
        (4, "sample 0.0"), (9, "sample 2.0"), (9, "sample 0.0"),
        (9, "sample 0.0")]


def test_both_loops_log_the_same_steps_and_keys(both_runs):
    want, got = both_runs["jax"][2], both_runs["port"][2]
    assert [(m["step"], sorted(m)) for m in got] == \
        [(m["step"], sorted(m)) for m in want]
    for w, g in zip(want, got):
        for k in w:
            if k != "images_per_sec":
                assert g[k] == w[k], (g["step"], k)
    # the last window, after the snapshot at 24
    assert [m["step"] for m in got if "images_per_sec" in m] == [ITERS]


def test_snapshots_and_grids_at_the_same_steps(both_runs):
    path = both_runs["port"][3]
    assert checkpoint.steps(os.path.join(path, "checkpoints")) == [12, 24]
    jsteps = sorted(int(d) for d in os.listdir(
        os.path.join(both_runs["jax"][3], "checkpoints")) if d.isdigit())
    assert jsteps == [12, 24]
    assert sorted(os.listdir(os.path.join(path, "images"))) == sorted(
        os.listdir(os.path.join(both_runs["jax"][3], "images")))
    assert os.path.exists(os.path.join(path, "index.html"))


@pytest.mark.parametrize("nan_at,snapshots", [(2, []), (4, [2, 4])])
def test_nan_raises_at_the_flush_and_commits_no_later_snapshot(
        tmp_path, nan_at, snapshots):
    """A NaN at iteration ``nan_at`` raises TrainingDiverged before the
    next snapshot: the flush before a snapshot checks the window first."""
    conf = _conf(validate, snapshot_save_iter=2 if snapshots else 4,
                 image_save_iter=1000, image_display_iter=1000)
    tr = SpyTrainer(conf, nan_at=nan_at)
    with pytest.raises(TrainingDiverged, match="loss_dis_total"):
        train_loop(tr, conf, {"a": FakeLoader(), "b": FakeLoader()},
                   str(tmp_path), max_iter=ITERS, device="cpu")
    assert checkpoint.steps(str(tmp_path / "checkpoints")) == snapshots
    assert max(it for it, _ in tr.calls) == nan_at + 1


def test_stop_event_snapshots_and_returns_the_iteration(tmp_path):
    conf = _conf(validate, image_save_iter=1000, image_display_iter=1000)
    stop = threading.Event()
    tr = SpyTrainer(conf)
    orig = tr.dis_update

    def dis_and_maybe_stop(*a, **k):
        if tr.iterations == 3:
            stop.set()        # the signal lands during iteration 3
        return orig(*a, **k)
    tr.dis_update = dis_and_maybe_stop
    end = train_loop(tr, conf, {"a": FakeLoader(), "b": FakeLoader()},
                     str(tmp_path), max_iter=100, stop=stop, device="cpu")
    assert end == 4
    ckpt = str(tmp_path / "checkpoints")
    assert checkpoint.steps(ckpt) == [4]
    assert checkpoint.restore_checkpoint(ckpt)[0] == {"iterations": 3}
    assert _metrics(str(tmp_path))[-1] == {"step": 4, "preempted": 1.0}


def _both_loops(conf_of, loaders, tmp_path, iters):
    """Each loop with a spy on ``conf_of(validate_fn)``: its calls."""
    calls = {}
    for name, loop, vfn in (("jax", jax_train_loop, jvalidate),
                            ("port", train_loop, validate)):
        conf = conf_of(vfn)
        tr = SpyTrainer(conf)
        kw = {"device": "cpu"} if name == "port" else {}
        assert loop(tr, conf, loaders(), str(tmp_path / name),
                    max_iter=iters, **kw) == iters
        calls[name] = tr.calls
    return calls


@pytest.mark.parametrize("key,value,item", [
    ("domain_adv_w", 1.0, "item 11"),
    ("adaptation", {"sem_seg_lambda": 1.0}, "item 11"),
    ("adaptation", {"output_classifier_lambda": 1.0}, "item 11"),
    ("eval_fid", 1, "item 14")])
def test_loop_refuses_unported_branches(tmp_path, key, value, item):
    """The branches refused until their ROADMAP item was ported now run.
    The DANN, seg-head and output-level branches (item 11): with a
    synthetic loader both loops make the same calls, the branch's step
    among them. In-training FID (item 14): both loops call the FID metric
    once a snapshot, after it, and log its value as ``FID``."""
    if item == "item 14":
        def fid_metrics(trainer, loader):
            assert loader == "fid pairs"
            trainer.calls.append((trainer.iterations, "fid"))
            return 10.0 + trainer.iterations

        iters = CADENCE["snapshot_save_iter"] + 1
        calls = _both_loops(
            lambda vfn: _conf(vfn, **{key: value}),
            lambda: {"a": FakeLoader(), "b": FakeLoader(),
                     "fid": "fid pairs", "fid_metrics": fid_metrics},
            tmp_path, iters)
        assert calls["port"] == calls["jax"]
        assert [it for it, n in calls["port"] if n == "fid"] == [iters - 2]
        for name in ("jax", "port"):
            assert [m for m in _metrics(str(tmp_path / name)) if "FID" in m
                    ] == [{"step": iters - 1, "FID": 10.0 + iters - 2}]
        return
    calls = _both_loops(
        lambda vfn: _conf(vfn, synthetic_frequency=1, **{key: value}),
        lambda: {"a": FakeLoader(), "b": FakeLoader(),
                 "synth": SynthLoader()}, tmp_path, 3)
    assert calls["port"] == calls["jax"]
    step = {"domain_adv_w": "dann", "sem_seg_lambda": "seg_head",
            "output_classifier_lambda": "output_sr"}[
        next(iter(value)) if key == "adaptation" else key]
    assert [it for it, n in calls["port"] if n == step] == [0, 1, 2]


@pytest.mark.parametrize("flavor,over", [
    ("FeatureDA", {"domain_adv_w": 1, "adaptation": {"sem_seg_lambda": 1}}),
    ("Output_DA", {})])
def test_final_test_cadence_matches_jax(tmp_path, flavor, over):
    """A final_test config with a synthetic loader over 30 iterations:
    both loops make the same calls, real then synthetic steps in each
    iteration (FeatureDA with the DANN and the seg head added, as no
    shipped config turns them on)."""
    def conf_of(vfn):
        raw = get_config(str(FINAL_TEST / f"{flavor}.yaml"))
        ad = dict(raw["adaptation"], **over.get("adaptation", {}))
        return vfn({**raw, **CADENCE, **over, "adaptation": ad})
    calls = _both_loops(conf_of, lambda: {"a": FakeLoader(),
                                          "b": FakeLoader(),
                                          "synth": SynthLoader()},
                        tmp_path, ITERS)
    assert calls["port"] == calls["jax"]
    first = [n for it, n in calls["port"] if it == 0]
    if flavor == "FeatureDA":
        assert first == ["dis_gen", "dann", "dis_gen synth gt", "seg_head"]
        assert [n for it, n in calls["port"] if it == 14] == [
            "dis_gen", "dann", "sr", "dis_gen synth gt", "sr synth",
            "seg_head"]
    else:
        assert first == ["dis_gen", "output_sr", "dis_gen synth gt"]


def test_profile_window_writes_a_trace(tmp_path):
    """--profile: torch.profiler over iterations 2-3, its chrome trace in
    <run>/trace."""
    conf = _conf(validate, image_save_iter=1000, image_display_iter=1000)
    end = train_loop(SpyTrainer(conf), conf,
                     {"a": FakeLoader(), "b": FakeLoader()}, str(tmp_path),
                     max_iter=5, profile=(2, 2), device="cpu")
    assert end == 5
    trace = tmp_path / "trace" / "trace.json"
    assert json.loads(trace.read_text())["traceEvents"]
