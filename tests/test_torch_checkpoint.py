"""The port's whole-state checkpoints (munit_tpu_torch.io.checkpoint,
``MUNITTrainer.state_dict``/``load_state_dict``) on the CPU, torch only.

At ``small_train_spec(optimizer="extra_adam", semantic_w=3)``, with the
seeded segmenter that the CLI re-makes on resume: 8 uninterrupted
iterations of bench.py's cadence equal 3 iterations, a save, a fresh
trainer of another seed, a resume and 5 more, bitwise, over every
parameter, buffer and optimizer leaf. After 3 iterations the
discriminators' last half-step was an extrapolation (iteration 2 is
even), so their anchor ``params_copy`` must survive the round trip.
Then the file handling: ``latest_step``, pruning to ``snapshot_keep``,
the atomic rename, the writer's host copy, and the refusal of a munit_tpu
(orbax) directory."""

import os

import numpy as np
import pytest
import torch

from munit_tpu_torch.cli.train import load_segmenter
from munit_tpu_torch.config import validate
from munit_tpu_torch.io import checkpoint
from munit_tpu_torch.train.trainer import MUNITTrainer, train_steps
from tests.torch_port_util import (one_torch_thread,  # noqa: F401
                                   small_train_spec, train_batch)

SPLIT, ITERS = 3, 8


def _trainer(seed):
    tr = MUNITTrainer(validate(small_train_spec(optimizer="extra_adam",
                                                semantic_w=3)), "cpu")
    tr.init(torch.Generator().manual_seed(seed))
    load_segmenter(tr, tr.conf)
    return tr


def _run(tr, start, stop):
    for it in range(start, stop):
        train_steps(tr, *map(torch.from_numpy, train_batch(it)), [it])


def _leaves(state, prefix=""):
    if isinstance(state, dict):
        for k, v in state.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, state


def test_resume_mid_extrapolation_is_bitwise_exact(tmp_path):
    ckpt = str(tmp_path / "checkpoints")
    full = _trainer(0)
    _run(full, 0, SPLIT)
    # D's half-steps 0 and 2 extrapolated, 1 stepped: the anchor is held
    assert full.dis_opt.has_copy and full.dis_opt.count == 3
    checkpoint.save_checkpoint(ckpt, full.state_dict(), SPLIT)
    _run(full, SPLIT, ITERS)          # uninterrupted past the save

    resumed = _trainer(7)
    assert checkpoint.resume(resumed, ckpt) == SPLIT
    assert resumed.dis_opt.has_copy and resumed.dis_opt.count == 3
    _run(resumed, SPLIT, ITERS)

    want = dict(_leaves(full.state_dict()))
    got = dict(_leaves(resumed.state_dict()))
    assert set(got) == set(want)
    assert any("running_mean" in k for k in want)       # buffers too
    assert any("params_copy" in k for k in want)
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            np.testing.assert_array_equal(got[k].numpy(), w.numpy(),
                                          err_msg=k)
        else:
            assert got[k] == w, k
    for name, p in full.segmenter.state_dict().items():
        assert torch.equal(resumed.segmenter.state_dict()[name], p), name


def _state(v):
    return {"iterations": v, "nets": {"w": torch.full((2, 2), float(v))}}


def test_latest_step_prune_and_atomic_rename(tmp_path):
    ckpt = str(tmp_path)
    assert checkpoint.latest_step(ckpt) is None
    for step in (10, 20, 30):
        checkpoint.save_checkpoint(ckpt, _state(step), step, keep=2)
    assert checkpoint.steps(ckpt) == [20, 30]
    assert sorted(os.listdir(ckpt)) == ["ckpt_00000020.pt",
                                        "ckpt_00000030.pt"]
    # a write cut short leaves only its temporary file, which is not read
    (tmp_path / "ckpt_00000040.pt.123.tmp").write_bytes(b"torn")
    assert checkpoint.latest_step(ckpt) == 30
    state, step = checkpoint.restore_checkpoint(ckpt)
    assert step == 30 and torch.equal(state["nets"]["w"],
                                      torch.full((2, 2), 30.0))
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(str(tmp_path / "none"))


def test_writer_copies_before_save_returns(tmp_path):
    live = _state(1)
    with checkpoint.CheckpointWriter(str(tmp_path)) as writer:
        writer.save(live, 1)
        live["nets"]["w"].add_(100)        # training goes on in place
        writer.save(live, 2)
    assert checkpoint.steps(str(tmp_path)) == [1, 2]
    for step, value in ((1, 1.0), (2, 101.0)):
        state, _ = checkpoint.restore_checkpoint(str(tmp_path), step)
        assert torch.equal(state["nets"]["w"], torch.full((2, 2), value))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_munit_tpu_orbax_directory_is_refused(tmp_path):
    from munit_tpu.io.checkpoint import save_checkpoint as jax_save
    jax_save(str(tmp_path), {"w": np.zeros(2, np.float32)}, 10)
    with pytest.raises(ValueError, match="orbax.*needs JAX"):
        checkpoint.latest_step(str(tmp_path))


def test_other_file_and_other_config_are_refused(tmp_path):
    path = tmp_path / "ckpt_00000001.pt"
    torch.save({"2": {}}, path)
    with pytest.raises(ValueError, match="not a munit_tpu_torch training"):
        checkpoint.load_checkpoint(str(path))
    tr = MUNITTrainer(validate(small_train_spec()), "cpu")
    state = tr.state_dict()
    del state["nets"]["classifier_sr_a"]
    with pytest.raises(ValueError, match="nets"):
        tr.load_state_dict(state)
