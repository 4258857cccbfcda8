"""bench_torch.py, the port's counterpart of bench.py, executed end to end
on the CPU at BENCH_TINY shapes (``BENCH_DEVICE=cpu``: the kernels' plain
versions): the same cadence (dis steps, the fused dis+gen step with the
semantic loss, the classifier_sr step) and the same JSON line as bench.py,
plus the run's numerics, in bf16 and in f32. Left at its default
``BENCH_DEVICE=cuda`` it refuses to run without a card.
"""

import importlib
import json
import os
from collections import Counter

import pytest
import torch

from munit_tpu_torch.config import validate
from munit_tpu_torch.core import ops
from munit_tpu_torch.train.trainer import cadence_steps, capture_warmup
from tests.torch_port_util import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def bench(monkeypatch):
    monkeypatch.setenv("BENCH_BATCH", "1")
    monkeypatch.setenv("BENCH_ITERS", "2")
    monkeypatch.setenv("BENCH_CROP", "64")
    monkeypatch.setenv("BENCH_TINY", "1")
    monkeypatch.syspath_prepend(REPO)

    def load(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        import bench_torch
        return importlib.reload(bench_torch)   # re-read the env knobs
    yield load
    ops.set_conv_compute(None)


@pytest.mark.parametrize("numerics", ["bf16", "f32"])
def test_bench_torch_smoke(bench, capsys, numerics):
    flag = "1" if numerics == "bf16" else "0"
    bench(BENCH_DEVICE="cpu", BENCH_BF16=flag, BENCH_ACT_BF16=flag).main()
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "munit_256_train_images_per_sec_per_chip"
    assert rec["unit"] == "images/sec/chip"
    assert rec["numerics"] == numerics
    assert rec["value"] > 0
    # vs_baseline is round(value/20, 3): compare at the rounding granularity
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 20.0, abs=6e-4)


def test_bench_torch_grad_accum_from_the_environment(bench, capsys,
                                                     monkeypatch):
    """MUNIT_GRAD_ACCUM=2 reaches the trainer as bench.py's reaches the JAX
    trainer: the batch of 2 runs as two micro-batches, with the warning of
    the classifier term's chunk statistics."""
    monkeypatch.setenv("MUNIT_GRAD_ACCUM", "2")
    with pytest.warns(UserWarning, match="chunk statistics"):
        bench(BENCH_DEVICE="cpu", BENCH_BATCH="2").main()
    out = capsys.readouterr()
    assert "batch 2, crop 64" in out.err and "grad_accum 2" in out.err
    assert json.loads(out.out.strip().splitlines()[-1])["value"] > 0


def test_bench_torch_needs_a_card_by_default(bench, monkeypatch, capsys):
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench().main()
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("env,match", [
    ({"BENCH_MESH": "auto"}, "item 16"), ({"BENCH_REMAT": "1"}, "item 13")])
def test_bench_torch_refuses_what_is_not_ported(bench, env, match):
    with pytest.raises(NotImplementedError, match=match):
        bench(BENCH_DEVICE="cpu", **env).main()


@pytest.mark.parametrize("optimizer,iterations", [("adam", 30),
                                                  ("extra_adam", 60)])
def test_bench_warmup_reaches_every_step_variant(bench, optimizer,
                                                 iterations):
    """bench_torch.py's warm-up (``capture_warmup`` of its spec) calls each
    step variant of the timed iterations twice, once eagerly and once to
    capture it on a card, and one iteration fewer would not: the clock
    times replays only. Python over the iteration numbers."""
    conf = validate({**bench().spec(), "optimizer": optimizer})
    warm = capture_warmup(conf)
    assert warm == iterations

    def calls(n):
        return Counter(v for it in range(n) for v in cadence_steps(conf, it))
    timed = {v for it in range(warm, warm + 150)
             for v in cadence_steps(conf, it)}
    assert all(calls(warm)[v] >= 2 for v in timed)
    assert any(calls(warm - 1)[v] < 2 for v in timed)
    assert {k for k, _ in timed} == {"dis", "dis_gen", "classifier_sr"}
    assert {p for _, p in timed} == ({False} if optimizer == "adam"
                                     else {False, True})
