"""The port's training path as a whole against the JAX package's, on one
JAX ``MUNITTrainer`` (small widths, 32 px, batch 2, masked cycle loss,
``adv_lambda: 6``, ``dfeat_lambda: 1``, ``semantic_w: 0``, Adam with
weight decay, ``ratio_disc_gen: 2``, ``classif_frequency: 2``); the port
starts from its seeded state.

- The steps on a fixed batch, bench.py's cadence: iteration 0 a dis step,
  1 the fused dis+gen step and the ``classifier_sr`` step, 2 a dis step.
- The loop: both packages' ``build_loaders`` read the same seeded JPEG and
  mask lists, and both ``train_loop``s run 6 iterations in f32 parity.

The JAX loop reads the float32 feed, whose images equal the port's
bitwise. Every logged loss of every step agrees within rtol 1e-4 (float32
sums in another order). Adam divides each update by sqrt(v): on a weight
whose gradient is near 0, rounding can flip the update's sign, so the
parameters are bounded at 2 lr per update of their net. The classifiers'
running statistics agree within rtol 1e-4 after the steps; after the loop,
where they average content codes of 3 generator updates, within the
generator's bound.

Then the port's CLI (``python -m munit_tpu_torch train``, in process, on
the CPU, in the config's default bf16): its run directory, a resumed run
that equals an uninterrupted one bitwise, and ``translate`` from its
snapshot.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from munit_tpu.cli.train import build_loaders as jax_build_loaders
from munit_tpu.config import validate as jvalidate
from munit_tpu.train import MUNITTrainer as JTrainer
from munit_tpu.train.loop import train_loop as jax_train_loop
from munit_tpu_torch.cli import train as cli_train
from munit_tpu_torch.cli import translate
from munit_tpu_torch.config import validate
from munit_tpu_torch.core import ops
from munit_tpu_torch.io import checkpoint
from munit_tpu_torch.nn.generator import GenBundle
from munit_tpu_torch.train.loop import train_loop
from munit_tpu_torch.train.trainer import MUNITTrainer, train_steps
from tests.torch_port_util import (jax_net_params, jax_steps,  # noqa: F401
                                   load_jax_state, one_torch_thread,
                                   small_train_spec, train_batch)

ITERS = 3         # the fixed-batch steps
LOOP_ITERS = 6    # the loop
LR = 1e-4
# gen, dis and classifier updates in 3 and in 6 iterations of the cadence
UPDATES = {ITERS: {"gen": 1, "dis": ITERS, "classifier": 1},
           LOOP_ITERS: {"gen": 3, "dis": LOOP_ITERS, "classifier": 3}}


def _write_data(root):
    """4 seeded JPEGs per domain (two aspect ratios), binary PNG masks,
    and their lists; returns the config's data keys."""
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
            imgs.append(str(p))
            masks.append(str(m))
        for name, paths in ((f"{dom}.txt", imgs), (f"{dom}_seg.txt", masks)):
            (root / name).write_text("\n".join(paths) + "\n")
        keys.update({f"data_list_train_{dom}": str(root / f"{dom}.txt"),
                     f"data_list_test_{dom}": str(root / f"{dom}.txt"),
                     f"data_folder_train_{dom}": "/",
                     f"data_folder_test_{dom}": "/",
                     f"data_list_train_{dom}_seg": str(root / f"{dom}_seg.txt")})
    return keys


def _loop_spec(data, **over):
    loop = dict(num_workers=2, log_iter=1, max_iter=LOOP_ITERS,
                snapshot_save_iter=1000, image_save_iter=1000,
                image_display_iter=1000)
    return small_train_spec(**data, **{**loop, **over})


def _metrics(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _losses(path):
    """{step: {name: value}} of a run's loss lines."""
    return {m["step"]: {k: v for k, v in m.items() if k != "step"}
            for m in _metrics(path)
            if "step" in m and "loss_dis_total" in m}


def _port_nets(tr):
    return {"gen": tr.gen.state_dict(),
            "dis": {f"{d}.{k}": v for d in ("a", "b")
                    for k, v in getattr(tr, f"dis_{d}").state_dict().items()},
            "classifier": {f"{d}.{k}": v for d in ("a", "b") for k, v in
                           getattr(tr, f"classifier_sr_{d}").state_dict()
                           .items()}}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_data(tmp_path_factory.mktemp("data"))


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """One JAX trainer: the fixed-batch steps from its seeded state, then
    the loop from the same state; the port's of both."""
    spec = _loop_spec(data)
    assert spec["optimizer"] == "adam"
    jtr = JTrainer(jvalidate(spec), jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jtr.state)   # the steps donate the state
    batch = train_batch(2)
    out = {"steps": {}, "loop": {}}

    want = jax_steps(jtr, map(jnp.asarray, batch), ITERS)
    tr = MUNITTrainer(validate(spec), "cpu")
    load_jax_state(tr, init)
    got = train_steps(tr, *map(torch.from_numpy, batch), range(ITERS))
    out["steps"] = (want, [{k: float(v) for k, v in m.items()} for m in got],
                    jax_net_params(jtr.state), _port_nets(tr))

    # JAX's float32 feed normalizes on the host in the op order the port's
    # device_prefetch uses, so both loops see bitwise-equal images (its
    # default uint8 feed, normalized by XLA in one fused multiply-add, is up
    # to 1 ulp off: tests/test_torch_data.py)
    jconf = jvalidate(spec)
    jtr.state, jtr.iterations = jax.tree.map(jnp.asarray, init), 0
    jpath = str(tmp_path_factory.mktemp("jax_run"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MUNIT_LOADER_UINT8", "0")
        jax_train_loop(jtr, jconf, jax_build_loaders(jconf, seed=4), jpath)
    tr = MUNITTrainer(validate(spec), "cpu")
    load_jax_state(tr, init)
    path = str(tmp_path_factory.mktemp("port_run"))
    conf = validate(spec)
    end = train_loop(tr, conf, cli_train.build_loaders(conf, seed=4), path,
                     device="cpu")
    assert end == LOOP_ITERS
    out["loop"] = (_losses(jpath), _losses(path), jax_net_params(jtr.state),
                   _port_nets(tr))
    return out


def _check_losses(want, got):
    assert [sorted(m) for m in got] == [
        sorted(k for k in w if k in m) for w, m in zip(want, got)]
    for it, (w, g) in enumerate(zip(want, got)):
        for k, v in g.items():
            np.testing.assert_allclose(v, w[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"{k} it={it}")


@pytest.mark.parametrize("kind", ["steps", "loop"])
def test_losses_match_jax_at_every_step(runs, kind):
    want, got = runs[kind][:2]
    if kind == "loop":
        assert sorted(got) == sorted(want) == list(range(1, LOOP_ITERS + 1))
        want, got = ([d[s] for s in sorted(d)] for d in (want, got))
    assert "loss_gen_total" in got[1] and "loss_classifier_sr" in got[1]
    _check_losses(want, got)


@pytest.mark.parametrize("kind", ["steps", "loop"])
@pytest.mark.parametrize("net", ["gen", "dis", "classifier"])
def test_parameters_match_jax_after_the_steps(runs, net, kind):
    want, got = runs[kind][2][net], runs[kind][3][net]
    updates = UPDATES[ITERS if kind == "steps" else LOOP_ITERS][net]
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().numpy()
        if "running" in k and kind == "steps":
            # batch statistics of codes after one gen update
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=k)
        elif "running" in k:
            # statistics of content codes whose encoders may differ by the
            # generator's bound: held to that bound
            np.testing.assert_allclose(
                g, w, rtol=0, atol=2 * LR * UPDATES[LOOP_ITERS]["gen"],
                err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * LR * updates,
                                       err_msg=k)


# ----------------------------------------------------------------- the CLI

CLI_SPLIT, CLI_ITERS = 2, 4


@pytest.fixture(scope="module")
def cli_runs(data, tmp_path_factory):
    """The CLI in the config's default precision (bf16): 4 iterations
    uninterrupted, and 2 + --resume to 4 (the config's max_iter raised
    between the runs)."""
    root = tmp_path_factory.mktemp("cli")
    spec = _loop_spec(data, snapshot_save_iter=CLI_SPLIT,
                      image_save_iter=CLI_SPLIT, image_display_iter=1)
    spec.pop("precision", None)

    def run(name, max_iter, *extra):
        cfg = root / f"{name}.yaml"
        cfg.write_text(yaml.safe_dump({**spec, "max_iter": max_iter}))
        end = cli_train.main(["--config", str(cfg), "--output_path",
                              str(root), "--device", "cpu", *extra])
        return end, str(root / "outputs" / name)

    try:
        full = run("full", CLI_ITERS)
        first = run("split", CLI_SPLIT)
        resumed = run("split", CLI_ITERS, "--resume")
        assert ops.conv_compute_dtype() == torch.bfloat16
    finally:
        ops.set_conv_compute(None)
    return full, first, resumed


def test_cli_writes_the_run_directory(cli_runs):
    (end, path), _, _ = cli_runs
    assert end == CLI_ITERS
    assert yaml.safe_load(open(os.path.join(path, "config.yaml")))[
        "max_iter"] == CLI_ITERS
    lines = _metrics(path)
    assert lines[0]["parameters"]["max_iter"] == CLI_ITERS
    losses = _losses(path)
    assert sorted(losses) == list(range(1, CLI_ITERS + 1))
    assert all(np.isfinite(v) for m in losses.values() for v in m.values())
    assert checkpoint.steps(os.path.join(path, "checkpoints")) == [2, 4]
    images = sorted(os.listdir(os.path.join(path, "images")))
    assert images == sorted(f"gen_{d}_{kind}.jpg" for d in ("a2b", "b2a")
                            for kind in ("test_00000002", "train_00000002",
                                         "test_00000004", "train_00000004",
                                         "train_current"))
    # 4 of the 8 columns (no segmenter) a panel, display_size 2 a column
    assert Image.open(os.path.join(path, "images",
                                   "gen_a2b_train_current.jpg")).size == \
        (2 * 32, 4 * 32)
    html = open(os.path.join(path, "index.html")).read()
    assert "gen_a2b_test_00000004.jpg" in html


def test_cli_resume_equals_an_uninterrupted_run(cli_runs):
    (_, full), (end1, _), (end2, split) = cli_runs
    assert (end1, end2) == (CLI_SPLIT, CLI_ITERS)
    want, got = _losses(full), _losses(split)
    assert sorted(got) == list(range(1, CLI_ITERS + 1))
    assert got == want
    a, _ = checkpoint.restore_checkpoint(os.path.join(full, "checkpoints"))
    b, _ = checkpoint.restore_checkpoint(os.path.join(split, "checkpoints"))
    flat = {}
    for name, state in (("full", a), ("split", b)):
        flat[name] = {f"{n}/{k}": v for n, sd in state["nets"].items()
                      for k, v in sd.items()}
    assert set(flat["full"]) == set(flat["split"])
    for k, v in flat["full"].items():
        assert torch.equal(flat["split"][k], v), k


def test_translate_reads_the_cli_snapshot(cli_runs, data, tmp_path):
    """translate --checkpoint <run>/checkpoints takes the latest snapshot's
    generator, as the JAX CLI restores a training directory's gen."""
    _, _, (_, path) = cli_runs
    ckpt_dir = os.path.join(path, "checkpoints")
    inputs = tmp_path / "in"
    inputs.mkdir()
    content = open(data["data_list_train_a"]).read().split()[:2]
    for i, p in enumerate(content):
        Image.open(p).save(inputs / f"input{i}.jpg")
    style = open(data["data_list_train_b"]).read().split()[0]
    outs = translate.main([
        "--config", os.path.join(path, "config.yaml"), "--checkpoint",
        ckpt_dir, "--input", str(inputs), "--style", style,
        "--output_folder", str(tmp_path / "out"), "--device", "cpu"])
    assert len(outs) == 2 and len(os.listdir(tmp_path / "out")) == 2

    state, step = checkpoint.restore_checkpoint(ckpt_dir)
    assert step == CLI_ITERS
    gen = GenBundle(validate(yaml.safe_load(open(
        os.path.join(path, "config.yaml")))), "cpu")
    gen.load_state_dict(state["nets"]["gen"])
    with torch.no_grad():
        s_b = gen.encode_style(translate.load_image(style, 32, "cpu"))
        for out, name in zip(outs, sorted(os.listdir(inputs))):
            x = translate.load_image(str(inputs / name), 32, "cpu")
            want = gen.decode(gen.encode_content(x, 1), s_b, 2)[0].numpy()
            np.testing.assert_array_equal(out, want)


def test_cli_refuses_what_it_cannot_run(data, tmp_path, monkeypatch,
                                        capsys):
    """Another --trainer exits as the reference does; the card by default,
    with no fallback. A synthetic list, refused until ROADMAP item 11 was
    ported, now gets its loader (seed + 2), whose batches hold both
    images, the mask and both semantic maps; in-training FID (item 14) its
    FID pairs' loader."""
    cfg = tmp_path / "c.yaml"
    cfg.write_text(yaml.safe_dump(_loop_spec(data)))
    with pytest.raises(SystemExit, match="Only support MUNIT"):
        cli_train.main(["--config", str(cfg), "--trainer", "UNIT"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli_train.main(["--config", str(cfg), "--output_path",
                        str(tmp_path)])
    # the masks (gray 0 and 255) serve as semantic maps: both are classes
    synth = {"synthetic_frequency": 2,
             "data_list_train_a_synth": data["data_list_train_a"],
             "data_list_train_b_synth": data["data_list_train_b"],
             "data_list_train_b_seg_synth": data["data_list_train_a_seg"],
             "seg_list_a": data["data_list_train_a_seg"],
             "seg_list_b": data["data_list_train_b_seg"]}
    loaders = cli_train.build_loaders(validate(_loop_spec(data, **synth)))
    assert sorted(loaders) == ["a", "b", "synth"]
    assert loaders["synth"].seed == 2
    batch = next(iter(loaders["synth"]))
    assert {k: v.shape for k, v in batch.items()} == {
        "image_a": (2, 32, 32, 3), "image_b": (2, 32, 32, 3),
        "mask": (2, 32, 32, 1), "sem_a": (2, 32, 32), "sem_b": (2, 32, 32)}
    assert set(np.unique(batch["sem_a"])) <= {0, 8}
    # in-training FID, refused until ROADMAP item 14 was ported: with
    # eval_fid and an existing moments file the FID pairs' loader, as the
    # JAX CLI builds it; without an Inception checkpoint no metric, with
    # the JAX CLI's warning; without the moments file neither
    moments = tmp_path / "moments.npz"
    np.savez(moments, mu=np.zeros(2048))
    fid = {"eval_fid": 1, "inception_moment_path": str(moments),
           "data_list_fid_a": data["data_list_train_a"],
           "data_list_fid_b": data["data_list_train_b"], "batch_size_fid": 2}
    loaders = cli_train.build_loaders(validate(_loop_spec(data, **fid)))
    want = jax_build_loaders(jvalidate(_loop_spec(data, **fid)))
    assert sorted(loaders) == sorted(want) == ["a", "b", "fid"]
    got_b, want_b = (list(ld["fid"].batches()) for ld in (loaders, want))
    assert len(got_b) == len(want_b) == 4    # two aspect ratios: batches of 1
    for g, w in zip(got_b, want_b):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    cli_train.attach_fid_metrics(validate(_loop_spec(data, **fid)), loaders,
                                 "cpu")
    assert "fid_metrics" not in loaders
    assert "in-training FID disabled" in capsys.readouterr().out
    fid["inception_moment_path"] = str(tmp_path / "missing.npz")
    assert "fid" not in cli_train.build_loaders(
        validate(_loop_spec(data, **fid)))
