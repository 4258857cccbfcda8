"""Vanilla MUNIT in the port against the JAX package: upstream's generator
(``gen_state: 0``, two AdaINGen auto-encoders), random styles (``guided:
0``) and the VGG16 perceptual loss (``vgg_w: 1``) on ``small_train_spec``
(small widths, 32 px, batch 2, the fork's classifier_sr fool term and
step), with one JAX ``MUNITTrainer`` and the numpy-made VGG weights of
``torch_port_util.vgg_ref_weights`` in both packages.

- Each step kind of the generator (dis, fused dis+gen, gen) in lockstep
  with JAX: the port starts each step from the JAX state before it and
  takes JAX's own draws, made from that state's ``rng`` with JAX's splits
  (the dis and gen steps: s_a, s_b; the fused step: the dis step's pair,
  then the gen step's). Every loss within rtol 1e-4, each update held to
  JAX's update (``update_errors``: within 1e-2 lr but for 1 % of a net's
  weights), every other net unmoved. The JAX trainer's classifier_sr
  step encodes through ``content_encode_pair``, which reads the dual
  generator's keys, so with ``gen_state: 0`` it raises; the port's step
  takes each domain's content encoder, and is held to moving its
  classifiers alone.
- The draws of the port's own stream: their order and type per step
  through a spy (the images' type, bf16 in bf16 numerics), the fused step's
  D fakes made with the dis draws (caught where D's loss takes them), the
  draws reproducible from a seed.
- A ``guided: 0`` checkpoint resumes bit for bit, the draws after it too.
- ``translate_batch`` writes its ``_NN`` folders, and its decodes equal
  JAX ``GenBundle``'s for the same styles within atol 1e-4; the train CLI
  runs the config on the CPU, resumes, and ``translate`` reads its
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

from munit_tpu.config import validate as jvalidate
from munit_tpu.io.torch_import import export_gen_state_dict
from munit_tpu.nn.vgg import convert_vgg16_state_dict as jax_convert_vgg
from munit_tpu.train import MUNITTrainer as JTrainer
from munit_tpu_torch.__main__ import main as entry
from munit_tpu_torch.cli import translate_batch
from munit_tpu_torch.config import validate
from munit_tpu_torch.core import ops
from munit_tpu_torch.data.datasets import ImageFolder
from munit_tpu_torch.eval.inception import inception_probs, load_inception
from munit_tpu_torch.eval.scores import (conditional_inception_score,
                                         inception_score)
from munit_tpu_torch.io import checkpoint
from munit_tpu_torch.nn.vgg import convert_vgg16_state_dict
from munit_tpu_torch.train.trainer import MUNITTrainer, train_steps
from tests.torch_port_util import (CROP, SMALL_GEN,  # noqa: F401
                                   check_update, inception_ref_weights,
                                   jax_draws, net_groups, one_torch_thread,
                                   port_state, save_torch, small_train_spec,
                                   train_batch, update_errors,
                                   vgg_ref_weights)

LR = 1e-4
SPEC = small_train_spec(gen_state=0, guided=0, vgg_w=1)
STYLE_DIM = SMALL_GEN["style_dim"]
# (iteration, step kind) of the lockstep; the nets each kind updates. With
# the fused step before the gen step instead, one ReLU input of enc_b's
# first res block (the re-encode of x_ab) lies within float32 rounding of
# its kink: there the port's float32 input gradient parts from its float64
# one by 1.8e-2 (its backward on the same input agrees to 7e-8), while
# JAX's float32 run lands on float64's side, and the two packages' gen
# updates part in 3.4 % of the generator's weights. Such a flip is the
# float32 rounding both packages carry (UPDATE_RTOL), not a fault of either;
# the port's float32 takes more of them, its CPU convolutions rounding
# coarser than XLA's (test_torch_grad_accum.py's OTHER_ORDERS).
STEPS = ((0, "dis"), (1, "gen"), (2, "dis_gen"))
UPDATED = {"dis": ("dis",), "dis_gen": ("gen", "dis"), "gen": ("gen",)}


@pytest.fixture(autouse=True)
def parity():
    ops.set_conv_compute(None)
    yield
    ops.set_conv_compute(None)


def run_step(tr, kind, batch, styles=None):
    x_a, x_b, m_a, m_b = batch
    if kind == "dis":
        return tr.dis_update(x_a, x_b, styles=styles)
    if kind == "gen":
        return tr.gen_update(x_a, x_b, m_a, m_b, styles=styles)
    if kind == "dis_gen":
        return tr.dis_gen_update(x_a, x_b, m_a, m_b, styles=styles)
    return tr.domain_classifier_sr_update(x_a, x_b, domain_synth=False,
                                          lamb=SPEC["adaptation"][
                                              "dfeat_lambda"])


def jax_step(jtr, kind, batch):
    x_a, x_b, m_a, m_b = batch
    if kind == "dis":
        return jtr.dis_update(x_a, x_b)
    if kind == "gen":
        return jtr.gen_update(x_a, x_b, m_a, m_b)
    return jtr.dis_gen_update(x_a, x_b, m_a, m_b)


def new_trainer(seed=0, conf=None):
    tr = MUNITTrainer(conf or validate(dict(SPEC)), "cpu")
    tr.init(torch.Generator().manual_seed(seed))
    tr.load_vgg(convert_vgg16_state_dict(vgg_ref_weights()))
    return tr


@pytest.fixture(scope="module")
def lockstep():
    """One JAX trainer; each step kind from the JAX state before it, the
    port in lockstep with JAX's draws. Per step: (kind, JAX's metrics, the
    port's, update_errors). Also the JAX trainer's initial state."""
    jconf = jvalidate(dict(SPEC))
    jtr = JTrainer(jconf, jax.random.PRNGKey(0))
    jtr.load_vgg(jax.tree.map(jnp.asarray, jax_convert_vgg(vgg_ref_weights())))
    init = jax.tree.map(np.asarray, jtr.state)
    batch = train_batch(7)
    jb = list(map(jnp.asarray, batch))
    tb = [torch.from_numpy(a) for a in batch]
    tr = new_trainer()
    before = init
    steps = []
    for it, kind in STEPS:
        jtr.iterations = tr.iterations = it
        draws = jax_draws(before, kind, batch[0].shape[0], STYLE_DIM)
        want = {k: float(v) for k, v in jax_step(jtr, kind, jb).items()}
        after = jax.tree.map(np.asarray, jtr.state)
        tr.load_state_dict(port_state(before, it))
        got = {k: float(v) for k, v in run_step(tr, kind, tb, draws).items()}
        errs = update_errors(
            net_groups(port_state(before, it)["nets"]),
            net_groups(port_state(after, it)["nets"]),
            net_groups(tr.state_dict()["nets"]), LR, {})
        steps.append((kind, want, got, errs))
        before = after
    return {"steps": steps, "init": init, "jtr": jtr}


@pytest.mark.parametrize("i", range(len(STEPS)))
def test_step_matches_jax_with_its_draws(lockstep, i):
    """Every loss of the step within rtol 1e-4 of JAX's (the VGG terms
    above 0 in the gen and fused steps), and its update held to JAX's."""
    kind, want, got, errs = lockstep["steps"][i]
    assert kind == STEPS[i][1]
    assert set(got) <= set(want), set(got) - set(want)
    if kind in ("gen", "dis_gen"):
        assert got["loss_gen_vgg_a"] > 0 and got["loss_gen_vgg_b"] > 0
        assert "loss_gen_vgg_a" in want
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-7,
                                   err_msg=f"{k} step {i} {kind}")
    for net, e in errs.items():
        check_update(e, net in UPDATED[kind], f"step {i} {kind} {net}")


def test_classifier_sr_step_on_gen_state0():
    """The port's classifier_sr step on the two auto-encoders' content
    codes: a finite loss, the classifiers moved, nothing else."""
    tr = new_trainer()
    before = net_groups(checkpoint.to_host(tr.state_dict())["nets"])
    batch = list(map(torch.from_numpy, train_batch(5)))
    loss = run_step(tr, "classifier_sr", batch)["loss_classifier_sr"]
    assert torch.isfinite(loss) and loss > 0
    after = net_groups(tr.state_dict()["nets"])
    for net, sd in after.items():
        moved = any(not np.array_equal(v, before[net][k])
                    for k, v in sd.items())
        assert moved == (net == "classifier"), net


def _spy(tr):
    """Record each draw of ``tr`` as (batch, dtype, tensor)."""
    calls, draw = [], tr.draw_style

    def spy(bsz, dtype):
        t = draw(bsz, dtype)
        calls.append((bsz, dtype, t))
        return t
    tr.draw_style = spy
    return calls


@pytest.mark.parametrize("numerics", ["parity", "bf16"])
def test_draw_order_and_type(numerics):
    """Each step draws its styles in the images' type (bf16 in bf16
    numerics), two per dis and gen step and four per fused step; the fused
    step's D fakes take the first pair: handed in explicitly, the same
    draws give the same losses, and the pairs swapped change D's loss."""
    if numerics == "bf16":
        ops.set_conv_compute(torch.bfloat16)
    tr = new_trainer()
    calls = _spy(tr)
    x_a, x_b, m_a, m_b = map(torch.from_numpy, train_batch(1))
    if numerics == "bf16":
        x_a, x_b = x_a.bfloat16(), x_b.bfloat16()
    batch = (x_a, x_b, m_a, m_b)
    for kind, n in (("dis", 2), ("gen", 2), ("dis_gen", 4)):
        calls.clear()
        state = checkpoint.to_host(tr.state_dict())
        got = run_step(tr, kind, batch)
        assert [(b, d) for b, d, _ in calls] == [(2, x_a.dtype)] * n, kind
        draws = [t for *_, t in calls]
        assert all(t.shape == (2, STYLE_DIM) for t in draws)
        tr.load_state_dict(state)
        again = run_step(tr, kind, batch, styles=draws)
        assert not calls[n:], "explicit styles drew"
        for k, v in got.items():
            assert float(again[k]) == float(v), (kind, k)
        if kind == "dis_gen":
            tr.load_state_dict(state)
            swapped = run_step(tr, kind, batch, styles=draws[2:] + draws[:2])
            assert float(swapped["loss_dis_total"]) != float(
                got["loss_dis_total"])


def test_fused_step_fakes_use_the_dis_draws():
    """D's fakes in the fused step (caught where ``_dis_loss`` takes them)
    are the decodes of the content codes with the dis draws, the first
    pair of its styles, and not the gen draws' cross decodes. The
    lockstep's losses and updates cannot tell the two apart: an untrained
    D's outputs, N(0, 0.02) weights, barely depend on its input."""
    tr = new_trainer()
    x_a, x_b, m_a, m_b = map(torch.from_numpy, train_batch(6))
    g = torch.Generator().manual_seed(8)
    draws = [torch.randn((2, STYLE_DIM), generator=g) for _ in range(4)]
    with torch.no_grad():
        c_a, c_b = tr.gen.encode_content(x_a, 1), tr.gen.encode_content(x_b, 2)
        want = [(tr.gen.decode(c_b, s_a, 1), tr.gen.decode(c_a, s_b, 2))
                for s_a, s_b in (draws[:2], draws[2:])]
    seen, dis_loss = [], tr._dis_loss

    def spy(x_ba, x_ab, *rest):
        seen.append((x_ba.detach().clone(), x_ab.detach().clone()))
        return dis_loss(x_ba, x_ab, *rest)
    tr._dis_loss = spy
    tr.dis_gen_update(x_a, x_b, m_a, m_b, styles=draws)
    assert len(seen) == 1
    for got, dis, gen in zip(seen[0], *want):
        np.testing.assert_allclose(got.numpy(), dis.numpy(), rtol=0,
                                   atol=1e-6)
        assert np.abs(got.numpy() - gen.numpy()).max() > 1e-2


def test_port_draws_are_reproducible_from_a_seed():
    batch = list(map(torch.from_numpy, train_batch(2)))
    runs = []
    for seed in (3, 3, 4):
        tr = new_trainer()
        tr.seed_styles(seed)
        runs.append([{k: float(v) for k, v in m.items()}
                     for m in train_steps(tr, *batch, range(2))])
    assert runs[0] == runs[1]
    assert runs[0][1]["loss_gen_total"] != runs[2][1]["loss_gen_total"]


def test_guided0_checkpoint_resumes_bitwise(tmp_path):
    """2 iterations, a save, 1 more; a trainer of another seed restored
    from the save runs the same iteration: its losses (the draws after the
    resume) and its whole state equal the uninterrupted run's."""
    conf = validate(dict(SPEC, optimizer="extra_adam", ratio_disc_gen=1))
    batch = list(map(torch.from_numpy, train_batch(4)))
    full = new_trainer(0, conf)
    full.seed_styles(11)
    train_steps(full, *batch, range(2))
    ckpt = str(tmp_path / "checkpoints")
    checkpoint.save_checkpoint(ckpt, full.state_dict(), 2)
    want = train_steps(full, *batch, [2])[0]
    resumed = new_trainer(1, conf)
    assert checkpoint.resume(resumed, ckpt) == 2
    got = train_steps(resumed, *batch, [2])[0]
    for k, v in want.items():
        assert float(got[k]) == float(v), k
    a = checkpoint.to_host(full.state_dict())
    b = checkpoint.to_host(resumed.state_dict())

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v
    la, lb = dict(leaves(a)), dict(leaves(b))
    assert set(la) == set(lb) and "styles/generator" in la
    for k, v in la.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, lb[k]), k
        else:
            assert v == lb[k], k


def _images(folder, n=2, seed=0):
    rng = np.random.RandomState(seed)
    folder.mkdir(parents=True)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (40, 44, 3), np.uint8)).save(
            folder / f"x{i}.png")


def test_translate_batch_matches_jax(lockstep, tmp_path, capsys):
    """The JAX trainer's generator as a reference {"a", "b"} .pt: the
    port's translate_batch writes input<i>.jpg and num_style folders, and
    each image's decodes equal JAX GenBundle's with the same styles (the
    port's seeded draws) within atol 1e-4; --synchronized takes the same
    styles for every image; --mesh auto on the CPU is the plain run;
    --compute_IS/--compute_CIS print the scores of the same translations'
    Inception predictions."""
    jtr, params = lockstep["jtr"], lockstep["init"]["gen"]
    ckpt = tmp_path / "gen.pt"
    torch.save({h: {k: torch.from_numpy(np.array(v)) for k, v in
                    export_gen_state_dict(params[h], SMALL_GEN,
                                          dual=False).items()}
                for h in ("a", "b")}, ckpt)
    cfg = tmp_path / "c.yaml"
    cfg.write_text(yaml.safe_dump(dict(SPEC)))
    _images(tmp_path / "in")
    args = ["--config", str(cfg), "--checkpoint", str(ckpt),
            "--input_folder", str(tmp_path / "in"), "--device", "cpu",
            "--num_style", "3", "--seed", "5"]
    out = str(tmp_path / "out")
    outs = translate_batch.main(args + ["--output_folder", out])
    for j in range(3):
        assert sorted(os.listdir(f"{out}_{j:02d}")) == ["x0.png", "x1.png"]
    assert sorted(os.listdir(out)) == ["input000.jpg", "input001.jpg"]
    g = torch.Generator().manual_seed(5)
    torch.randn((3, STYLE_DIM), generator=g)           # the synchronized
    data = ImageFolder(str(tmp_path / "in"), CROP, CROP, CROP, train=False,
                       crop=False)
    jparams = jax.tree.map(jnp.asarray, params)
    for i, got in enumerate(outs):
        x = jnp.asarray(data.get(i, np.random.default_rng(0))["image"])[None]
        styles = jnp.asarray(torch.randn((3, STYLE_DIM), generator=g).numpy())
        c, _ = jtr.gen.encode(jparams, x, 1)
        want = jtr.gen.decode(jparams, jnp.repeat(c, 3, axis=0), styles, 2)
        assert got.shape == want.shape and got.shape[0] == 3
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    sync = translate_batch.main(args + ["--synchronized", "--output_only",
                                        "--output_folder",
                                        str(tmp_path / "sync")])
    assert not os.path.exists(tmp_path / "sync")
    fixed = torch.randn((3, STYLE_DIM),
                        generator=torch.Generator().manual_seed(5))
    for i, got in enumerate(sync):
        x = jnp.asarray(data.get(i, np.random.default_rng(0))["image"])[None]
        c, _ = jtr.gen.encode(jparams, x, 1)
        want = jtr.gen.decode(jparams, jnp.repeat(c, 3, axis=0),
                              jnp.asarray(fixed.numpy()), 2)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    # --mesh auto (ROADMAP item 16, refused until it was ported) on the CPU
    # is the one-device run, bit for bit
    meshed = translate_batch.main(args + ["--output_folder", out, "--mesh",
                                          "auto"])
    for got, want in zip(meshed, outs):
        np.testing.assert_array_equal(got, want)
    # --compute_IS and --compute_CIS (ROADMAP item 14, refused until it was
    # ported) score the same translations with the given Inception
    incep = save_torch(inception_ref_weights(0), tmp_path / "incep.pth")
    for flag in ("--compute_IS", "--compute_CIS"):
        with pytest.raises(SystemExit, match="needs --inception_ckpt"):
            translate_batch.main(args + ["--output_folder", out, flag])
    capsys.readouterr()
    scored = translate_batch.main(args + [
        "--output_folder", out, "--compute_IS", "--compute_CIS",
        "--inception_ckpt", incep])
    net = load_inception(incep, "cpu")
    with torch.no_grad():
        preds = [inception_probs(net, (torch.from_numpy(y) + 1) / 2).numpy()
                 for y in scored]
    printed = capsys.readouterr().out
    assert f"Inception Score: {inception_score(np.concatenate(preds))}" \
        in printed
    assert ("conditional Inception Score: "
            f"{conditional_inception_score(np.stack(preds))}") in printed
    for got, want in zip(scored, outs):
        np.testing.assert_array_equal(got, want)


def _train_data(root):
    rng = np.random.RandomState(1)
    root.mkdir()
    keys = {}
    for dom in ("a", "b"):
        paths = []
        for i in range(4):
            p = root / f"{dom}{i}.jpg"
            Image.fromarray(rng.randint(0, 256, (40, 44, 3), np.uint8)).save(p)
            paths.append(str(p))
        (root / f"{dom}.txt").write_text("\n".join(paths) + "\n")
        keys.update({f"data_list_train_{dom}": str(root / f"{dom}.txt"),
                     f"data_list_test_{dom}": str(root / f"{dom}.txt"),
                     f"data_folder_train_{dom}": "/",
                     f"data_folder_test_{dom}": "/"})
    return keys


def test_train_cli_trains_resumes_and_translates(tmp_path):
    """``python -m munit_tpu_torch train --device cpu`` on the vanilla
    config (package defaults: a fused step every iteration; VGG seeded,
    with its warning): 4 iterations straight, and 2 then 2 more with
    --resume, which must end in the same state bit for bit; the guided: 0
    grids (display styles and a fresh seeded draw); then translate and
    translate_batch from the snapshot."""
    spec = dict(SPEC, ratio_disc_gen=1, max_iter=4, log_iter=1,
                snapshot_save_iter=2, image_save_iter=2,
                image_display_iter=1, num_workers=0,
                precision="parity", **_train_data(tmp_path / "data"))
    spec.pop("vgg_model_path", None)

    def train(name, max_iter, resume=False):
        cfg = tmp_path / name / "vanilla.yaml"
        cfg.parent.mkdir(exist_ok=True)
        cfg.write_text(yaml.safe_dump(dict(spec, max_iter=max_iter)))
        entry(["train", "--config", str(cfg), "--output_path",
               str(tmp_path / name), "--device", "cpu", "--seed", "3"]
              + (["--resume"] if resume else []))
        return tmp_path / name / "outputs" / "vanilla"
    straight = train("straight", 4)
    train("split", 2)
    split = train("split", 4, resume=True)
    lines = [json.loads(ln) for ln in open(straight / "metrics.jsonl")]
    losses = [m for m in lines if "loss_dis_total" in m]
    assert [m["step"] for m in losses] == [1, 2, 3, 4]
    assert all(m["loss_gen_vgg_a"] > 0 and np.isfinite(m["loss_gen_total"])
               for m in losses)
    assert (straight / "images" / "gen_a2b_test_00000002.jpg").exists()
    a, _ = checkpoint.restore_checkpoint(str(straight / "checkpoints"), 4)
    b, _ = checkpoint.restore_checkpoint(str(split / "checkpoints"), 4)
    for net in a["nets"]:
        for k, v in a["nets"][net].items():
            assert torch.equal(v, b["nets"][net][k]), (net, k)
    assert torch.equal(a["styles"]["generator"], b["styles"]["generator"])
    ckpts = str(straight / "checkpoints")
    (tmp_path / "in").mkdir()
    Image.open(spec["data_list_train_a"].replace("a.txt", "a0.jpg")).save(
        tmp_path / "in" / "input0.jpg")
    cfg = str(straight / "config.yaml")
    style = spec["data_list_train_b"].replace("b.txt", "b0.jpg")
    entry(["translate", "--config", cfg, "--checkpoint", ckpts, "--input",
           str(tmp_path / "in"), "--style", style, "--output_folder",
           str(tmp_path / "tr"), "--device", "cpu"])
    assert os.listdir(tmp_path / "tr") == ["output000.jpg"]
    entry(["translate_batch", "--config", cfg, "--checkpoint", ckpts,
           "--input_folder", str(tmp_path / "in"), "--output_folder",
           str(tmp_path / "tb"), "--num_style", "2", "--device", "cpu"])
    assert os.listdir(tmp_path / "tb_01") == ["input0.jpg"]
