"""configs/config_HD.yaml (ROADMAP item 13b) and the switches of the JAX
trainer in the port, against the JAX package.

- The shipped config validated alike by both packages.
- ``wide`` as JAX's trainer sets it (trainer.py:258-268): 0 at crops of
  512 and more, else 1, the config's ``wide`` over that, ``MUNIT_WIDE``
  over both, 0 with ``gen_state: 0``.
- config_HD with the crop cut to 64 and the widths to tests/
  test_hd_config.py's (batch 2), at wide 0, JAX's HD default: the dis step
  and the fused step in lockstep with one JAX trainer at wide 0 (the port
  from the JAX state before each), every loss within rtol 1e-4 (atol
  1e-7), each update held to JAX's (``update_errors``); then the port at
  wide 1 against the port at wide 0 from one state: the losses within rtol
  1e-5, the updates held as above, and each step's gradients within 1e-4
  of each leaf's largest.
- Each switch that the port refuses, naming its ROADMAP item, one case
  each, and their defaults, which it takes.
- The classifier_sr step with ``gen_state: 0`` held against JAX math
  composed from the JAX package's own pieces: each domain's content code
  from its own auto-encoder (``GenBundle.encode(params, x, 1)`` / ``2``),
  as ``_gen_forward`` encodes at wide 0, the classifiers through
  ``MUNITTrainer._dann_apply``, ``losses.classifier_sr_loss(fool=False)``
  and ``MUNITTrainer._opt_update``: the body of
  ``_classifier_sr_step_impl`` (trainer.py:1283-1312) with the per-domain
  encode in place of ``content_encode_pair``, which reads the dual
  generator's keys and raises there. The loss within rtol 1e-5, the
  update held to the composition's, the running statistics within rtol
  1e-4.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from munit_tpu import losses as jlosses
from munit_tpu.config import get_config as jget_config
from munit_tpu.config import validate as jvalidate
from munit_tpu.nn.resnet import convert_resnet34_8s_state_dict
from munit_tpu.train import MUNITTrainer as JTrainer
from munit_tpu.train.trainer import GenBundle as JGenBundle
from munit_tpu_torch.config import get_config, validate
from munit_tpu_torch.core import ops
from munit_tpu_torch.io.weights import from_jax_classifier, from_jax_params
from munit_tpu_torch.nn.blocks import ConvBlock
from munit_tpu_torch.train.trainer import MUNITTrainer, wide_of
from tests.torch_port_util import (check_update,  # noqa: F401
                                   net_groups, one_torch_thread, port_state,
                                   seg_ref_weights, update_errors)

HD = "configs/config_HD.yaml"
LR = 1e-4
CROP, BATCH = 64, 2
UPDATED = {"dis": ("dis",), "dis_gen": ("gen", "dis")}


@pytest.fixture(autouse=True)
def parity():
    ops.set_conv_compute(None)
    yield
    ops.set_conv_compute(None)


@pytest.fixture(autouse=True)
def no_switches(monkeypatch):
    for var in ("MUNIT_WIDE", "MUNIT_GRAD_ACCUM", "MUNIT_FUSED",
                "MUNIT_INT8_DIS", "MUNIT_SEG_REMAT",
                "MUNIT_ACCUM_SHARED_FWD", "MUNIT_ACCUM_CHUNK_DIS"):
        monkeypatch.delenv(var, raising=False)


def hd_raw(**over):
    """config_HD as tests/test_hd_config.py cuts it: crop 64 (new_size
    72), generator dim 16, MLP 32, discriminator dim 16, 2 layers, 2
    scales, batch 2; every other key as shipped."""
    import yaml
    with open(HD) as f:
        raw = yaml.safe_load(f)
    raw.update(batch_size=BATCH, new_size=72, crop_image_height=CROP,
               crop_image_width=CROP)
    raw["gen"] = dict(raw["gen"], dim=16, mlp_dim=32)
    raw["dis"] = dict(raw["dis"], dim=16, n_layer=2, num_scales=2)
    raw.update(over)
    return raw


def hd_batch(seed=0):
    rng = np.random.RandomState(seed)
    x_a, x_b = (rng.uniform(-1, 1, (BATCH, CROP, CROP, 3)).astype(np.float32)
                for _ in range(2))
    m_a, m_b = ((rng.rand(BATCH, CROP, CROP, 1) > 0.6).astype(np.float32)
                for _ in range(2))
    return x_a, x_b, m_a, m_b


def port_trainer(conf, seg):
    tr = MUNITTrainer(conf, "cpu")
    tr.init(torch.Generator().manual_seed(0))
    tr.load_segmenter({k: torch.from_numpy(v) for k, v in seg.items()})
    return tr


def run_step(tr, kind, batch):
    x_a, x_b, m_a, m_b = batch
    if kind == "dis":
        return tr.dis_update(x_a, x_b)
    return tr.dis_gen_update(x_a, x_b, m_a, m_b)


# --------------------------------------------------------------- config

def test_config_hd_validates_alike():
    """Every key of the port's config_HD equals the JAX package's: the
    shipped 512² crops, new_size 600, batch 1, the segmenter, the masked
    cycle loss and the classifier term at adv_lambda 6."""
    conf, jconf = get_config(HD), jget_config(HD)
    for k, v in conf.items():
        assert jconf[k] == v, k
    assert (conf["crop_image_height"], conf["new_size"], conf["batch_size"],
            conf["semantic_w"], conf["recon_mask"],
            conf["adaptation"]["adv_lambda"]) == (512, 600, 1, 3, 1, 6)
    assert (conf["grad_accum"], conf["accum_shared_fwd"],
            conf["accum_chunk_dis"]) == (1, 0, 0)


@pytest.mark.parametrize("crop,gen_state,key,env,want", [
    (512, 1, None, None, 0), (256, 1, None, None, 1), (64, 1, None, None, 1),
    (512, 1, 1, None, 1), (256, 1, 0, None, 0), (512, 1, 0, "1", 1),
    (256, 1, 1, "0", 0), (512, 0, 1, None, 0), (256, 0, None, "1", 0)])
def test_wide_follows_the_jax_rule(monkeypatch, crop, gen_state, key, env,
                                   want):
    conf = validate(hd_raw(crop_image_height=crop, crop_image_width=crop,
                           new_size=crop, gen_state=gen_state,
                           **({} if key is None else {"wide": key})))
    if env is not None:
        monkeypatch.setenv("MUNIT_WIDE", env)
    assert wide_of(conf) == want


def test_config_hd_trainer_is_narrow_at_512():
    """The shipped config (512², gen_state 1) builds a narrow trainer, and
    MUNIT_WIDE=1 a wide one; no step runs."""
    conf = get_config(HD)
    assert MUNITTrainer(conf, "cpu").wide == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MUNIT_WIDE", "1")
        assert MUNITTrainer(conf, "cpu").wide == 1


# ------------------------------------------------- HD against JAX, wide 0

@pytest.fixture(scope="module")
def hd_runs():
    """One JAX trainer at config_HD (crop 64, wide 0, the segmenter): a dis
    step, then a fused step, the port in lockstep. Per step: (kind, JAX's
    metrics, the port's, update_errors); also the JAX trainer, its first
    state, the segmenter's weights and the batch."""
    seg = seg_ref_weights(2)
    raw = hd_raw(wide=0)
    jtr = JTrainer(jvalidate(raw), jax.random.PRNGKey(3))
    assert jtr.wide == 0 and jtr.grad_accum == 1
    jtr.load_segmenter(jax.tree.map(jnp.asarray,
                                    convert_resnet34_8s_state_dict(seg)))
    batch = hd_batch(1)
    jb = list(map(jnp.asarray, batch))
    tb = [torch.from_numpy(a) for a in batch]
    init = jax.tree.map(np.array, jtr.state)
    before, lock = init, []
    for it, kind in ((0, "dis"), (4, "dis_gen")):
        jtr.iterations = it
        x_a, x_b, m_a, m_b = jb
        want = jtr.dis_update(x_a, x_b) if kind == "dis" else \
            jtr.dis_gen_update(x_a, x_b, m_a, m_b)
        after = jax.tree.map(np.array, jtr.state)
        tr = port_trainer(validate(raw), seg)
        assert tr.wide == 0
        tr.load_state_dict(port_state(before, it))
        got = run_step(tr, kind, tb)
        lock.append((kind, {k: float(v) for k, v in want.items()},
                     {k: float(v) for k, v in got.items()},
                     update_errors(net_groups(port_state(before, it)["nets"]),
                                   net_groups(port_state(after, it)["nets"]),
                                   net_groups(tr.state_dict()["nets"]), LR,
                                   {})))
        before = after
    return {"lockstep": lock, "init": init, "seg": seg, "batch": tb,
            "jtr": jtr}


@pytest.mark.parametrize("i", [0, 1], ids=["dis", "fused"])
def test_hd_wide0_step_matches_jax(hd_runs, i):
    kind, want, got, errs = hd_runs["lockstep"][i]
    assert set(got) <= set(want), set(got) - set(want)
    if kind == "dis_gen":
        assert got["loss_sem_seg"] > 0 and got["loss_classifier_adv_sr"] > 0
        assert got["loss_gen_cycrecon_x_a"] > 0
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-7,
                                   err_msg=f"{k} {kind}")
    for net, e in errs.items():
        check_update(e, net in UPDATED[kind], f"{kind} {net}")


@pytest.mark.parametrize("kind", ["dis", "dis_gen"])
def test_hd_wide1_equals_wide0(hd_runs, kind):
    """The port's wide and narrow calls are the same math per sample: from
    one state, the losses within rtol 1e-5 and the updates held to the
    narrow step's."""
    start = port_state(hd_runs["init"], 4)
    out = {}
    for wide in (0, 1):
        tr = port_trainer(validate(hd_raw(wide=wide)), hd_runs["seg"])
        assert tr.wide == wide
        tr.load_state_dict(start)
        out[wide] = ({k: float(v) for k, v in run_step(
            tr, kind, hd_runs["batch"]).items()},
            net_groups(tr.state_dict()["nets"]))
    for k, v in out[1][0].items():
        np.testing.assert_allclose(v, out[0][0][k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    errs = update_errors(net_groups(start["nets"]), out[0][1], out[1][1], LR,
                         {})
    for net, e in errs.items():
        check_update(e, net in UPDATED[kind], f"{kind} {net}")


@pytest.mark.parametrize("part", ["dis", "gen"])
def test_hd_wide1_gradients_equal_wide0(hd_runs, part):
    """D's and the generator's gradients at wide 1 against wide 0 (no
    optimizer in the way): every leaf within 1e-4 of its largest, but the
    conv biases that a norm takes out (zero gradient, float32 noise in
    both): below 1e-5 of the largest gradient."""
    start = port_state(hd_runs["init"], 4)
    x_a, x_b, m_a, m_b = hd_runs["batch"]
    grads = []
    for wide in (0, 1):
        tr = port_trainer(validate(hd_raw(wide=wide)), hd_runs["seg"])
        tr.load_state_dict(start)
        if part == "dis":
            g, _ = tr._dis_chunk(x_a, x_b)
        else:
            g, _ = tr._gen_chunk(False, False, x_a, x_b, m_a, m_b, None,
                                 None)
        grads.append(g)
    removed = {f"{n}.conv.bias" for n, m in tr.gen.module.named_modules()
               if isinstance(m, ConvBlock) and m.norm_type in ("in", "adain")}
    top = max(g.abs().max().item() for g in grads[0].values())
    for k, want in grads[0].items():
        if k in removed:
            assert grads[1][k].abs().max().item() <= 1e-5 * top, k
            continue
        err = (grads[1][k] - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), (k, err)


@pytest.mark.parametrize("content_hw", [(128, 128), (64, 64), (96, 160)])
def test_domain_classifier_at_the_content_size_matches_jax(content_hw):
    """The sim/real classifier on config_HD's 128x128 content codes (crop
    512): its FC takes the 2x2 pooled map (256 inputs), as the JAX
    package's, built on that content, does; the logits and the running
    statistics after a pass within rtol 1e-4, atol 1e-5."""
    from munit_tpu.nn.classifiers import DomainClassifier as JCls
    from munit_tpu_torch.nn.classifiers import DomainClassifier
    rng = np.random.RandomState(7)
    c = rng.randn(2, *content_hw, 16).astype(np.float32)
    jcls = JCls()
    v = jax.jit(jcls.init)(jax.random.PRNGKey(8), jnp.asarray(c))
    want, upd = jax.jit(lambda v, c: jcls.apply(v, c, True,
                                                mutable=["batch_stats"]))(
        v, jnp.asarray(c))
    cls = DomainClassifier(16, content_hw)
    assert cls.fc.in_features == v["params"]["fc_kernel"].shape[0]
    cls.load_state_dict(from_jax_classifier(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = cls(torch.from_numpy(c), update_stats=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    sd = cls.state_dict()
    for k, w in from_jax_classifier(v["params"], upd["batch_stats"]).items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


# ------------------------------------------------------------ switches

REFUSED = [
    ({"MUNIT_FUSED": "0"}, {}, "item 21"),
    ({}, {"fused": 0}, "item 21"),
    ({}, {"remat": True}, "item 13c"),
    ({}, {"remat": "hd"}, "item 13c"),
    ({}, {"remat": "pads"}, "item 13c"),
    ({"MUNIT_SEG_REMAT": "1"}, {}, "item 13c"),
    ({}, {"wide": 2}, "item 13b"),
    ({"MUNIT_WIDE": "2"}, {}, "item 13b"),
]


@pytest.mark.parametrize("env,over,item", REFUSED,
                         ids=[f"{'-'.join(f'{k}={v}' for k, v in e.items())}"
                              f"{'-'.join(f'{k}={v}' for k, v in o.items())}"
                              for e, o, _ in REFUSED])
def test_unported_switch_raises(monkeypatch, env, over, item):
    """A switch of the JAX trainer (or its train CLI's ``remat``) set to
    what the port lacks raises NotImplementedError naming its item."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=item):
        MUNITTrainer(validate(hd_raw(**over)), "cpu")


@pytest.mark.parametrize("env,over", [
    ({"MUNIT_FUSED": "1"}, {}), ({}, {"fused": 1}),
    ({"MUNIT_INT8_DIS": "0"}, {}), ({"MUNIT_INT8_DIS": "1"}, {}),
    ({}, {"remat": False}),
    ({}, {"remat": "none"}), ({"MUNIT_SEG_REMAT": "0"}, {}),
    ({"MUNIT_WIDE": "1"}, {}), ({}, {"wide": 2, "gen_state": 0}),
    ({"MUNIT_PALLAS": "1", "MUNIT_PACKED_TAIL": "0",
      "MUNIT_CLS_STACKED": "1", "MUNIT_COMPILER_OPTS": "a=b"}, {})])
def test_default_switches_are_taken(monkeypatch, env, over):
    """Their defaults, ``MUNIT_INT8_DIS=1`` (int8 fakes for D, read as
    JAX reads it) and wide 2 with gen_state 0 (which JAX runs narrow) build
    a trainer; the layout-only switches, whose plain math the port
    computes, are not read."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tr = MUNITTrainer(validate(hd_raw(**over)), "cpu")
    assert tr.wide in (0, 1)
    assert tr.int8_dis_fakes == (env.get("MUNIT_INT8_DIS") == "1")


# ------------------------------------- classifier_sr with gen_state: 0

def composed_classifier_sr_step(jtr, gen0, gen_params, x_a, x_b,
                                domain_synth, lamb):
    """``_classifier_sr_step_impl`` with each domain's own encoder: the
    loss, the classifiers' new params, their new statistics and the new
    optimizer state."""
    state = jtr.state
    c_a = jax.lax.stop_gradient(gen0.encode(gen_params, x_a, 1)[0])
    c_b = jax.lax.stop_gradient(gen0.encode(gen_params, x_b, 2)[0])

    def loss_fn(params):
        out_a, sa = jtr._dann_apply(params["a"],
                                    state["classifier_sr_a_stats"], c_a)
        out_b, sb = jtr._dann_apply(params["b"],
                                    state["classifier_sr_b_stats"], c_b)
        loss = lamb * jlosses.classifier_sr_loss(
            out_a, out_b, domain_synth=domain_synth, fool=False)
        return loss, (sa, sb, loss)

    params = {"a": state["classifier_sr_a"], "b": state["classifier_sr_b"]}
    grads, (sa, sb, loss) = jax.grad(loss_fn, has_aux=True)(params)
    new_params, new_opt = jtr._opt_update(
        grads, state["classif_sr_opt"], params, jtr._lr(), jtr._phase())
    return loss, new_params, (sa, sb), new_opt


@pytest.fixture(scope="module")
def gen_state0(hd_runs):
    """The HD JAX trainer's classifiers (no step has moved them) and a JAX
    gen_state 0 generator (two AdaINGen) at the same widths, seeded."""
    jtr = hd_runs["jtr"]
    conf0 = jvalidate(hd_raw(gen_state=0, guided=0))
    gen0 = JGenBundle(conf0)
    params = gen0.init(jax.random.PRNGKey(6),
                       jnp.zeros((1, CROP, CROP, 3), jnp.float32))
    return jtr, gen0, params


@pytest.mark.parametrize("domain_synth", [False, True])
def test_classifier_sr_step_on_gen_state0_matches_composed_jax(gen_state0,
                                                               domain_synth):
    jtr, gen0, params = gen_state0
    x_a, x_b, _, _ = hd_batch(4)
    lamb = 1.0
    jtr.iterations = 14
    loss, new_params, (sa, sb), _ = composed_classifier_sr_step(
        jtr, gen0, params, jnp.asarray(x_a), jnp.asarray(x_b),
        domain_synth, lamb)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        tr = MUNITTrainer(validate(hd_raw(gen_state=0, guided=0)), "cpu")
    assert tr.wide == 0 and tr.gen.gen_state == 0
    tr.gen.load_state_dict(from_jax_params(jax.tree.map(np.array, params)))
    state = jax.tree.map(np.array, jtr.state)
    for d in ("a", "b"):
        getattr(tr, f"classifier_sr_{d}").load_state_dict(from_jax_classifier(
            state[f"classifier_sr_{d}"], state[f"classifier_sr_{d}_stats"]))
    before = net_groups({"gen": {}, "dis_a": {}, "dis_b": {},
                         "classifier_sr_a": tr.classifier_sr_a.state_dict(),
                         "classifier_sr_b": tr.classifier_sr_b.state_dict()})
    tr.iterations = 14
    got = tr.domain_classifier_sr_update(torch.from_numpy(x_a),
                                         torch.from_numpy(x_b),
                                         domain_synth=domain_synth,
                                         lamb=lamb)
    np.testing.assert_allclose(float(got["loss_classifier_sr"]), float(loss),
                               rtol=1e-5)
    want = {f"{d}.{k}": v.numpy() for d, p, s in
            (("a", new_params["a"], sa), ("b", new_params["b"], sb))
            for k, v in from_jax_classifier(jax.tree.map(np.array, p),
                                            jax.tree.map(np.array, s)).items()}
    got_sd = {f"{d}.{k}": v.detach().numpy().copy() for d in ("a", "b")
              for k, v in getattr(tr, f"classifier_sr_{d}")
              .state_dict().items()}
    e = update_errors({"classifier": before["classifier"]},
                      {"classifier": want}, {"classifier": got_sd}, LR,
                      {})["classifier"]
    check_update(e, True, f"classifier_sr domain_synth={domain_synth}")
    for k, v in want.items():
        if "running" in k:
            assert not np.array_equal(v, before["classifier"][k]), k
