"""The port's training step (munit_tpu_torch.train.trainer) against the JAX
package's ``MUNITTrainer``, on one JAX trainer at ``small_train_spec()``
(small widths, 32 px, batch 2, ``recon_mask: 1`` with seeded masks,
``adv_lambda: 6``, ``dfeat_lambda: 1``, ``semantic_w: 0``) and
``train_batch(1)``; the port starts from its seeded state, carried by
``munit_tpu_torch.io.weights``.

f32 parity:
- The gradients of one fused dis+gen step agree leaf by leaf within 2e-4
  of each leaf's largest |g| (float32 sums in another order through ~40
  layers forward and back, and JAX's space-to-depth and packed rewrites
  against the port's plain convolutions). Every generator parameter gets a
  gradient. The port's own fused step equals its unfused pair, as
  tests/test_fused_step.py pins for JAX. The options the port lacks raise.

The bf16 training mode (``ops.set_conv_compute(torch.bfloat16)`` with bf16
images) against the JAX package's (``set_conv_compute(bfloat16)``,
bench.py's production numerics):
- The conv contract: bf16 operands, f32 accumulation, the output cast back
  to x's type, the bias added in that type; within one bf16 ulp of
  ``munit_tpu.core.ops.conv2d`` (the two accumulate in other orders).
- The dtype map: the type at every module boundary of a training step
  (codes, the MLP's AdaIN parameters, decodes, discriminator outputs,
  classifier logits, segmenter input and logits, every loss) equals JAX's,
  read with ``jax.eval_shape``.
- One fused step's gradients (``dis_gen_grads``) with bf16 images. Every
  gradient is f32. In aggregate the port's bf16 gradients are nearer JAX's
  bf16 gradients than the f32 gradients are: the port reproduces the mode
  and does not merely land near f32. The f32 gradients are the port's, of
  the same state and batch, which the f32 test above holds to JAX's (1.8e-5
  relative L2 on the worst leaf). The discriminators' leaves are within
  5e-2 relative L2 of JAX's. The generator's are not held to 5e-2: bf16
  rounding moves ReLU masks and L1 signs, and the two packages round in
  other summation orders (JAX's bf16 and f32 gradients differ by 19 %
  relative L2 on the median generator leaf here, and the port's float64
  gradients move 9 % under a 1e-3 relative input perturbation), so each
  generator leaf is held within 1.5 times the mode's own error on that
  leaf, the f32-to-JAX-bf16 distance.

``python -m tests.test_torch_trainer`` prints the bf16 readings: each
leaf's errors (JAX's own f32 gradients beside the port's), the aggregates,
and the float64 sensitivity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from munit_tpu.config import validate as jvalidate
from munit_tpu.core import ops as jops
from munit_tpu.losses import losses as jlosses
from munit_tpu.nn.resnet import seg_preprocess as jseg_preprocess
from munit_tpu.train import MUNITTrainer as JTrainer
from munit_tpu_torch.config import validate
from munit_tpu_torch.core import ops
from munit_tpu_torch.io.weights import from_jax_dis, from_jax_params
from munit_tpu_torch.losses import losses
from munit_tpu_torch.nn.blocks import ConvBlock
from munit_tpu_torch.nn.resnet import seg_preprocess
from munit_tpu_torch.train.trainer import MUNITTrainer
from tests.torch_port_util import (load_jax_state, one_torch_thread,  # noqa: F401
                                   small_train_spec, train_batch)

GRAD_TOL = 2e-4
DIS_TOL = 5e-2
GEN_OVER_MODE = 1.5


@pytest.fixture(autouse=True)
def port_parity_mode():
    """The port's conv compute is process-global; tests/conftest.py resets
    only JAX's."""
    yield
    ops.set_conv_compute(None)


def _jax_bf16():
    jops.set_conv_compute(jnp.bfloat16, lax.Precision.DEFAULT)


def _jax_parity():
    jops.set_conv_compute(None, lax.Precision.HIGHEST)


# ------------------------------------------------------------------- conv


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_contract_matches_jax(x_dtype, stride):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 9, 16).astype(np.float32)
    k = (rng.randn(3, 3, 16, 24) * 0.1).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    _jax_bf16()
    try:
        want = jops.conv2d(jx, jnp.asarray(k), jnp.asarray(bias), stride)
    finally:
        _jax_parity()
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    w = torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy())
    b = torch.from_numpy(bias)
    ops.set_conv_compute(torch.bfloat16)
    got = ops.conv2d(tx, w, b, stride)
    assert ops.conv_compute_dtype() is torch.bfloat16
    ops.set_conv_compute(None)
    f32 = ops.conv2d(tx.float(), w, b, stride)
    assert str(got.dtype).split(".")[1] == x_dtype == str(want.dtype)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-8,
                               atol=2**-8 * np.abs(want).max())
    # the operands really were rounded to bf16
    assert (got.float() - f32).abs().max().item() > 1e-4


def test_conv_compute_rejects_other_types():
    with pytest.raises(ValueError, match="bfloat16"):
        ops.set_conv_compute(torch.float16)


# ----------------------------------------------------------- one trainer


def _jax_grads(jtr, x_a, x_b, m_a, m_b):
    """A JAX trainer's fused-step gradients in the port's names."""
    gd, gg = jtr.dis_gen_grads(x_a, x_b, m_a, m_b)
    g = {f"{d}.{k}": v.numpy() for d in ("a", "b")
         for k, v in from_jax_dis(gd[d]).items()}
    g.update({k: v.numpy() for k, v in from_jax_params(gg).items()})
    return g


@pytest.fixture(scope="module")
def jax_run():
    """One JAX trainer: its seeded state, its fused step's gradients in
    bf16 (bf16 images and conv operands), the boundary types of its bf16
    mode from jax.eval_shape, and its fused step's gradients in f32
    parity."""
    jtr = JTrainer(jvalidate(small_train_spec()), jax.random.PRNGKey(0))
    batch = train_batch(1)
    x_a, x_b, m_a, m_b = map(jnp.asarray, batch)
    f32 = _jax_grads(jtr, x_a, x_b, m_a, m_b)
    x_a, x_b = x_a.astype(jnp.bfloat16), x_b.astype(jnp.bfloat16)
    _jax_bf16()
    try:
        grads = _jax_grads(jtr, x_a, x_b, m_a, m_b)
        dtypes = _jax_dtype_map(jtr, x_a, m_a)
    finally:
        _jax_parity()
    return jtr, batch, grads, dtypes, f32


@pytest.fixture(scope="module")
def jax_grads(jax_run):
    """The JAX trainer's seeded state, the batch and its f32 gradients."""
    jtr, batch, _, _, f32 = jax_run
    return jtr.state, batch, f32


# ------------------------------------------------------- f32 parity step


def _port(state):
    tr = MUNITTrainer(validate(small_train_spec()), "cpu")
    load_jax_state(tr, state)
    return tr


def _removed_by_a_norm(tr):
    """Names of the conv biases that an instance norm or AdaIN removes."""
    return {f"{n}.conv.bias" for n, m in tr.gen.module.named_modules()
            if isinstance(m, ConvBlock) and m.norm_type in ("in", "adain")}


def test_dis_gen_grads_match_jax(jax_grads):
    state, batch, want = jax_grads
    tr = _port(state)
    grads_d, grads_g = tr.dis_gen_grads(*map(torch.from_numpy, batch))
    got = {**grads_d, **grads_g}
    assert set(got) == set(want)
    zero = _removed_by_a_norm(tr)
    net_scale = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        g = got[k].numpy()
        if k in zero:
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-6 * net_scale, k
            continue
        scale = np.abs(w).max()
        assert scale > 0, f"{k}: JAX gradient is all zero"
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=k)


def test_every_generator_parameter_gets_a_gradient(jax_grads):
    """The norms are autograd Functions: the gradient reaches every
    parameter upstream of them, the content encoders' first convs too."""
    tr = _port(jax_grads[0])
    _, grads_g = tr.dis_gen_grads(*map(torch.from_numpy, jax_grads[1]))
    assert set(grads_g) == set(tr.gen_params())
    scale = max(g.abs().max().item() for g in grads_g.values())
    zero = _removed_by_a_norm(tr)
    assert len(zero) == 2 * (3 + 4) + 2 * 4     # small gen: n_res 2
    dead = [k for k, g in grads_g.items()
            if k not in zero and not g.abs().max().item() > 1e-5 * scale]
    assert not dead, dead


def test_fused_step_matches_unfused_pair(jax_grads):
    """dis_gen_update ≡ dis_update then gen_update at the same iteration."""
    state, batch, _ = jax_grads
    x_a, x_b, m_a, m_b = map(torch.from_numpy, batch)
    t1, t2 = _port(state), _port(state)
    for it in range(2):
        t1.iterations = t2.iterations = it
        m_sep = dict(t1.dis_update(x_a, x_b))
        m_sep.update(t1.gen_update(x_a, x_b, m_a, m_b))
        m_fused = t2.dis_gen_update(x_a, x_b, m_a, m_b)
        for k in ("loss_dis_total", "loss_gen_total", "loss_gen_adv_a",
                  "loss_gen_cycrecon_x_a", "loss_classifier_adv_sr"):
            np.testing.assert_allclose(float(m_fused[k]), float(m_sep[k]),
                                       rtol=1e-5, err_msg=f"{k} it={it}")
    for name in ("gen_params", "dis_params"):
        p1, p2 = getattr(t1, name)(), getattr(t2, name)()
        for k in p1:
            np.testing.assert_allclose(p1[k].detach().numpy(),
                                       p2[k].detach().numpy(), rtol=1e-4,
                                       atol=2.5e-4, err_msg=k)


@pytest.mark.parametrize("key,value", [
    ("guided", 0), ("grad_accum", 2),
    ("adaptation", {"adv_lambda": 6, "dfeat_lambda": 1, "sem_seg_lambda": 1}),
    ("vgg_w", 1), ("domain_adv_w", 1), ("recon_synth_w", 1)])
def test_unported_options_raise(key, value):
    """The options refused until they were ported now build their net and
    step: the seg head, the DANN and the synthetic-pair loss (ROADMAP item
    11), random styles (guided: 0, item 9), the VGG perceptual loss
    (vgg_w, item 12) and gradient accumulation (grad_accum, item 13, with
    the warning of its classifier term). The switches still refused are
    in tests/test_torch_hd.py."""
    conf = validate(small_train_spec(**{key: value}))
    if key == "grad_accum":
        with pytest.warns(UserWarning, match="chunk statistics"):
            tr = MUNITTrainer(conf, "cpu")
        assert tr.grad_accum == 2
    else:
        tr = MUNITTrainer(conf, "cpu")
    tr.init(torch.Generator().manual_seed(0))
    x_a, x_b, m_a, m_b = map(torch.from_numpy, train_batch(1))
    if key == "adaptation":
        assert "seg_head" in tr.state_dict()["nets"]
        labels = torch.randint(0, 10, x_a.shape[:3],
                               generator=torch.Generator().manual_seed(1))
        loss = tr.segmentation_head_update(x_a, x_b, labels, labels)[
            "loss_semantic_head"]
    elif key == "domain_adv_w":
        assert "dann" in tr.state_dict()["nets"]
        loss = tr.domain_classifier_update(x_a, x_b)["domain_class_loss"]
        assert tr.dis_gen_update(x_a, x_b, m_a, m_b)[
            "domain_adv_loss_gen"] > 0
    elif key == "guided":
        assert not tr.guided
        loss = tr.dis_gen_update(x_a, x_b, m_a, m_b)["loss_gen_recon_s_a"]
    elif key == "vgg_w":
        assert tr.vgg is not None
        loss = tr.dis_gen_update(x_a, x_b, m_a, m_b)["loss_gen_vgg_a"]
    else:
        loss = tr.dis_gen_update(x_a, x_a.clone(), m_a, m_a, synth=True)[
            "loss_gen_recon_synth"]
    assert torch.isfinite(loss) and loss > 0


def test_collapsed_discriminator_pyramid_raises():
    with pytest.raises(ValueError, match="pyramid"):
        MUNITTrainer(validate(small_train_spec(crop_image_height=8,
                                               crop_image_width=8)), "cpu")


# -------------------------------------------------------- bf16 dtype map


def _name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _jax_dtype_map(jtr, x, mask):
    """Boundary types of one bf16 training step, traced abstractly."""
    st, gen = jtr.state, jtr.gen
    shape = jax.eval_shape
    s = shape(lambda p, x: gen.style_encode(p, x), st["gen"], x)
    c = shape(lambda p, x: gen.content_encode_pair(p, x, x, False)[0],
              st["gen"], x)
    adain = shape(lambda p, s: gen._mlp_def.apply({"params": p}, s),
                  st["gen"]["mlp1"], s)
    y = shape(lambda p, c, s: gen.decode_domain(p, 1, c, s), st["gen"], c, s)
    dis = shape(lambda p, x: jtr._dis_apply(p, x), st["dis_a"], y)
    cls = shape(lambda p, s, c: jtr._dann_apply(p, s, c)[0],
                st["classifier_sr_a"], st["classifier_sr_a_stats"], c)
    seg_in = shape(jseg_preprocess, y)
    seg_vars = shape(jtr.seg_model_def.init, jax.random.PRNGKey(1), seg_in)
    logits = shape(jtr.seg_model_def.apply, seg_vars, seg_in)
    labels = jax.ShapeDtypeStruct(logits.shape[:3], jnp.int32)
    m = jax.ShapeDtypeStruct(logits.shape[:3], jnp.float32)
    return {
        "style": s, "content": c, "adain_params": adain, "decode": y,
        "dis_outputs": dis[0], "classifier_logits": cls,
        "segmenter_input": seg_in, "segmenter_logits": logits,
        "loss_recon": shape(jlosses.recon_l1, y, x),
        "loss_recon_masked": shape(jlosses.recon_l1_masked, y, x, mask),
        "loss_recon_code": shape(jlosses.recon_l1, s, s),
        "loss_dis_gan": shape(lambda a, b: jlosses.dis_gan_loss(a, b),
                              dis, dis),
        "loss_gen_gan": shape(jlosses.gen_gan_loss, dis),
        "loss_classifier_sr": shape(
            lambda a, b: jlosses.classifier_sr_loss(a, b, False, True),
            cls, cls),
        "loss_cross_entropy": shape(jlosses.cross_entropy_loss, logits,
                                    labels),
        "loss_semantic_masked": shape(
            lambda lg, t, m: jlosses.semantic_seg_loss_masked(lg, t, m, 19),
            logits, labels, m),
    }


def _port_dtype_map(tr, x, mask):
    gen = tr.gen
    with torch.no_grad():
        s = gen.encode_style(x)
        c = gen.encode_content(x, 1)
        adain = gen.module.mlp1(s)
        y = gen.decode(c, s, 1)
        dis = tr.dis_a(y)
        cls = tr.classifier_sr_a(c)
        seg_in = seg_preprocess(y)
        logits = tr.segmenter(seg_in)
        labels = logits.argmax(-1)
        m = torch.zeros(labels.shape)
        return {
            "style": s, "content": c, "adain_params": adain, "decode": y,
            "dis_outputs": dis[0], "classifier_logits": cls,
            "segmenter_input": seg_in, "segmenter_logits": logits,
            "loss_recon": losses.recon_l1(y, x),
            "loss_recon_masked": losses.recon_l1_masked(y, x, mask),
            "loss_recon_code": losses.recon_l1(s, s),
            "loss_dis_gan": losses.dis_gan_loss(dis, dis),
            "loss_gen_gan": losses.gen_gan_loss(dis),
            "loss_classifier_sr": losses.classifier_sr_loss(cls, cls, False,
                                                            True),
            "loss_cross_entropy": losses.cross_entropy_loss(logits, labels),
            "loss_semantic_masked": losses.semantic_seg_loss_masked(
                logits, labels, m, 19),
        }


def test_dtype_map_matches_jax(jax_run):
    batch, want = jax_run[1], jax_run[3]
    tr = MUNITTrainer(validate(small_train_spec(semantic_w=3)), "cpu")
    tr.init(torch.Generator().manual_seed(0))
    ops.set_conv_compute(torch.bfloat16)
    got = _port_dtype_map(tr, torch.from_numpy(batch[0]).bfloat16(),
                          torch.from_numpy(batch[2]))
    got = {k: _name(v.dtype) for k, v in got.items()}
    want = {k: _name(v.dtype) for k, v in want.items()}
    assert got == want
    # the mode's shape: bf16 activations, f32 where JAX promotes
    assert want["decode"] == "bfloat16" and want["adain_params"] == "float32"
    assert want["segmenter_input"] == want["classifier_logits"] == "float32"


# -------------------------------------------------------------- gradients


@pytest.fixture(scope="module")
def bf16_grads(jax_run):
    """The port's fused-step gradients from the JAX trainer's state, in
    bf16 and in f32, beside JAX's bf16 ones; and the conv biases a norm
    removes (exact gradient 0, left out of the relative errors)."""
    jtr, batch, jax_bf16 = jax_run[:3]
    tr = MUNITTrainer(validate(small_train_spec()), "cpu")
    load_jax_state(tr, jtr.state)
    x_a, x_b, m_a, m_b = map(torch.from_numpy, batch)
    ops.set_conv_compute(torch.bfloat16)
    try:
        gd, gg = tr.dis_gen_grads(x_a.bfloat16(), x_b.bfloat16(), m_a, m_b)
    finally:
        ops.set_conv_compute(None)
    got = {**gd, **gg}
    fd, fg = tr.dis_gen_grads(x_a, x_b, m_a, m_b)
    f32 = {k: v.numpy() for k, v in {**fd, **fg}.items()}
    zero = {f"{n}.conv.bias" for n, m in tr.gen.module.named_modules()
            if isinstance(m, ConvBlock) and m.norm_type in ("in", "adain")}
    return got, {"bf16": jax_bf16, "f32": f32}, zero


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_grads_are_f32_and_nearer_jax_bf16_than_f32(bf16_grads):
    got, want, zero = bf16_grads
    assert set(got) == set(want["bf16"])
    assert all(v.dtype == torch.float32 for v in got.values())
    keys = [k for k in got if k not in zero]
    jb = {k: want["bf16"][k] for k in keys}

    def dist(g):
        num = sum(float(np.square(g[k] - jb[k]).sum()) for k in keys)
        return (num / sum(float(np.square(jb[k]).sum()) for k in keys)) ** 0.5

    port = dist({k: got[k].numpy() for k in keys})
    f32 = dist(want["f32"])
    assert port < f32, (port, f32)


def test_bf16_dis_grads_within_5e2_of_jax_bf16_per_leaf(bf16_grads):
    got, want, _ = bf16_grads
    dis = [k for k in got if k.startswith(("a.", "b."))]
    # two discriminators of 2 scales, each 3 conv blocks and a logit conv
    assert len(dis) == 2 * 2 * 4 * 2
    for k in dis:
        assert _rel(got[k].numpy(), want["bf16"][k]) <= DIS_TOL, k


def test_bf16_gen_grads_within_the_modes_own_error_per_leaf(bf16_grads):
    got, want, zero = bf16_grads
    gen = [k for k in got if not k.startswith(("a.", "b.")) and k not in zero]
    for k in gen:
        own = _rel(want["f32"][k], want["bf16"][k])
        assert _rel(got[k].numpy(), want["bf16"][k]) <= GEN_OVER_MODE * own, k


# ------------------------------------------------------------- readings


def _sensitivity(eps_list=(1e-7, 1e-5, 1e-3)):
    """Median and worst relative L2 change of the port's float64 generator
    gradients (its own seeded init) when x_a moves by a relative eps."""
    tr = MUNITTrainer(validate(small_train_spec()), "cpu")
    tr.init(torch.Generator().manual_seed(0))
    for net in (tr.gen.module, tr.dis_a, tr.dis_b, tr.classifier_sr_a,
                tr.classifier_sr_b):
        net.double()
    x_a, x_b, m_a, m_b = (torch.from_numpy(a).double()
                          for a in train_batch(1))
    zero = {f"{n}.conv.bias" for n, m in tr.gen.module.named_modules()
            if isinstance(m, ConvBlock) and m.norm_type in ("in", "adain")}

    def grads(xa):
        g = tr.dis_gen_grads(xa, x_b, m_a, m_b)[1]
        return {k: v.numpy() for k, v in g.items() if k not in zero}

    base = grads(x_a)
    noise = torch.from_numpy(np.random.RandomState(5).randn(*x_a.shape))
    for eps in eps_list:
        moved = grads(x_a * (1 + eps * noise))
        e = [_rel(moved[k], base[k]) for k in base]
        print(f"float64 sensitivity eps {eps:g}: median {np.median(e):.4g}, "
              f"worst {max(e):.4g}")


def main():
    one = one_torch_thread.__wrapped__()
    next(one)
    run = jax_run.__wrapped__()
    got, want, zero = bf16_grads.__wrapped__(run)
    port_f32 = want["f32"]
    want["f32"] = run[4]
    print("port f32 vs JAX f32, worst leaf relative L2: "
          f"{max(_rel(port_f32[k], want['f32'][k]) for k in got if k not in zero):.3g}")
    scale = max(np.abs(w).max() for w in want["bf16"].values())
    print("norm-removed biases, largest |g| over the net's: port "
          f"{max(got[k].abs().max().item() for k in zero) / scale:.3g}, "
          f"JAX {max(np.abs(want['bf16'][k]).max() for k in zero) / scale:.3g}")
    rows = sorted(((_rel(got[k].numpy(), want["bf16"][k]),
                    _rel(want["f32"][k], want["bf16"][k]), k)
                   for k in got if k not in zero), reverse=True)
    keys = [k for k in got if k not in zero]
    den = sum(float(np.square(want["bf16"][k]).sum()) for k in keys)
    for name, g in (("port bf16", {k: got[k].numpy() for k in keys}),
                    ("JAX f32", want["f32"]), ("port f32", port_f32)):
        num = sum(float(np.square(g[k] - want["bf16"][k]).sum())
                  for k in keys)
        print(f"aggregate relative L2, {name} vs JAX bf16: "
              f"{(num / den) ** 0.5:.4g}")
    print("port bf16 vs JAX bf16 | JAX f32 vs JAX bf16 | leaf")
    for r in rows:
        print(f"{r[0]:.4f} {r[1]:.4f} {r[2]}")
    for part, pick in (("discriminators", lambda k: k.startswith(("a.", "b."))),
                       ("generator", lambda k: not k.startswith(("a.", "b.")))):
        sel = [r for r in rows if pick(r[2])]
        print(f"{part}: port vs JAX bf16 median {np.median([r[0] for r in sel]):.4g} "
              f"worst {sel[0][0]:.4g}; JAX f32 vs bf16 median "
              f"{np.median([r[1] for r in sel]):.4g}; worst ratio "
              f"{max(r[0] / r[1] for r in sel):.3g}")
    _sensitivity()


if __name__ == "__main__":
    main()
