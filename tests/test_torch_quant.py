"""The port's int8 inference tier (``core/ops.py::conv_quant``) against the
JAX package's, on the CPU.

- One conv in each mode against JAX's ``conv_quant``, jitted as the JAX
  package runs it: the quantized operands and the int32 sums equal (the
  output within the rounding of its scale-back multiply);
  exact on the int8 grid (``tests/test_quant.py:25``); the shape rule on
  the same padded shapes; record → static alignment, a missing site's
  error, the scope restored (and per thread).
- The generator with ``all_convs`` and ``translate --quant int8`` against
  the JAX package's plain layout: the JAX side runs with ``MUNIT_S2D``,
  ``MUNIT_PACKED_TAIL``, ``MUNIT_PACKED_UP`` and ``MUNIT_PACKED_STEM`` at 0,
  because JAX quantizes its space-to-depth and lane-packed convs per packed
  channel (``tests/test_quant.py:12-13``), so only its plain layout has the
  port's conv sites. Each int8 site, given JAX's input, gives JAX's
  output. Whole forwards differ: the two float32 forwards differ in
  their last bits, and a difference can move an operand across a rounding
  boundary of its int8 grid, one step of its scale, which later layers
  carry; the port's int8 result is held to JAX's within a share of int8's
  own error against float32 (``INT8_SHARE`` where the shape rule picks the
  sites; closer than either to float32 with every conv in int8).
- ``MUNIT_INT8_DIS=1``: the port's dis step against JAX's on the same state
  (its res blocks at 128 channels, so the shape rule quantizes the fakes'
  convs), and the switch in each step's graph key.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax import lax
from PIL import Image

from munit_tpu.cli import translate as jax_translate
from munit_tpu.config import validate as jvalidate
from munit_tpu.core import ops as jops
from munit_tpu.io.torch_import import convert_gen_state_dict
from munit_tpu.train import GenBundle as JGenBundle
from munit_tpu.train import MUNITTrainer as JTrainer
from munit_tpu_torch.cli import translate
from munit_tpu_torch.config import validate
from munit_tpu_torch.core import ops
from munit_tpu_torch.nn.generator import GenBundle
from munit_tpu_torch.train.trainer import MUNITTrainer
from tests.torch_port_util import (SMALL_DIS, load_jax_state,  # noqa: F401
                                   one_torch_thread, ref_layout_weights,
                                   small_train_spec, train_batch)

PLAIN_LAYOUT = ("MUNIT_S2D", "MUNIT_PACKED_TAIL", "MUNIT_PACKED_UP",
                "MUNIT_PACKED_STEM")
# res blocks at 128 channels: dim 32 and two downsamplings
GEN = dict(dim=32, mlp_dim=32, style_dim=8, activ="relu", n_downsample=2,
           n_res=2, pad_type="reflect")
# port int8 against JAX int8: their mean |difference| at most this share
# of int8's own mean error against float32 (operands that cross a rounding
# boundary, see above)
INT8_SHARE = 0.5


@pytest.fixture
def plain_layout(monkeypatch):
    for k in PLAIN_LAYOUT:
        monkeypatch.setenv(k, "0")


def _conv_case(seed, b=2, h=10, w=12, cin=8, cout=16, k=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    kern = (rng.randn(k, k, cin, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return x, kern, bias


def _oihw(kern):
    return torch.from_numpy(kern).permute(3, 2, 0, 1).contiguous()


@jax.jit
def _jax_int8(x, kern):
    """JAX's dynamic-mode operands and int32 sums (``_conv2d_int8``'s ops,
    jitted as the package runs them)."""
    sx = jnp.maximum(jnp.max(jnp.abs(x)), 1e-6) / 127.0
    sw = jnp.maximum(jnp.max(jnp.abs(kern), axis=(0, 1, 2)), 1e-8) / 127.0
    xq = jnp.clip(jnp.round(x / sx), -127, 127).astype(jnp.int8)
    kq = jnp.clip(jnp.round(kern / sw), -127, 127).astype(jnp.int8)
    return xq, kq, sx


def _jax_sums(xq, kq, stride):
    return np.asarray(lax.conv_general_dilated(
        xq, kq, (stride, stride), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("stride,k,cin,cout", [(1, 3, 8, 16), (2, 4, 16, 8),
                                              (1, 7, 3, 5), (1, 3, 128, 128)])
def test_dynamic_conv_sums_and_output_match_jax(stride, k, cin, cout):
    """The operands and the int32 sums equal JAX's jitted ones; the output
    within the scale-back multiply's rounding."""
    x, kern, bias = _conv_case(stride + k + cin, cin=cin, cout=cout, k=k)

    def jconv(x, kern, bias):
        with jops.conv_quant(all_convs=True):
            return jops.conv2d(x, kern, bias, stride)

    want = np.asarray(jax.jit(jconv)(jnp.asarray(x), jnp.asarray(kern),
                                     jnp.asarray(bias)))
    with ops.conv_quant(all_convs=True):
        got = ops.conv2d(torch.from_numpy(x), _oihw(kern),
                         torch.from_numpy(bias), stride)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    jxq, jkq, jsx = _jax_int8(jnp.asarray(x), jnp.asarray(kern))
    w, xt = _oihw(kern), torch.from_numpy(x)
    sx = xt.abs().amax().clamp(min=1e-6) * ops.INV127
    assert float(sx) == float(jsx)
    xq = ops.quantize(xt, sx)
    wq = ops.quantize(w, ops.weight_scales(w)[:, None, None, None])
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(wq.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jkq))
    sums = ops.int8_conv_sums(xq, wq, stride)
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.numpy(), _jax_sums(jxq, jkq, stride))


def test_int8_exact_on_grid():
    """Operands already on their int8 grids: the product is the float32
    conv's (test_quant.py:25), and JAX's."""
    rng = np.random.RandomState(0)
    b, h, w, cin, cout, k = 2, 10, 10, 8, 8, 3
    sx = np.float32(0.037)
    sw = (0.002 + 0.01 * rng.rand(cout)).astype(np.float32)
    xi = rng.randint(-127, 128, size=(b, h, w, cin)).astype(np.float32)
    xi.flat[0] = 127.0
    ki = rng.randint(-127, 128, size=(k, k, cin, cout)).astype(np.float32)
    ki[0, 0, 0, :] = 127.0
    x, kern = xi * sx, ki * sw
    ref = ops.conv2d(torch.from_numpy(x), _oihw(kern))
    with ops.conv_quant(all_convs=True):
        got = ops.conv2d(torch.from_numpy(x), _oihw(kern))
    def jconv(x, kern):
        with jops.conv_quant(all_convs=True):
            return jops.conv2d(x, kern, None, 1)

    want = np.asarray(jax.jit(jconv)(jnp.asarray(x), jnp.asarray(kern)))
    d = float((got - ref).abs().max())
    assert d <= 1e-4 * max(float(ref.abs().max()), 1.0), d
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


SHAPES = [((1, 66, 66, 256), (3, 3, 256, 256), 1),    # config_256 res block
          ((1, 132, 132, 256), (5, 5, 256, 128), 1),  # its first up conv
          ((1, 260, 260, 128), (5, 5, 128, 64), 1),   # its second
          ((1, 262, 262, 3), (7, 7, 3, 64), 1),       # the stem
          ((1, 130, 130, 128), (4, 4, 128, 256), 2),  # a down conv
          ((1, 160, 160, 128), (3, 3, 128, 128), 1),
          ((1, 161, 160, 128), (3, 3, 128, 128), 1),
          ((1, 8, 8, 127), (1, 1, 127, 128), 1)]


def test_shape_rule_matches_jax():
    for x_shape, k_shape, stride in SHAPES:
        assert ops._quant_worthwhile(x_shape, k_shape, stride) == \
            jops._quant_worthwhile(x_shape, k_shape, stride), x_shape


def test_shape_rule_reads_the_padded_input(monkeypatch):
    """``conv2d(x, w, padding=p)`` decides on the padded shape, as JAX's
    conv of an explicitly padded input: 158² + 2 = 160² is quantized,
    159² + 2 = 161² is not."""
    seen = []

    def stub(x, w, stride, dilation):
        seen.append(tuple(x.shape))
        return torch.zeros(x.shape[0], x.shape[1] - 2, x.shape[2] - 2,
                           w.shape[0])

    monkeypatch.setattr(ops, "_conv2d_int8", stub)
    w = torch.zeros(128, 128, 3, 3)
    with ops.conv_quant():
        ops.conv2d(torch.zeros(1, 158, 158, 128), w, padding=1)
        y = ops.conv2d(torch.zeros(1, 159, 159, 128), w, padding=1)
    assert seen == [(1, 160, 160, 128)] and y.shape == (1, 159, 159, 128)


def _chain(conv2d, pad, norm, relu, x, k1, k2):
    y = conv2d(pad(x, 1, "reflect"), k1)
    return conv2d(pad(relu(norm(y)), 1, "reflect"), k2)


def test_record_then_static_against_jax():
    """Record mode runs full precision and gives every site's max|x|, as
    JAX's; static mode on those scales gives the first site dynamic mode's
    scale (its output bit for bit) and stays close to JAX's static run."""
    rng = np.random.RandomState(5)
    x = rng.randn(1, 12, 12, 4).astype(np.float32)
    k1 = (rng.randn(3, 3, 4, 8) * 0.2).astype(np.float32)
    k2 = (rng.randn(3, 3, 8, 3) * 0.2).astype(np.float32)

    def port(xx):
        return _chain(lambda a, k: ops.conv2d(a, _oihw(k)), ops.pad2d,
                      ops.instance_norm, torch.relu, xx, k1, k2)

    def jchain(xx):
        return _chain(lambda a, k: jops.conv2d(a, jnp.asarray(k), None, 1),
                      jops.pad2d, jops.instance_norm, jax.nn.relu, xx, k1, k2)

    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    rec, jrec = [], []
    with ops.conv_quant(record=rec, all_convs=True):
        ref = port(xt)
    with jops.conv_quant(record=jrec, all_convs=True):
        jchain(xj)
    assert len(rec) == len(jrec) == 2
    np.testing.assert_allclose([float(r) for r in rec],
                               [float(r) for r in jrec], rtol=1e-6)
    assert torch.equal(ref, port(xt))   # record mode: full precision
    scales = [float(r) for r in rec]
    with ops.conv_quant(scales=scales, all_convs=True):
        first_static = ops.conv2d(ops.pad2d(xt, 1, "reflect"), _oihw(k1))
    with ops.conv_quant(scales=scales, all_convs=True):
        got = port(xt)
    with ops.conv_quant(all_convs=True):
        first_dyn = ops.conv2d(ops.pad2d(xt, 1, "reflect"), _oihw(k1))
    assert torch.equal(first_static, first_dyn)
    with jops.conv_quant(scales=scales, all_convs=True):
        want = np.asarray(jchain(xj))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert float((got - ref).abs().mean()) < 0.05


def test_static_site_without_scale_raises():
    x = torch.randn(1, 8, 8, 4)
    k = torch.randn(4, 4, 3, 3) * 0.1
    with pytest.raises(ValueError, match="no calibrated scale"):
        with ops.conv_quant(scales=[1.0], all_convs=True):
            ops.conv2d(ops.conv2d(x, k), k)


def test_static_sites_left_in_float_keep_their_index():
    """A site the shape rule leaves in float32 still takes its index: the
    second conv uses the second scale."""
    x = torch.randn(1, 6, 6, 4)
    small, big = torch.randn(4, 4, 1, 1), torch.randn(128, 128, 1, 1)
    y = torch.randn(1, 6, 6, 128)
    with ops.conv_quant(scales=[5.0, 2.0]):
        ops.conv2d(x, small)              # not worthwhile: index 0 skipped
        got = ops.conv2d(y, big)
    with ops.conv_quant(scales=[2.0], all_convs=True):
        want = ops.conv2d(y, big)
    assert torch.equal(got, want)


def _mode():
    st = ops._quant_state()
    return None if st is None else st["mode"]


def test_scope_restored_and_per_thread():
    assert _mode() is None
    with pytest.raises(RuntimeError):
        with ops.conv_quant(all_convs=True):
            assert _mode() == "dynamic"
            raise RuntimeError("x")
    assert _mode() is None
    with ops.conv_quant(record=[]):
        with ops.conv_quant(False):
            assert _mode() is None
        assert _mode() == "record"
        other = []
        t = threading.Thread(target=lambda: other.append(_mode()))
        t.start()
        t.join()
        assert other == [None]
    assert _mode() is None


# -------------------------------------------- the generator and the CLI


@pytest.fixture(scope="module")
def gen_weights():
    return ref_layout_weights(GEN, seed=21)


def jax_sites(monkeypatch, fn, *args):
    """``fn(*args)`` jitted inside an all-convs dynamic ``conv_quant`` scope
    of the JAX package, and each int8 site's (input, kernel, stride,
    dilation, output), returned from the jitted program."""
    traced, jint8 = [], jops._conv2d_int8

    def spy(xx, kern, stride, dilation):
        y = jint8(xx, kern, stride, dilation)
        traced.append((xx, kern, y))
        return y

    monkeypatch.setattr(jops, "_conv2d_int8", spy)
    def body(*a):
        traced.clear()
        with jops.conv_quant(all_convs=True):
            out = fn(*a)
        return out, [(xx, k, y) for xx, k, y in traced]

    out, sites = jax.jit(body)(*args)
    return out, [tuple(np.asarray(v) for v in site) for site in sites]


def check_sites(sites):
    """Each JAX int8 site's output from the port's ``_conv2d_int8`` on its
    input (stride 2 where the output is half the input). Within the
    rounding of the scale-back multiply, which XLA fuses its own way under
    jit (a 1e-6 relative bound; one operand on another grid point moves an
    output by a whole step of its scales, 1e-3 of it or more)."""
    with ops.conv_quant(all_convs=True):
        for xx, kern, y in sites:
            k = kern.shape[0]
            stride = 1 if xx.shape[1] - k + 1 == y.shape[1] else 2
            got = ops._conv2d_int8(torch.from_numpy(xx), _oihw(kern),
                                   stride, 1)
            np.testing.assert_allclose(got.numpy(), y, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(y).max()))


def test_generator_all_convs_matches_jax_plain_layout(plain_layout,
                                                      gen_weights,
                                                      monkeypatch):
    """Every conv of a translation in int8 (``all_convs``, dynamic): each
    of JAX's 33 int8 sites (two style and content encodes, a decode),
    given the input JAX gave it, is the port's (``check_sites``); the whole translation is closer to JAX's int8 one than either is
    to float32 (the boundary crossings above compound through the content
    encoder's instance norms)."""
    conf = {"gen_state": 1, "guided": 1, "new_size": 32, "gen": GEN,
            "dis": SMALL_DIS}
    rng = np.random.RandomState(4)
    x, s = (rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
            for _ in range(2))
    jgen = JGenBundle(jvalidate(dict(conf)))
    params = jax.tree.map(jnp.asarray, convert_gen_state_dict(
        gen_weights, GEN, dual=True))
    def translate(params, x, s):
        c, _ = jgen.encode(params, x, 1)
        _, sb = jgen.encode(params, s, 2)
        return jgen.decode(params, c, sb, 2)

    want, sites = jax_sites(monkeypatch, translate, params, jnp.asarray(x),
                            jnp.asarray(s))
    assert len(sites) == 33   # 2 x (7 content + 6 style) + 7 decoder sites
    check_sites(sites)

    gen = GenBundle(validate(dict(conf)), "cpu")
    gen.load_state_dict({k: torch.from_numpy(v)
                         for k, v in gen_weights.items()})

    def run(quant):
        with torch.inference_mode(), ops.conv_quant(quant, all_convs=True):
            sp = gen.encode_style(torch.from_numpy(s))
            return gen.decode(gen.encode_content(torch.from_numpy(x), 1),
                              sp, 2).numpy()

    got = run(True)
    own = float(np.abs(got - run(False)).mean())
    diff = float(np.abs(got - want).mean())
    assert 0.01 < own < 0.1 and diff < own, (diff, own)


def test_translate_cli_int8_matches_jax_cli(plain_layout, gen_weights,
                                            tmp_path, monkeypatch):
    """Both CLIs calibrate on the first inputs and translate with static
    scales; JAX's outputs are taken where its CLI saves them."""
    cfg = tmp_path / "c.yaml"
    cfg.write_text(yaml.safe_dump({"gen_state": 1, "guided": 1,
                                   "new_size": 32, "gen": GEN,
                                   "dis": SMALL_DIS}))
    ckpt = tmp_path / "gen.pt"
    torch.save({"2": {k: torch.from_numpy(v)
                      for k, v in gen_weights.items()}}, ckpt)
    rng = np.random.RandomState(6)
    (tmp_path / "in").mkdir()
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (36, 40, 3), np.uint8)).save(
            tmp_path / "in" / f"input{i}.png")
    Image.fromarray(rng.randint(0, 256, (36, 36, 3), np.uint8)).save(
        tmp_path / "style.png")
    args = ["--config", str(cfg), "--checkpoint", str(ckpt), "--input",
            str(tmp_path / "in"), "--style", str(tmp_path / "style.png")]
    saved = []
    monkeypatch.setattr(jax_translate, "save_image01",
                        lambda a, path: saved.append((path, np.array(a))))
    jax_translate.main(args + ["--output_folder", str(tmp_path / "j"),
                               "--quant", "int8"])
    want = [a * 2 - 1 for p, a in saved if "output" in p]
    got = translate.main(args + ["--output_folder", str(tmp_path / "p"),
                                 "--quant", "int8", "--device", "cpu"])
    f32 = translate.main(args + ["--output_folder", str(tmp_path / "f"),
                                 "--device", "cpu"])
    assert len(got) == len(want) == 3
    for g, w, f in zip(got, want, f32):
        own = float(np.abs(g - f).mean())
        assert 0 < own < 0.05, own   # test_quant.py:151's bound
        assert float(np.abs(g - w).mean()) < INT8_SHARE * own


# ------------------------------------------------------ MUNIT_INT8_DIS


@pytest.fixture(scope="module")
def int8_spec():
    return small_train_spec(gen=dict(GEN))


def test_int8_dis_step_fakes_match_jax(int8_spec, monkeypatch):
    """The port's dis step runs its fakes' forward in int8 with the switch
    on (int8 conv calls counted; none with it off), and those fakes are
    JAX's (its ``_cross_decode`` under ``conv_quant(int8_dis_fakes)``, as
    its dis step runs it) within a small fraction of int8's own error. The
    losses cannot show it: an untrained D barely depends on its input.
    Each of JAX's int8 sites is the port's on its input;
    the fakes are closer to JAX's than to float32 (see the module's
    docstring)."""
    mp = pytest.MonkeyPatch()
    try:
        for k in PLAIN_LAYOUT:
            mp.setenv(k, "0")
        mp.setenv("MUNIT_INT8_DIS", "1")
        jtr = JTrainer(jvalidate(int8_spec), jax.random.PRNGKey(3))
        tr = MUNITTrainer(validate(int8_spec), "cpu")
        mp.delenv("MUNIT_INT8_DIS")
        ref = MUNITTrainer(validate(int8_spec), "cpu")
    finally:
        mp.undo()
    assert jtr.int8_dis_fakes and tr.int8_dis_fakes
    assert not ref.int8_dis_fakes
    x_a, x_b, _, _ = train_batch(seed=8)
    calls, int8 = [], ops._conv2d_int8
    monkeypatch.setattr(ops, "_conv2d_int8",
                        lambda *a: (calls.append(1), int8(*a))[1])
    fakes = {}
    for name, t in (("int8", tr), ("f32", ref)):
        load_jax_state(t, jtr.state)
        seen, loss = [], t._dis_loss
        t._dis_loss = lambda x_ba, x_ab, *a, _l=loss, _s=seen: (
            _s.append((x_ba.numpy(), x_ab.numpy())), _l(x_ba, x_ab, *a))[1]
        n = len(calls)
        t.dis_update(torch.from_numpy(x_a), torch.from_numpy(x_b))
        fakes[name] = seen[0]
        # the 4 res-block convs of each of 2 content encodes and 2 decodes
        assert len(calls) - n == (16 if name == "int8" else 0)

    def jax_fakes(gen, x_a, x_b):
        # the dis step's dynamic scope, with the shape rule
        with jops.conv_quant(jtr.int8_dis_fakes):
            z = jnp.zeros((x_a.shape[0], GEN["style_dim"]))
            return jtr._cross_decode(gen, x_a, x_b, z, z)[-2:]

    traced, jint8 = [], jops._conv2d_int8
    monkeypatch.setattr(jops, "_conv2d_int8", lambda xx, k, st, d: (
        traced.append((xx, k, jint8(xx, k, st, d))), traced[-1][2])[1])

    def body(gen, x_a, x_b):
        traced.clear()
        return jax_fakes(gen, x_a, x_b), list(traced)

    want, sites = jax.jit(body)(jtr.state["gen"], jnp.asarray(x_a),
                                jnp.asarray(x_b))
    assert len(sites) >= 16
    check_sites([tuple(np.asarray(v) for v in site) for site in sites])
    for i in range(2):
        own = float(np.abs(fakes["int8"][i] - fakes["f32"][i]).mean())
        diff = float(np.abs(fakes["int8"][i] - np.asarray(want[i])).mean())
        assert own > 0.005 and diff < own, (diff, own)


def test_int8_dis_switch_in_the_graph_key(int8_spec, monkeypatch):
    keys = {}
    for on in ("0", "1"):
        monkeypatch.setenv("MUNIT_INT8_DIS", on)
        tr = MUNITTrainer(validate(int8_spec), "cpu")
        seen = []

        class Recording:
            def run(self, key, body, tensors):
                seen.append(key)
                return {}

        tr._capture, tr._graphs = True, Recording()
        x = torch.zeros(2, 32, 32, 3)
        tr.dis_update(x, x)
        keys[on] = seen[0]
    assert keys["0"][4][-1] == ("int8_dis", False)
    assert keys["1"][4][-1] == ("int8_dis", True)
    assert keys["0"][:4] == keys["1"][:4]
