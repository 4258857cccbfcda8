"""The port's inference service (``munit_tpu_torch/serve``) on the CPU.

- ``MicroBatcher`` alone, with a stand-in ``run_batch`` and no model:
  buckets, padding by repeating the last request, the error fanned out to
  its batch, no wait when idle, 503 shedding at ``max_queue``, ``close``
  (the counterparts of ``tests/test_serve.py``'s batcher tests).
- ``TranslationService`` against the JAX package's (``mesh="off"``,
  ``max_batch`` 2, one JAX service for the file) on the same numpy-made
  weights, JAX's through ``convert_gen_state_dict``: the port's direct and micro-batched
  outputs within 1 uint8 step of JAX's (the JAX tests' slack: the min-max
  normalisation to uint8 rounds float32 sums taken in another order);
  ``--quant int8`` close to float32 and different from it at a width whose
  res blocks carry 128 channels (the shape rule's least).
- HTTP: ``/healthz``, ``/stats``, ``/translate`` and an unknown style's 400,
  through the service that ``serve``'s ``main`` builds (``build_service``)
  with ``--device cpu``.
- The refusals: ``--artifact`` with ``--quant int8``, the card by default
  without one; ``--mesh auto`` with two cards takes both (item 16).
- The inference CLIs (``translate``, ``translate_batch``, ``evaluate fid``
  and ``sweep``, ``serve``) set the JAX CLIs' conv numerics, float32 with
  TF32 off, before they build the generator.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from munit_tpu.config import validate as jvalidate
from munit_tpu.serve import TranslationService as JaxService
from munit_tpu.io.torch_import import convert_gen_state_dict
from munit_tpu_torch.cli import evaluate, translate, translate_batch
from munit_tpu_torch.config import validate
from munit_tpu_torch.core import ops
from munit_tpu_torch.nn.generator import GenBundle
from munit_tpu_torch.serve import server
from munit_tpu_torch.serve.server import (MicroBatcher, Overloaded,
                                          TranslationService)
from tests.torch_port_util import (SMALL_DIS, one_torch_thread,  # noqa: F401
                                   ref_layout_weights)

SIZE = 32
# dim 32 and two downsamplings: the res blocks carry 128 channels, so the
# int8 shape rule quantizes their convs
GEN = dict(dim=32, mlp_dim=32, style_dim=8, activ="relu", n_downsample=2,
           n_res=2, pad_type="reflect")
SPEC = {"gen_state": 1, "guided": 1, "new_size": SIZE,
        "crop_image_height": SIZE, "crop_image_width": SIZE, "gen": GEN,
        "dis": SMALL_DIS}


def _image(rng, h=48, w=52):
    return Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8))


def _u8(img):
    return np.asarray(img, np.int16)


# --------------------------------------------------------- MicroBatcher


def test_microbatcher_buckets():
    assert MicroBatcher(lambda x, s: x, max_batch=8).buckets == [1, 2, 4, 8]
    assert MicroBatcher(lambda x, s: x, max_batch=6).buckets == [1, 2, 4, 6]
    assert MicroBatcher(lambda x, s: x, max_batch=1).buckets == [1]


def test_microbatcher_adaptive_no_wait_when_idle():
    """A lone request through a batcher with a huge max_wait returns at
    once: sparse traffic does not pay the coalescing wait."""
    mb = MicroBatcher(lambda x, s: np.asarray(x) * 2.0,
                      max_batch=8, max_wait_ms=5000.0)
    t0 = time.monotonic()
    out = mb.submit(np.ones((1, 2, 2, 3), np.float32), np.zeros((1, 4)))
    dt = time.monotonic() - t0
    assert np.array_equal(out, np.full((1, 2, 2, 3), 2.0, np.float32))
    assert dt < 1.0, f"idle request waited {dt:.2f}s for coalescing"
    mb.close()


def test_microbatcher_pads_by_repeat_and_fans_out_errors():
    seen = []

    def run(x, s):
        seen.append((x.copy(), s.copy()))
        if float(np.max(x)) > 100:
            raise ValueError("boom")
        return x * 2.0

    mb = MicroBatcher(run, max_batch=4, max_wait_ms=200.0)
    xs = [np.full((1, 2, 2, 3), i, np.float32) for i in range(3)]
    outs, errs = [None] * 3, [None] * 3

    def worker(i, x):
        try:
            outs[i] = mb.submit(x, np.full((1, 4), i, np.float32))
        except Exception as e:  # noqa: BLE001
            errs[i] = e

    ts = [threading.Thread(target=worker, args=(i, xs[i])) for i in range(3)]
    for t in ts:
        t.start()
        time.sleep(0.005)
    for t in ts:
        t.join()
    assert errs == [None] * 3
    for i in range(3):
        assert np.array_equal(outs[i], xs[i] * 2.0)
    assert all(x.shape[0] in mb.buckets for x, _ in seen)
    for x, s in seen:  # a padded batch repeats its last request
        n = len({float(v) for v in x[:, 0, 0, 0]})
        assert np.array_equal(x[n:], np.repeat(x[n - 1:n], len(x) - n, 0))
        assert np.array_equal(s[n:], np.repeat(s[n - 1:n], len(s) - n, 0))
    assert mb.stats["requests"] == 3

    # every waiter of a failing batch sees its exception
    bad = [np.full((1, 2, 2, 3), 999.0, np.float32),
           np.full((1, 2, 2, 3), 1.0, np.float32)]
    errs = [None, None]

    def fail(i):
        try:
            mb.submit(bad[i], np.zeros((1, 4), np.float32))
        except ValueError as e:
            errs[i] = e

    mb.max_wait, mb._gap = 0.3, 0.01  # coalesce the two into one batch
    ts = [threading.Thread(target=fail, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert all(isinstance(e, ValueError) for e in errs), errs
    mb.close()


def test_microbatcher_sheds_load_when_queue_full():
    release = threading.Event()

    def slow_run(x, s):
        release.wait(5.0)
        return x

    mb = MicroBatcher(slow_run, max_batch=1, max_wait_ms=1.0, max_queue=2)
    results = []

    def worker():
        try:
            mb.submit(np.zeros((1, 4, 4, 3), np.float32), np.zeros((1, 2)))
            results.append("ok")
        except Overloaded:
            results.append("shed")

    threads = [threading.Thread(target=worker) for _ in range(6)]
    for t in threads:
        t.start()
        time.sleep(0.02)
    release.set()
    for t in threads:
        t.join(timeout=10)
    assert "shed" in results
    assert results.count("ok") >= 3
    assert mb.stats["rejected"] == results.count("shed")
    mb.close()


def test_microbatcher_close():
    mb = MicroBatcher(lambda x, s: x, max_batch=2)
    mb.close()
    assert not mb._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(np.zeros((1, 2, 2, 3), np.float32), np.zeros((1, 2)))


# ------------------------------------------------ the service against JAX


@pytest.fixture(scope="module")
def weights():
    """Reference-layout weights of SPEC's generator (numpy) and the JAX
    params made from them."""
    sd = ref_layout_weights(GEN, seed=9)
    return sd, jax.tree.map(jnp.asarray,
                            convert_gen_state_dict(sd, GEN, dual=True))


@pytest.fixture(scope="module")
def style_img():
    return _image(np.random.RandomState(0), 40, 40)


@pytest.fixture(scope="module")
def jax_service(weights, style_img):
    svc = JaxService(jvalidate(dict(SPEC)), weights[1], max_batch=2,
                     max_wait_ms=40.0, mesh="off")
    svc.add_style("default", style_img)
    svc.warmup()
    yield svc
    svc.batcher.close()


def port_service(weights, style_img, **kw):
    gen = GenBundle(validate(dict(SPEC)), "cpu")
    gen.load_state_dict({k: torch.from_numpy(v) for k, v in weights[0].items()})
    svc = TranslationService(validate(dict(SPEC)), gen, mesh="off", **kw)
    svc.add_style("default", style_img)
    svc.warmup()
    return svc


def _concurrently(fn, n):
    outs = [None] * n
    threads = [threading.Thread(target=lambda i=i: outs.__setitem__(
        i, fn(i))) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs


def test_service_direct_and_batched_match_jax(weights, style_img,
                                              jax_service):
    rng = np.random.RandomState(1)
    imgs = [_image(rng) for _ in range(4)]
    want = _concurrently(lambda i: jax_service.translate(imgs[i]), 4)
    direct = port_service(weights, style_img)
    assert direct.batcher is None and direct.graphs is None
    got = [direct.translate(im) for im in imgs]
    batched = port_service(weights, style_img, max_batch=2, max_wait_ms=40.0)
    got_b = _concurrently(lambda i: batched.translate(imgs[i]), 4)
    for g, gb, w in zip(got, got_b, want):
        assert g.size == (SIZE, SIZE)
        assert np.abs(_u8(g) - _u8(w)).max() <= 1
        assert np.abs(_u8(gb) - _u8(w)).max() <= 1
    st = batched.batcher.stats_snapshot()
    assert st["requests"] == 4 and st["batches"] < 4, st
    batched.batcher.close()


def test_service_int8_close_to_float32(weights, style_img):
    """The JAX test's bound (mean under 4 uint8 steps), and quantization in
    effect: 14 sites recorded (each conv of a content encode and a decode),
    the output not the float32 one."""
    rng = np.random.RandomState(7)
    img = _image(rng)
    f32 = port_service(weights, style_img)
    q = port_service(weights, style_img, quant="int8")
    assert len(q._scales) == 14
    a, b = _u8(f32.translate(img)), _u8(q.translate(img))
    assert 0 < np.abs(a - b).mean() < 4.0, np.abs(a - b).mean()


# ----------------------------------------------------------------- HTTP


@pytest.fixture(scope="module")
def files(tmp_path_factory, weights, style_img):
    root = tmp_path_factory.mktemp("serve")
    cfg = root / "c.yaml"
    cfg.write_text(yaml.safe_dump(dict(SPEC)))
    torch.save({"2": {k: torch.from_numpy(v) for k, v in weights[0].items()}},
               root / "gen.pt")
    style_img.save(root / "style.png")
    return {"cfg": str(cfg), "gen": str(root / "gen.pt"),
            "style": str(root / "style.png"), "root": root}


def _args(files, *extra):
    return ["--config", files["cfg"], "--checkpoint", files["gen"],
            "--style", files["style"], "--style", f"wet={files['style']}",
            *extra]


def test_http_round_trip(files):
    opts = server.parse_args(_args(files, "--device", "cpu",
                                   "--max-batch", "2", "--port", "0"))
    svc = server.build_service(opts)
    httpd = server.serve(svc, port=0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["device"] == "cpu"
        assert health["styles"] == ["default", "wet"] and health["batching"]
        buf = io.BytesIO()
        _image(np.random.RandomState(2), 40, 40).save(buf, format="PNG")
        for path in ("/translate", "/translate?style=wet"):
            req = urllib.request.Request(base + path, data=buf.getvalue(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.headers["Content-Type"] == "image/jpeg"
                assert Image.open(io.BytesIO(r.read())).size == (SIZE, SIZE)
        with urllib.request.urlopen(base + "/stats", timeout=10) as r:
            st = json.loads(r.read())
        assert st["requests"] == 2 and st["mean_batch"] == 1.0
        req = urllib.request.Request(base + "/translate?style=nope",
                                     data=buf.getvalue(), method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.batcher.close()


def test_direct_path_sheds_load_with_503(files):
    """--max-batch 1: threads beyond the direct path's bound get 503 and
    Retry-After over HTTP instead of queueing on the dispatch lock."""
    svc = server.build_service(server.parse_args(
        _args(files, "--device", "cpu", "--max-batch", "1")))
    release = threading.Event()
    orig = svc._run_padded
    svc._run_padded = lambda x, s: (release.wait(5.0), orig(x, s))[1]
    svc._direct_limit = 2
    svc._direct_slots = threading.BoundedSemaphore(2)
    httpd = server.serve(svc, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/translate"
    buf = io.BytesIO()
    _image(np.random.RandomState(3), 40, 40).save(buf, format="PNG")

    def post(i):
        req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return (e.code, e.headers["Retry-After"])

    codes = [None] * 4
    threads = []
    for i in range(4):
        threads.append(threading.Thread(
            target=lambda i=i: codes.__setitem__(i, post(i))))
        threads[-1].start()
        time.sleep(0.1)
    release.set()
    for t in threads:
        t.join(timeout=30)
    httpd.shutdown()
    httpd.server_close()
    assert codes.count(200) == 2 and codes.count((503, "1")) == 2, codes


# ------------------------------------------------------------ refusals


def test_artifact_refused(files):
    # an artifact's int8 scales are in its program (export-aot --quant int8)
    with pytest.raises(ValueError, match="baked at export"):
        server.main(["--artifact", "m.zip", "--style", files["style"],
                     "--quant", "int8", "--device", "cpu"])


def test_multi_card_mesh_refused(files, monkeypatch):
    """--mesh auto with two cards (ROADMAP item 16, refused until it was
    ported) serves from both: every visible card for auto, one for off,
    max_batch rounded up to a multiple of the cards when batching."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert server.mesh_devices("auto", "cuda") == [torch.device("cuda", 0),
                                                   torch.device("cuda", 1)]
    assert server.mesh_devices("off", "cuda") == [torch.device("cuda")]
    assert [server.mesh_batch(b, 2) for b in (1, 2, 3, 8)] == [1, 2, 4, 8]


def test_serve_needs_a_card_by_default(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        server.main(_args(files))


def test_module_entry_point_has_serve(capsys):
    from munit_tpu_torch.__main__ import COMMANDS, main
    assert COMMANDS["serve"][0] == "munit_tpu_torch.serve.server"
    assert main(["--help"]) == 0
    assert "serve" in capsys.readouterr().out


# ---------------------------------------------------- CLI conv numerics


class Built(Exception):
    """Raised by the spy in place of building the generator."""


@pytest.fixture
def numerics_spy(monkeypatch):
    """TF32 on and bf16 conv operands before a CLI runs, as a training
    process leaves them; the spy records the numerics at the moment the
    CLI builds its generator. The process's flags are restored after."""
    b = torch.backends
    before = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
              ops.conv_compute_dtype())
    ops.set_conv_compute(torch.bfloat16)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = True
    seen = []

    def spy(*a, **k):
        seen.append((b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
                     ops.conv_compute_dtype()))
        raise Built()

    for module in (translate, translate_batch, evaluate):
        monkeypatch.setattr(module, "load_generator", spy)
    yield seen
    ops.set_conv_compute(before[2])
    b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = before[:2]


CPU = ["--device", "cpu"]
CLIS = {
    "translate": lambda f: translate.main(
        ["--config", f["cfg"], "--checkpoint", f["gen"], "--input",
         str(f["root"]), "--style", f["style"], "--output_folder",
         str(f["root"] / "t"), *CPU]),
    "translate_batch": lambda f: translate_batch.main(
        ["--config", f["cfg"], "--checkpoint", f["gen"], "--input_folder",
         str(f["root"]), "--output_folder", str(f["root"] / "b"), *CPU]),
    "evaluate_fid": lambda f: evaluate.main(
        ["fid", "--config", f["cfg"], "--checkpoint", f["gen"],
         "--inception_ckpt", "none.pth", *CPU]),
    "evaluate_sweep": lambda f: evaluate.main(
        ["sweep", "--config", f["cfg"], "--checkpoint", f["gen"],
         "--input", f["style"], *CPU]),
    "serve": lambda f: server.main(_args(f, *CPU)),
}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_sets_f32_numerics_before_the_generator(cli, files,
                                                    numerics_spy):
    with pytest.raises(Built):
        CLIS[cli](files)
    assert numerics_spy == [(False, False, None)]
