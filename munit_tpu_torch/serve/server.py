"""The inference service of the flood-translation model: the port's
counterpart of ``munit_tpu/serve/server.py``.

A long-running process loads the generator once, encodes each style
exemplar once, keeps one CUDA graph per batch bucket ready, and answers
image → flooded-image requests over HTTP (stdlib ``http.server``):

  python -m munit_tpu_torch serve --config configs/config_256.yaml \\
      --checkpoint gen.pt --style style.png --port 8787 [--device cpu]
  python -m munit_tpu_torch serve --artifact gen.pt2.zip \\
      --style style.png --port 8787 [--device cpu]

Concurrent requests are coalesced into one batched dispatch by a dynamic
micro-batcher (``MicroBatcher``): up to ``--max-batch`` requests a
dispatch, padded to power-of-two buckets. On the card each bucket's
translation is a CUDA graph (``train/graphs.py``'s ``StepGraphs``, keyed by
the bucket's shapes and types, the int8 mode and its scales and the conv
numerics): ``warmup`` runs each bucket eagerly once and captures it at
once, so no request pays for a capture; a request copies its batch into the
graph's input buffers, replays it and copies the output out. On the CPU
everything runs eagerly. Convolutions run in float32 with TF32 off, the
JAX server's ``Precision.HIGHEST``; ``--quant int8`` runs the worthwhile
generator convs in int8 with static per-site scales calibrated on the
style exemplars (or ``--calib-dir``). ``--artifact`` serves a deployment
artifact (``checkpoint_tools export-aot``, ``io/aot.py``) with no config,
checkpoint or model code: its ``encode_style`` program encodes the styles,
and each bucket's call of its ``translate`` program is captured and
replayed as above; its conv numerics and int8 scales are in the program.

API:
  GET  /healthz             → {"status": "ok", "device": ...}
  GET  /stats               → micro-batcher counters (batch histogram, …)
  POST /translate           → JPEG bytes (body: image file bytes)
  POST /translate?style=ID  → use a named preloaded style

``--mesh auto`` (the default, as the JAX server's) serves from every
visible card (``dist.Replicas``): the model on each card (an artifact's
programs loaded once a card), its own stream and its own CUDA graph per
bucket; ``--max-batch`` is rounded up to a multiple of the cards and the
smallest bucket is one row a card, as the JAX server's rules; each
dispatch pads the batch to a multiple of the cards by repeating its last
row, splits it, launches every card's part, then gathers the rows. With
one card, or on the CPU, it is the one-device service.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch
from PIL import Image

from munit_tpu_torch.core import ops
from munit_tpu_torch.data import transforms as T
from munit_tpu_torch.dist.mesh import Replicas, mesh_devices
from munit_tpu_torch.train import graphs


class Overloaded(RuntimeError):
    """Request shed by the micro-batcher's admission control (HTTP 503)."""


class MicroBatcher:
    """Dynamic micro-batching of the translate dispatch.

    A dispatcher thread drains up to ``max_batch`` queued requests (waiting
    at most ``max_wait_ms`` after the first arrival, and with ``adaptive``
    only while arrivals look bursty: the inter-arrival EWMA predicts the
    wait that fills the batch; no arrival for a second resets it), pads the
    batch to a power-of-two bucket by repeating the last request, runs one
    dispatch and fans the rows back out; an error goes to every request of
    its batch. Beyond ``max_queue`` waiting requests (default 8 x
    ``max_batch``) ``submit`` raises ``Overloaded``.

    ``run_batch(x (B, H, W, 3), s (B, ...)) -> (B, H, W, 3)`` takes any
    bucket's batch, numpy in and out."""

    def __init__(self, run_batch, max_batch: int = 8,
                 max_wait_ms: float = 4.0, adaptive: bool = True,
                 min_batch: int = 1, max_queue: Optional[int] = None):
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.max_queue = max_queue if max_queue is not None \
            else 8 * max_batch
        self.min_batch = max(1, min_batch)
        self.max_wait = max_wait_ms / 1e3
        self.adaptive = adaptive
        self._gap: Optional[float] = None
        self._last_arrival: Optional[float] = None
        self.buckets = []
        b = self.min_batch
        while b < max_batch:
            self.buckets.append(b)
            b *= 2
        if not self.buckets or self.buckets[-1] != max_batch:
            self.buckets.append(max_batch)
        self._q: List[dict] = []
        self._cv = threading.Condition()
        self._closed = False
        self.stats = {"requests": 0, "batches": 0, "rejected": 0,
                      "batch_hist": {}, "device_ms": 0.0}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="munit-microbatcher")
        self._thread.start()

    def submit(self, x: np.ndarray, s) -> np.ndarray:
        """Block until the batched dispatch holding this request has run."""
        item = {"x": x, "s": s, "ev": threading.Event(),
                "out": None, "err": None}
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher closed")
            if len(self._q) >= self.max_queue:
                self.stats["rejected"] += 1
                raise Overloaded(
                    f"queue full ({self.max_queue} waiting requests)")
            now = time.monotonic()
            if self._last_arrival is not None:
                d = now - self._last_arrival
                if d < 1.0:
                    self._gap = d if self._gap is None \
                        else 0.8 * self._gap + 0.2 * d
                else:
                    self._gap = None  # idle era: stop predicting arrivals
            self._last_arrival = now
            self._q.append(item)
            self._cv.notify_all()
        item["ev"].wait()
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    def stats_snapshot(self) -> dict:
        """A copy for handlers (the dispatcher mutates batch_hist)."""
        with self._cv:
            st = dict(self.stats)
            st["batch_hist"] = dict(st["batch_hist"])
        return st

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def _loop(self):
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if self._closed and not self._q:
                    return
                wait = self.max_wait
                if self.adaptive:
                    gap = self._gap
                    if gap is None:
                        wait = 0.0  # sparse traffic: no burst to wait for
                    else:
                        need = self.max_batch - len(self._q)
                        wait = min(self.max_wait, gap * max(need, 0) + gap)
                deadline = time.monotonic() + wait
                while (len(self._q) < self.max_batch and not self._closed):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(left)
                batch = self._q[:self.max_batch]
                del self._q[:len(batch)]
            if not batch:
                continue
            n = len(batch)
            b = self._bucket(n)
            try:
                x = np.concatenate([it["x"] for it in batch], axis=0)
                s = np.concatenate([it["s"] for it in batch], axis=0)
                if b > n:
                    x = np.concatenate(
                        [x, np.repeat(x[-1:], b - n, axis=0)], axis=0)
                    s = np.concatenate(
                        [s, np.repeat(s[-1:], b - n, axis=0)], axis=0)
                t0 = time.monotonic()
                y = np.asarray(self.run_batch(x, s))
                dt = (time.monotonic() - t0) * 1e3
                with self._cv:
                    self.stats["requests"] += n
                    self.stats["batches"] += 1
                    self.stats["batch_hist"][n] = \
                        self.stats["batch_hist"].get(n, 0) + 1
                    self.stats["device_ms"] += dt
                for i, it in enumerate(batch):
                    it["out"] = y[i:i + 1]
                    it["ev"].set()
            except Exception as e:  # noqa: BLE001 — fan the error out
                for it in batch:
                    it["err"] = e
                    it["ev"].set()


def mesh_batch(max_batch: int, n_dev: int) -> int:
    """The JAX server's ``max_batch`` over n_dev cards: batched serving
    (max_batch > 1) rounds it up to a multiple of the cards."""
    if n_dev > 1 and max_batch > 1:
        max_batch = max(max_batch, n_dev)
        max_batch += (-max_batch) % n_dev
    return max_batch


class TranslationService:
    """The model (a loaded ``GenBundle``, on its device, or a deployment
    artifact's programs for ``device``), the encoded styles and the
    translate dispatch: a CUDA graph per bucket on the card, eager on the
    CPU. The replicas' devices are ``--mesh``'s (every visible card for
    ``auto`` on the card); the first is the model's own, and the styles
    are encoded and calibrated there."""

    def __init__(self, conf: Optional[Dict] = None, gen=None,
                 new_size: Optional[int] = None,
                 max_batch: int = 1, max_wait_ms: float = 4.0,
                 quant: str = "none", mesh: str = "auto",
                 artifact: Optional[str] = None,
                 max_queue: Optional[int] = None, device="cuda"):
        self.conf = conf
        self.gen = gen
        self.artifact = None
        if artifact is not None:
            if quant == "int8":
                raise ValueError("int8 is baked at export time for AOT "
                                 "artifacts; re-export instead of --quant")
            from munit_tpu_torch.io import aot
            self.artifact = aot.load_artifact(artifact, device)
            if new_size and new_size != self.artifact.new_size:
                # H and W are static in the programs
                raise ValueError(
                    f"artifact was exported at {self.artifact.new_size}px; "
                    f"new_size={new_size} cannot be served from it")
            self.device = self.artifact.device
            self.new_size = self.artifact.new_size
        else:
            self.device = gen.device
            self.new_size = new_size or conf["new_size"]
        self.devices = mesh_devices(mesh, self.device)
        self.devices[0] = self.device   # the model's own
        if self.artifact is not None:
            self._models = [self.artifact] + [
                aot.load_artifact(artifact, d) for d in self.devices[1:]]
        else:
            self._models = [gen] + [self._gen_copy(d)
                                    for d in self.devices[1:]]
        self.quant = quant == "int8"
        self._scales = None  # per-site activation maxima (int8 calibration)
        # style codes (1, style_dim), on the host: a dispatch copies them to
        # the card on the service's stream
        self.styles: Dict[str, np.ndarray] = {}
        self._style_imgs: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        self._direct_limit = 64   # non-batched path admission bound
        self._direct_slots = threading.BoundedSemaphore(self._direct_limit)
        self.n_dev = len(self.devices)
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in self.devices]
        self._graphs = [graphs.StepGraphs(d) if d.type == "cuda" else None
                        for d in self.devices]
        self.graphs = self._graphs[0]
        self._replicas = Replicas(self.devices, context=self._on_device)
        max_batch = mesh_batch(max_batch, self.n_dev)
        self.batcher: Optional[MicroBatcher] = None
        if max_batch > 1:
            self.batcher = MicroBatcher(self._run_padded, max_batch,
                                        max_wait_ms, min_batch=self.n_dev,
                                        max_queue=max_queue)

    def _gen_copy(self, device):
        """The generator's copy on another replica's device."""
        from munit_tpu_torch.nn.generator import GenBundle
        copy = GenBundle(self.conf, device)
        copy.load_state_dict(self.gen.state_dict())
        return copy

    @contextlib.contextmanager
    def _on_device(self, i: int = 0):
        """Inference mode, and on the card replica i's device and stream:
        the batcher's thread and the caller's run on one stream, and
        ``torch.inference_mode`` is per thread."""
        with torch.inference_mode():
            if self._streams[i] is None:
                yield
            else:
                with torch.cuda.device(self.devices[i]), \
                        torch.cuda.stream(self._streams[i]):
                    yield

    def _body(self, x_a, s_b, i: int = 0):
        model = self._models[i]
        if self.artifact is not None:
            return model.translate(x_a, s_b)
        return model.decode(model.encode_content(x_a, 1), s_b, 2)

    def _translate(self, x_a, s_b, i: int = 0):
        """The model: static int8 once calibrated with ``--quant int8``."""
        with ops.conv_quant(self.quant and self._scales is not None,
                            scales=self._scales):
            return self._body(x_a, s_b, i)

    def graph_key(self, x, s) -> tuple:
        """The bucket's graph key: its inputs' shapes, types and device,
        the int8 mode and scales, and the conv numerics."""
        scales = tuple(self._scales) if self.quant and self._scales else ()
        return graphs.step_key("translate", False, (), (x, s),
                               ("int8" if scales else "none", scales))

    def dispatch(self, x, s, i: int = 0) -> torch.Tensor:
        """One batch through replica i's model, on its device: a copy of
        the bucket's graph's output on the card (eager at a key's first
        call, captured at its second), the eager output on the CPU. Call it
        inside ``_on_device(i)``."""
        if self._graphs[i] is None:
            return self._translate(x, s, i)
        return self._graphs[i].run(
            self.graph_key(x, s),
            lambda x, s: {"y": self._translate(x, s, i)}, (x, s))["y"]

    def _run_padded(self, x, s) -> np.ndarray:
        """A batch of images and style codes, numpy → numpy output: padded
        to a multiple of the replicas, split over them, gathered."""
        xt, st = (torch.from_numpy(np.ascontiguousarray(a, np.float32))
                  for a in (x, s))
        return self._replicas(self._dispatch_part, xt, st, to="cpu").numpy()

    def _dispatch_part(self, i, x, s):
        return self.dispatch(x, s, i)

    def _prep(self, img: Image.Image) -> np.ndarray:
        """Resize the shorter side to ``new_size``, center crop, [-1, 1]:
        (1, S, S, 3) float32."""
        img = T.resize_shorter(img.convert("RGB"), self.new_size)
        w, h = img.size
        s = self.new_size
        img = T.crop(img, (h - s) // 2, (w - s) // 2, s, s)
        return T.normalize_pm1(T.to_array01(img))[None]

    def add_style(self, name: str, exemplar: Image.Image):
        """Encode the exemplar's style once, with branch 2's encoder."""
        prepped = self._prep(exemplar)
        self._style_imgs[name] = prepped
        encode = (self.artifact.encode_style if self.artifact is not None
                  else lambda x: self.gen.encode_style(x, 2))
        with self._on_device():
            self.styles[name] = encode(
                torch.from_numpy(prepped).to(self.device)).cpu().numpy()

    def calibrate(self, images=None):
        """Record per-site activation maxima for the static int8 path, on
        ``images`` (PIL) as content or by default the style exemplars, each
        with the first style; the scales are the maxima x1.1. ``warmup``
        calls it when needed."""
        if not self.quant:
            return
        arrs = ([self._prep(im) for im in images] if images
                else list(self._style_imgs.values()))
        if not arrs:
            raise RuntimeError("int8 calibration needs at least one style")
        s1 = next(iter(self.styles.values()))
        with self._on_device():
            x = torch.from_numpy(np.concatenate(arrs)).to(self.device)
            s = torch.from_numpy(np.repeat(s1, x.shape[0], axis=0))
            rec = []
            with ops.conv_quant(record=rec):
                self._body(x, s.to(self.device))
            mx = torch.stack(rec).cpu().numpy()
        self._scales = [1.1 * float(v) for v in mx]

    def warmup(self):
        """Calibrate if needed, then run every bucket: on the card eagerly
        and then captured, so that requests only replay."""
        if not self.styles:
            return
        if self.quant and self._scales is None:
            self.calibrate()
        s1 = next(iter(self.styles.values()))
        # the direct path pads one request to one row a replica
        sizes = self.batcher.buckets if self.batcher else [self.n_dev]
        for b in sizes:
            x = torch.zeros((b, self.new_size, self.new_size, 3))
            s = torch.from_numpy(np.repeat(s1, b, axis=0))
            for _ in range(1 if self.graphs is None else 2):
                self._replicas(self._dispatch_part, x, s)
        for stream in self._streams:
            if stream is not None:
                stream.synchronize()

    def translate(self, img: Image.Image,
                  style: str = "default") -> Image.Image:
        if style not in self.styles:
            raise KeyError(f"unknown style '{style}'")
        if self.batcher is not None:
            out = self.batcher.submit(self._prep(img), self.styles[style])
        else:
            # the micro-batcher's admission control on the direct path:
            # bound the threads waiting on the dispatch lock
            if not self._direct_slots.acquire(blocking=False):
                raise Overloaded(
                    f"queue full ({self._direct_limit} waiting requests)")
            try:
                with self._lock:  # one dispatch at a time
                    out = self._run_padded(self._prep(img),
                                           self.styles[style])
            finally:
                self._direct_slots.release()
        arr = (out[0] + 1.0) * 0.5
        lo, hi = arr.min(), arr.max()
        arr = (arr - lo) / max(hi - lo, 1e-5)
        return Image.fromarray((arr * 255).round().astype(np.uint8))

    def device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return str(self.device)


def _make_handler(service: TranslationService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str, extra=()):
            self.send_response(code)
            for k, v in extra:
                self.send_header(k, v)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                body = {"status": "ok", "device": service.device_name(),
                        "n_devices": service.n_dev,
                        "styles": sorted(service.styles),
                        "batching": service.batcher is not None}
            elif self.path.startswith("/stats"):
                body = (service.batcher.stats_snapshot()
                        if service.batcher else {})
                if body.get("batches"):
                    body["mean_batch"] = round(
                        body["requests"] / body["batches"], 3)
                    body["mean_device_ms"] = round(
                        body["device_ms"] / body["batches"], 3)
            else:
                self.send_response(404)
                self.end_headers()
                return
            self._send(200, json.dumps(body).encode(), "application/json")

        def do_POST(self):
            if not self.path.startswith("/translate"):
                self.send_response(404)
                self.end_headers()
                return
            style = "default"
            if "style=" in self.path:
                style = self.path.split("style=")[1].split("&")[0]
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            try:
                out = service.translate(Image.open(io.BytesIO(data)), style)
            except Overloaded as e:
                self._send(503, json.dumps({"error": str(e)}).encode(),
                           "application/json", [("Retry-After", "1")])
                return
            except Exception as e:  # noqa: BLE001 — a bad request
                self._send(400, json.dumps({"error": str(e)}).encode(),
                           "application/json")
                return
            buf = io.BytesIO()
            out.save(buf, format="JPEG", quality=92)
            self._send(200, buf.getvalue(), "image/jpeg")

    return Handler


class _Server(ThreadingHTTPServer):
    # the listen(2) backlog: the stdlib's 5 refuses connects under a burst
    # before admission control runs; overload is answered by 503 instead
    request_queue_size = 256


def serve(service: TranslationService, port: int = 8787,
          host: str = "127.0.0.1") -> ThreadingHTTPServer:
    return _Server((host, port), _make_handler(service))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m munit_tpu_torch serve")
    p.add_argument("--config", default=None,
                   help="required unless --artifact is given")
    p.add_argument("--checkpoint", default=None,
                   help="any generator file or directory translate reads; "
                        "required unless --artifact is given")
    p.add_argument("--artifact", default=None,
                   help="deployment artifact (.pt2.zip from "
                        "checkpoint_tools export-aot): serves without a "
                        "config, a checkpoint or the model code")
    p.add_argument("--style", required=True, action="append",
                   help="style exemplar image, 'path' or 'name=path'; "
                        "repeatable — the first is also served as 'default'")
    p.add_argument("--port", type=int, default=8787,
                   help="0 takes a free port, which the ready line names")
    p.add_argument("--max-batch", type=int, default=8,
                   help="micro-batcher cap (1 disables batching)")
    p.add_argument("--max-wait-ms", type=float, default=4.0,
                   help="max coalescing wait after the first request")
    p.add_argument("--quant", choices=["none", "int8"], default="none",
                   help="int8: calibrated static W8A8 generator convs")
    p.add_argument("--calib-dir", default=None,
                   help="folder of content images for int8 calibration "
                        "(default: the style exemplars)")
    p.add_argument("--mesh", choices=["auto", "off"], default="auto",
                   help="auto: serve from every visible card")
    p.add_argument("--max-queue", type=int, default=None,
                   help="admission-control bound on waiting requests; "
                        "overflow is shed with 503 + Retry-After "
                        "(default: MicroBatcher's 8x max-batch)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def build_service(opts) -> TranslationService:
    """The service of parsed ``serve`` arguments, its styles added,
    calibrated and warmed up."""
    from munit_tpu_torch.cli.translate import resolve_device
    if opts.artifact is None and not (opts.config and opts.checkpoint):
        raise SystemExit("--config and --checkpoint are required without "
                         "--artifact")
    device = resolve_device(opts.device)
    ops.set_conv_compute(None)
    common = dict(max_batch=opts.max_batch, max_wait_ms=opts.max_wait_ms,
                  quant=opts.quant, mesh=opts.mesh, max_queue=opts.max_queue)
    if opts.artifact is not None:
        svc = TranslationService(artifact=opts.artifact, device=device,
                                 **common)
    else:
        from munit_tpu_torch.cli.translate import load_generator
        from munit_tpu_torch.config import get_config
        conf = get_config(opts.config)
        svc = TranslationService(conf, load_generator(opts.checkpoint, conf,
                                                      device), **common)
    for i, spec in enumerate(opts.style):
        name, _, path = spec.rpartition("=")
        img = Image.open(path or spec)
        if i == 0:
            svc.add_style("default", img)
        if name:
            svc.add_style(name, img)
    if opts.quant == "int8" and opts.calib_dir:
        paths = sorted(glob.glob(os.path.join(opts.calib_dir, "*")))[:8]
        svc.calibrate([Image.open(pth) for pth in paths])
    svc.warmup()
    return svc


def main(argv=None):
    opts = parse_args(argv)
    svc = build_service(opts)
    server = serve(svc, opts.port)
    print(f"serving on :{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if svc.batcher is not None:
            svc.batcher.close()


if __name__ == "__main__":
    main()
