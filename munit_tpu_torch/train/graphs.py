"""The trainer's steps captured as CUDA graphs: the counterpart of the
``jax.jit`` steps of ``munit_tpu/train/trainer.py:598-634``.

The JAX trainer compiles each step kind once per static signature
(``extrapolate`` is static: two programs a step) and runs that program on
every later call, with the lr, the optimizer's count and its anchor flag
traced. ``StepGraphs`` does the same with ``torch.cuda.CUDAGraph``:

- a step's key (``step_key``) holds what its device work depends on and a
  replay cannot change: the step kind, the ExtraAdam phase, the anchor flag
  of each optimizer it updates, the inputs' shapes, types and devices (and
  which masks are given), the step's static arguments and the conv
  numerics (``ops.conv_compute_dtype()`` and cuDNN's and cuBLAS's flags);
- the first call with a key runs the step eagerly, on a side stream: a real
  step, which also builds and loads the kernels and sets their
  once-per-device attributes outside any capture;
- the second call captures the step into a graph and replays it; every
  later call copies its tensors into the graph's input buffers and replays.
  The device scalars that the trainer writes before each step (the lr and
  each optimizer's bias correction) are read by the graph, never baked
  into it;
- a step returns copies made after the replay, never the graph's own
  output buffer, which the next replay overwrites;
- a capture runs the step's Python but none of its device work, so the
  launch counts of the kernels' wrappers (``kernels/norms.py``,
  ``kernels/moments.py``) move during it: they are put back, and what the
  capture counted is added on every replay instead.

A failed capture or replay raises; nothing falls back to the eager step.

All of a trainer's graphs allocate from one memory pool. That is safe
however the step kinds interleave, because the graphs replay one at a time
on one stream, and no graph reads at its replay what another graph wrote
into the pool: each graph's input buffers, the parameters and the optimizer
state lie outside the pool, each graph's output buffer stays allocated as
long as its graph (so no later capture is given it), and what two graphs
share are temporaries, which each graph writes before it reads them within
one replay.

The capture's error mode is thread-local: the training loop's feed thread
copies batches to the card while a step is captured, and in the default
global mode a potentially unsafe call of that thread (a cudaMalloc for a
new batch) during the capture is an error. The autograd engine runs the
backward on a thread of its own, but into the capturing stream, so its
launches are captured in any mode.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from munit_tpu_torch.core import ops
from munit_tpu_torch.kernels import moments, norms

Tensors = Dict[str, torch.Tensor]


def conv_numerics() -> tuple:
    """What selects the conv and matmul kernels a capture records."""
    b = torch.backends
    return (ops.conv_compute_dtype(), b.cudnn.allow_tf32,
            b.cuda.matmul.allow_tf32, b.cudnn.deterministic,
            b.cudnn.benchmark)


def signature(tensors: Sequence[Optional[torch.Tensor]]) -> tuple:
    """Shape, type and device of each input; None for an input not given."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype, t.device)
                 for t in tensors)


def step_key(kind: str, extrapolate: bool, has_copy: Sequence[bool],
             tensors: Sequence[Optional[torch.Tensor]],
             static: tuple = ()) -> tuple:
    """The key of one step: its kind, the ExtraAdam phase, the anchor flag
    of each optimizer it updates, its inputs' signature, its static
    arguments and the conv numerics."""
    return (kind, bool(extrapolate), tuple(bool(h) for h in has_copy),
            signature(tensors), tuple(static), conv_numerics())


def _counters() -> List[Tuple[dict, str]]:
    return [(d, k) for d in (*norms.counter_dicts(), *moments.counter_dicts())
            for k in d]


def _detached(out: Tensors) -> Tensors:
    return {k: v.detach() for k, v in out.items()}


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` captured into a shared memory pool."""

    def __init__(self, pool):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool

    def capture(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        with torch.cuda.graph(self.graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            return fn()

    def replay(self) -> None:
        self.graph.replay()


class _Captured:
    """One captured step: its graph, input buffers, the flat output buffer
    with its layout, and the launch counts of one replay."""

    def __init__(self, graph, inputs, flat, layout, deltas):
        self.graph, self.inputs, self.flat = graph, inputs, flat
        self.layout, self.deltas = layout, deltas

    def __call__(self, tensors) -> Tensors:
        for buf, t in zip(self.inputs, tensors):
            if buf is not None:
                buf.copy_(t)
        self.graph.replay()
        for (d, k), n in self.deltas:
            d[k] += n
        flat = self.flat.clone()
        out, at = {}, 0
        for name, shape, dtype in self.layout:
            n = shape.numel()
            out[name] = flat[at:at + n].view(shape).to(dtype)
            at += n
        return out


def _flatten(out: Tensors, layout: list) -> torch.Tensor:
    """The step's outputs as one float32 vector (one copy after a replay
    instead of one a tensor); their names, shapes and types into an empty
    ``layout``."""
    for name, v in out.items():
        if v.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise TypeError(f"a captured step returns float32 or narrower "
                            f"floats; {name} is {v.dtype}")
    if not layout:
        layout.extend((name, v.shape, v.dtype) for name, v in out.items())
    return torch.cat([v.detach().reshape(-1).float() for v in out.values()])


class StepGraphs:
    """One trainer's captured steps, one per key, in one memory pool.
    ``make_graph`` builds a graph (``CudaGraph`` on the trainer's card by
    default); its ``capture(fn)`` records ``fn`` and returns its output,
    ``replay()`` runs what was recorded."""

    def __init__(self, device, make_graph: Optional[Callable] = None):
        self.device = torch.device(device)
        self._make_graph = make_graph
        self._pool = None
        self._steps: Dict[tuple, _Captured] = {}
        self._warm = set()
        # seconds to capture each key: Python, host bookkeeping and the
        # synchronise that opens a capture
        self.capture_seconds: Dict[tuple, float] = {}
        # replays of each key's graph, the one after its capture included
        self.replays: Counter = Counter()

    def __len__(self) -> int:
        return len(self._steps)

    def clear(self) -> None:
        """Drop every graph, for when the tensors a step reads are replaced."""
        self._steps.clear()
        self._warm.clear()
        self.capture_seconds.clear()
        self.replays.clear()

    def _new_graph(self):
        if self._make_graph is not None:
            return self._make_graph()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return CudaGraph(self._pool)

    def pool_bytes(self) -> int:
        """Bytes of card memory that the graphs' pool holds."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)

    def run(self, key: tuple, body: Callable[..., Tensors],
            tensors: Sequence[Optional[torch.Tensor]]) -> Tensors:
        """``body(*tensors)`` for this key: eagerly at its first call,
        captured at its second, replayed from then on."""
        step = self._steps.get(key)
        if step is None:
            if key not in self._warm:
                out = self._eager(body, tensors)
                self._warm.add(key)
                return out
            step = self._capture(key, body, tensors)
        self.replays[key] += 1
        return step(tensors)

    def _eager(self, body, tensors) -> Tensors:
        if self.device.type != "cuda":
            return _detached(body(*tensors))
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = _detached(body(*tensors))
        cur.wait_stream(side)
        for v in out.values():
            v.record_stream(cur)
        return out

    def _capture(self, key, body, tensors) -> _Captured:
        t0 = time.perf_counter()
        inputs = [None if t is None else
                  t.detach().clone(memory_format=torch.contiguous_format)
                  for t in tensors]
        counters = _counters()
        before = [d[k] for d, k in counters]
        graph = self._new_graph()
        layout: list = []
        try:
            flat = graph.capture(lambda: _flatten(body(*inputs), layout))
        finally:
            deltas = [((d, k), d[k] - n) for (d, k), n in zip(counters, before)
                      if d[k] != n]
            for (d, k), n in zip(counters, before):
                d[k] = n
        step = _Captured(graph, inputs, flat, layout, deltas)
        self._steps[key] = step
        self.capture_seconds[key] = time.perf_counter() - t0
        return step
