"""Threaded, prefetching batch loader and the host-to-device stage: the
port's copy of ``munit_tpu/data/loader.py``.

``DataLoader`` decodes on a thread pool (PIL and the native image ops
release the GIL) into a bounded queue; ``device_prefetch`` copies each
batch to the card on a side CUDA stream from a pump thread, so the copy of
the next batch overlaps the current step.

Sharding: ``shard_index``/``shard_count`` give each process a disjoint
slice of every epoch's permutation (the JAX package's ``--dist``: each
process a batch of its own). ``row_index``/``row_count`` give a process its
contiguous rows of each batch, batch_size / row_count of them, and decode
only those (one loader's batch split over the cards of a one-process
``--mesh``, which the port runs as one process a card).
"""

from __future__ import annotations

import itertools
import os
import queue
import sys
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch


class DataLoader:
    """Iterates batches forever (epoch reshuffles internally), or one epoch
    with ``batches()``.

    Yields dicts of stacked numpy arrays. drop_last semantics always on
    (matching the reference's training loaders).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 num_workers: int = 4, seed: int = 0,
                 shard_index: int = 0, shard_count: int = 1,
                 prefetch: int = 4, row_index: int = 0, row_count: int = 1):
        if batch_size % row_count:
            raise ValueError(f"batch_size {batch_size} does not split into "
                             f"{row_count} equal parts")
        self.dataset = dataset
        self.batch_size = batch_size
        self.row_index = row_index
        self.row_count = row_count
        self.rows = batch_size // row_count   # the rows a batch yields
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.dataset) // self.shard_count
        return n // self.batch_size

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            perm = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])).permutation(n)
        else:
            perm = np.arange(n)
        return perm[self.shard_index::self.shard_count]

    def _load(self, epoch: int, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, int(index)]))
        return self.dataset.get(int(index), rng)

    def _load_or_substitute(self, epoch: int, index: int):
        """MUNIT_LOADER_SKIP_BAD=1: a sample that fails to decode is logged
        and replaced by the next loadable index (at most 8 tries); by
        default the error reaches the caller and training stops."""
        if os.environ.get("MUNIT_LOADER_SKIP_BAD", "0") != "1":
            return self._load(epoch, index)
        n = len(self.dataset)
        last: BaseException
        for k in range(min(8, n)):
            try:
                return self._load(epoch, (index + k) % n)
            except Exception as e:  # noqa: BLE001 — the substitution path
                last = e
                print(f"loader: sample {(index + k) % n} failed "
                      f"({type(e).__name__}: {e}); substituting",
                      file=sys.stderr)
        raise last

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self._iterate()

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch of batches (epoch 0's order, the last partial batch
        dropped), then the end: what FID reads."""
        return self._iterate(single_epoch=True)

    def iter_from(self, start_batch: int) -> Iterator[Dict[str, np.ndarray]]:
        """The infinite stream as if ``start_batch`` batches were already
        consumed: exact data-order resume after a checkpoint restore. The
        per-(seed, epoch, index) RNG makes skipping arithmetic; nothing is
        decoded for the skipped batches."""
        return self._iterate(start_batch=start_batch)

    def _in_flight_window(self) -> int:
        """Max decode futures submitted but not yet consumed: bounds the
        decoded samples held in RAM."""
        return max(2 * self.rows, 2 * self.num_workers)

    def _iterate(self, start_batch: int = 0, single_epoch: bool = False):
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def index_stream():
            epoch = 0
            skip = start_batch * self.batch_size   # samples, not batches
            while True:
                idx = self._epoch_indices(epoch)
                usable = (len(idx) // self.batch_size) * self.batch_size
                if usable == 0 and not single_epoch:
                    # an infinite stream of nothing would hang training
                    raise ValueError(
                        f"dataset yields 0 usable batches: {len(idx)} "
                        f"samples < batch_size={self.batch_size} "
                        "(drop_last). Reduce batch_size or provide more "
                        "samples per shard.")
                if skip >= usable > 0:
                    skip -= usable          # whole epoch already consumed
                else:
                    for p in range(skip, usable):
                        if (p % self.batch_size) // self.rows \
                                == self.row_index:
                            yield epoch, idx[p]
                    skip = 0
                epoch += 1
                if single_epoch:
                    return

        def put_blocking(item) -> bool:
            """A put that gives up when the consumer has gone."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            window = self._in_flight_window()
            stream = index_stream()
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    in_flight: "deque" = deque()
                    while not stop.is_set():
                        for ep, i in itertools.islice(
                                stream, window - len(in_flight)):
                            in_flight.append(
                                pool.submit(self._load_or_substitute, ep, i))
                        if len(in_flight) < self.rows:
                            put_blocking(None)   # a single epoch's end
                            return
                        samples = [in_flight.popleft().result()
                                   for _ in range(self.rows)]
                        batch = {k: np.stack([smp[k] for smp in samples])
                                 for k in samples[0]
                                 if not isinstance(samples[0][k], str)}
                        for k in samples[0]:
                            if isinstance(samples[0][k], str):
                                batch[k] = [smp[k] for smp in samples]
                        if not put_blocking(batch):
                            return
            except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
                # a dead producer must not leave the consumer blocked
                put_blocking(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def device_prefetch(iterator, device="cuda", size: int = 2,
                    image_dtype: Optional[torch.dtype] = None):
    """Batches of numpy arrays → dicts of tensors on ``device``, ``size``
    batches ahead of the consumer.

    uint8 images become ``image_dtype`` (default float32) in [-1, 1] on the
    device, in float32 in the JAX package's host op order ((x / 255) * 2 -
    1) and then cast; uint8 masks become float32; float32
    images are cast to ``image_dtype`` on the device. On a CUDA device a
    pump thread copies each batch from pinned memory with
    ``non_blocking=True`` and normalizes it on a side stream; the consumer's
    stream waits for that batch's event before it gets the batch, and each
    tensor is recorded on the consumer's stream, so neither the step nor
    the allocator touches memory still in flight. Without a card a CUDA
    device raises."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("device_prefetch: no CUDA card; pass a CPU "
                           "device to run on the CPU")
    dt = image_dtype or torch.float32
    side = torch.cuda.Stream(device) if cuda else None

    def postprocess(k, v: torch.Tensor) -> torch.Tensor:
        if v.dtype == torch.uint8 and k.startswith("image"):
            return ((v.float() / 255.0) * 2.0 - 1.0).to(dt)
        if v.dtype == torch.uint8 and k.startswith("mask"):
            return v.float()
        if k.startswith("image") and v.dtype != dt:
            return v.to(dt)
        return v

    def to_device(batch):
        out = {}
        for k, v in batch.items():
            if not isinstance(v, np.ndarray):
                out[k] = v
                continue
            host = torch.from_numpy(v)
            if cuda:
                host = host.pin_memory()
            out[k] = postprocess(k, host.to(device, non_blocking=cuda))
        return out

    def transfer(batch):
        if not cuda:
            return to_device(batch), None
        with torch.cuda.stream(side):
            out = to_device(batch)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    out_q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def pump():
        try:
            for batch in iterator:
                if not put(transfer(batch)):
                    return
            put(end)
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            put(e)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()     # stops the loader's decode threads

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        while True:
            item = out_q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            out, done = item
            if cuda:
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                for v in out.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(current)
            yield out
    finally:
        # the pump may be inside a CUDA copy: wait for it, so that no
        # thread is in PyTorch's C++ code when the interpreter exits (a
        # daemon thread that wakes up then aborts the process)
        stop.set()
        t.join()
