"""Data parallel over cards: the port's counterpart of
``munit_tpu/dist/mesh.py``, in PyTorch's idiom of one process a card.

The JAX package builds a ``(data, spatial)`` mesh over the devices,
replicates the state, shards the batch over ``data`` and lets ``jit`` turn
the gradient mean into all-reduces. Here each process drives one device in
a ``torch.distributed`` group (``init_group``):

- ``mean_over_group_`` means a step's gradients (and its metrics) over the
  group with one coalesced all-reduce, inside the step's body, so that a
  captured step reduces on every replay;
- ``group_mean`` is a differentiable all-reduce: the train-mode batch norm
  (``nn/classifiers.py``) takes its mean and variance over the global batch
  with it, as JAX's mesh does, and its backward all-reduces the gradient,
  as ``SyncBatchNorm``'s does;
- over NCCL a mean is one all-reduce with ``ReduceOp.AVG`` (at world 1
  NCCL's one-rank kernel multiplies by 1.0: exact, and a launch that a
  profile shows); gloo has no AVG: a sum, then x 1/world;
- a small gloo group beside the card's NCCL group (``host_group``) carries
  what the host agrees on: the stop flag of an iteration, barriers, the
  gathered FID pools.

``Replicas`` is the one-process ``--mesh auto`` of the inference commands:
a copy of the model on each visible card, the batch padded to a multiple
of the cards by repeating its last row (JAX's rule), split into contiguous
parts, each launched on its card, gathered to the first and sliced back.

``--spatial`` (JAX's H-sharded HD activations) is not ported: ROADMAP
queue 1 item 16b. A failed group start or collective raises; nothing
carries on in one process.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as td

TIMEOUT = datetime.timedelta(seconds=600)
SPATIAL_REFUSED = ("--spatial > 1 (H-sharded activations across cards) is "
                   "not ported; ROADMAP queue 1 item 16b")

_group: Optional[dict] = None


def parse_spec(spec: str):
    """(init_method, world, rank, local_rank) of ``--dist``: JAX's
    ``coordinator:port,num_processes,process_id``, or ``auto`` from
    torchrun's RANK/WORLD_SIZE/LOCAL_RANK/MASTER_ADDR/MASTER_PORT or
    SLURM's SLURM_PROCID/SLURM_NTASKS/SLURM_LOCALID (with MASTER_ADDR and
    MASTER_PORT). An explicit spec's local rank is the process id modulo
    the visible cards (one per card, host after host)."""
    env = os.environ
    if spec == "auto":
        if "RANK" in env and "WORLD_SIZE" in env:
            rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
            local = int(env.get("LOCAL_RANK", rank))
        elif "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
            rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
            local = int(env.get("SLURM_LOCALID", rank))
        else:
            raise SystemExit("--dist auto: neither torchrun's RANK/"
                             "WORLD_SIZE nor SLURM's SLURM_PROCID/"
                             "SLURM_NTASKS is set")
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise SystemExit("--dist auto needs MASTER_ADDR and MASTER_PORT")
        return (f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}", world,
                rank, local)
    try:
        addr, world, rank = spec.rsplit(",", 2)
        world, rank = int(world), int(rank)
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit() or not 0 <= rank < world:
            raise ValueError("bad address or process id")
    except ValueError as e:
        raise SystemExit(
            f"--dist {spec!r}: expected 'auto' or "
            f"'coordinator:port,num_processes,process_id' ({e})")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return f"tcp://{addr}", world, rank, rank % max(cards, 1)


def init_group(spec: str, device, _backend: Optional[str] = None
               ) -> torch.device:
    """Join the group that ``spec`` names (``parse_spec``); returns this
    process's device: ``cuda:{local_rank}`` (made current) over NCCL for a
    CUDA ``device``, the CPU over gloo. One all-reduce runs before it
    returns. ``_backend="gloo"`` on a card (several ranks on one card,
    eager steps only) is for chip_smoke.py alone."""
    global _group
    if _group is not None:
        raise RuntimeError("a process group is already up")
    init, world, rank, local = parse_spec(spec)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available: pass --device cpu")
        if local >= torch.cuda.device_count():
            raise SystemExit(f"local rank {local} has no card: "
                             f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = _backend or "nccl"
    else:
        if _backend not in (None, "gloo"):
            raise ValueError(f"the CPU takes gloo, not {_backend}")
        backend = "gloo"
    td.init_process_group(backend, init_method=init, world_size=world,
                          rank=rank, timeout=TIMEOUT)
    host = None if backend == "gloo" else td.new_group(backend="gloo",
                                                       timeout=TIMEOUT)
    _group = {"rank": rank, "world": world, "local_rank": local,
              "backend": backend, "device": device, "host": host}
    probe = torch.ones(1, device=device)
    td.all_reduce(probe)
    if float(probe) != world:
        raise RuntimeError(f"the group's first all-reduce gave {float(probe)}"
                           f", not {world}")
    return device


def shutdown(wait: bool = True) -> None:
    """Leave the group, after a last barrier if ``wait``."""
    global _group
    if _group is None:
        return
    if wait:
        barrier()
    td.destroy_process_group()
    _group = None


def active() -> bool:
    return _group is not None


def rank() -> int:
    return _group["rank"] if _group else 0


def world() -> int:
    return _group["world"] if _group else 1


def is_lead() -> bool:
    return rank() == 0


def backend() -> Optional[str]:
    return _group["backend"] if _group else None


def host_group():
    """The gloo group of the host's agreements (the whole group on gloo)."""
    return _group["host"] if _group else None


def barrier() -> None:
    """Every rank waits for the others (on the host's group); nothing
    outside a group."""
    if _group is not None:
        td.barrier(group=host_group())


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank (one host all-reduce), so that
    every rank takes the same branch; ``flag`` outside a group."""
    if _group is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    td.all_reduce(t, op=td.ReduceOp.MAX, group=host_group())
    return bool(t.item())


def from_lead(x: float) -> float:
    """The lead's ``x`` on every rank (the others' ``x`` is not read);
    ``x`` outside a group."""
    if _group is None:
        return x
    t = torch.tensor([float(x) if is_lead() else 0.0], dtype=torch.float64)
    td.all_reduce(t, group=host_group())
    return float(t.item())


def gather_rows(a: np.ndarray) -> np.ndarray:
    """Every rank's rows of ``a`` (the same shape on each), concatenated in
    rank order, on every rank; ``a`` outside a group."""
    if _group is None:
        return a
    t = torch.from_numpy(np.ascontiguousarray(a))
    parts = [torch.empty_like(t) for _ in range(world())]
    td.all_gather(parts, t, group=host_group())
    return torch.cat(parts).numpy()


def _mean_(t: torch.Tensor) -> None:
    """``t`` replaced in place by its mean over the group: NCCL's AVG, or
    gloo's sum x 1/world."""
    if _group["backend"] == "nccl":
        td.all_reduce(t, op=td.ReduceOp.AVG)
    else:
        td.all_reduce(t)
        t.mul_(1.0 / world())


def mean_over_group_(tensors: Sequence[torch.Tensor]) -> None:
    """Each tensor replaced in place by its mean over the group: one
    all-reduce of them all (per dtype). Outside a group it does nothing;
    at world 1 it is exact."""
    if _group is None or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        _mean_(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


class _GroupMean(torch.autograd.Function):
    """Forward: the mean over the group; backward: the mean over the group
    of the gradient (every rank's loss reads the global mean, and the
    steps mean the parameters' gradients over the group)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        _mean_(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        _mean_(g)
        return g


def group_mean(x: torch.Tensor) -> torch.Tensor:
    """The differentiable mean of ``x`` over the group (``x`` outside
    one)."""
    return _GroupMean.apply(x) if _group is not None else x


def check_spatial(spatial: int) -> None:
    if spatial > 1:
        raise SystemExit(SPATIAL_REFUSED)


# ------------------------------------------------- one process, many cards


def mesh_devices(mesh: str, device) -> List[torch.device]:
    """The devices of an inference command's ``--mesh``: every visible card
    for ``auto`` on ``cuda`` (JAX's ``len(jax.devices()) > 1``), else the
    one device."""
    device = torch.device(device)
    if mesh == "auto" and device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def pad_to_multiple(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with its last row repeated until its rows are a multiple of
    ``n`` (the JAX commands' pad); ``t`` itself when they are."""
    pad = (-t.shape[0]) % n
    if not pad:
        return t
    return torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])


class Replicas:
    """The devices of a one-process ``--mesh auto`` (the same device may
    repeat) and the JAX commands' data-parallel call: pad, split, run each
    part on its device, gather, slice back. With one device a call is the
    plain call on the whole batch. ``context(i)`` (default: the card's
    ``torch.cuda.device``) is entered around each part's copy in, its call
    and its copy out."""

    def __init__(self, devices: Sequence, context: Optional[Callable] = None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("Replicas needs at least one device")
        self._context = context or self._device_context

    def _device_context(self, i: int):
        dev = self.devices[i]
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def __len__(self) -> int:
        return len(self.devices)

    def __call__(self, fn: Callable, *batched: torch.Tensor,
                 to=None) -> torch.Tensor:
        """``fn(i, *parts_i)`` on device i, each part a contiguous
        1/len(self) of every padded batched input, moved to that device;
        every part is launched before any output is copied to ``to`` (the
        first device when None), where they are concatenated and the pad
        sliced off."""
        n, k = batched[0].shape[0], len(self.devices)
        split = [pad_to_multiple(t, k).chunk(k) for t in batched]
        outs = []
        for i, dev in enumerate(self.devices):
            with self._context(i):
                outs.append(fn(i, *(s[i].to(dev) for s in split)))
        target = self.devices[0] if to is None else torch.device(to)
        parts = []
        for i, out in enumerate(outs):
            with self._context(i):
                parts.append(out.to(target))
        return parts[0] if k == 1 else torch.cat(parts)[:n]


class GroupSlice:
    """``Replicas``' call over the data-parallel group: this rank's
    contiguous part of each padded batched input, on ``device``, and the
    outputs of every rank gathered in rank order (on the host, on every
    rank) with the pad sliced off. Outside a group it is ``Replicas([
    device])``'s call."""

    def __init__(self, device):
        self.devices = [torch.device(device)]

    def __call__(self, fn: Callable, *batched: torch.Tensor) -> torch.Tensor:
        n, k, r = batched[0].shape[0], world(), rank()
        out = fn(0, *(pad_to_multiple(t, k).chunk(k)[r].to(self.devices[0])
                      for t in batched))
        if k == 1:
            return out
        return torch.from_numpy(gather_rows(out.cpu().numpy()))[:n]
