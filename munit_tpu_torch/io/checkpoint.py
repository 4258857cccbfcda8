"""Whole-state training checkpoints: the port's counterpart of
``munit_tpu/io/checkpoint.py`` (save_checkpoint, latest_step,
restore_checkpoint, CheckpointWriter, resume).

A checkpoint is one file, ``<ckpt_dir>/ckpt_<step:08d>.pt``: a
``torch.save`` of ``{"magic", "step", "state"}``, where ``state`` is
``MUNITTrainer.state_dict()`` on the host (every trainable net's parameters
and buffers, each ExtraAdam state with the extrapolation anchor,
``iterations``, the display styles and the state of the random styles'
stream), so a resume continues exactly, mid-extrapolation too, and with
``guided: 0`` draws the styles that an uninterrupted run would have drawn.
The loaders' draws are a function of seed, epoch and index, so they keep
no state. The frozen segmenter and VGG16 are not saved: they are made again
from ``semantic_ckpt_path`` and ``vgg_model_path`` or their seeds.

A file is written under a temporary name and renamed, so a reader never
sees a torn one. The JAX package's orbax directories (one numbered
directory per step) need JAX to read and are refused.
"""

from __future__ import annotations

import os
import queue
import re
import threading
from typing import Any, Dict, List, Optional

import torch

MAGIC = "munit_tpu_torch-train-v1"
_NAME = re.compile(r"^ckpt_(\d{8})\.pt$")


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:08d}.pt")


def to_host(state: Any) -> Any:
    """A copy of ``state`` with every tensor copied to the CPU (a copy also
    for a CPU tensor, since training goes on in place)."""
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: to_host(v) for k, v in state.items()}
    return state


def _refuse_orbax(ckpt_dir: str) -> None:
    steps = [d for d in os.listdir(ckpt_dir) if d.isdigit()
             and os.path.isdir(os.path.join(ckpt_dir, d))]
    if steps:
        raise ValueError(
            f"{ckpt_dir} holds munit_tpu (JAX, orbax) checkpoints, steps "
            f"{sorted(map(int, steps))}; reading them needs JAX. The port "
            "reads only its own checkpoints (ckpt_<step>.pt).")


def steps(ckpt_dir: str) -> List[int]:
    """The steps of the port's checkpoints in ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    _refuse_orbax(ckpt_dir)
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(ckpt_dir)) if m)


def latest_step(ckpt_dir: str) -> Optional[int]:
    found = steps(ckpt_dir)
    return found[-1] if found else None


def _write(path: str, host_state: Dict, step: int) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"magic": MAGIC, "step": step, "state": host_state}, tmp)
    os.replace(tmp, path)


def _prune(ckpt_dir: str, keep: Optional[int]) -> None:
    if keep is None:
        return
    for step in steps(ckpt_dir)[:-keep]:
        os.remove(checkpoint_path(ckpt_dir, step))


def save_checkpoint(ckpt_dir: str, state: Dict, step: int,
                    keep: Optional[int] = None) -> str:
    """Write ``state`` (a ``state_dict()``) as step ``step``, blocking;
    keep the newest ``keep`` checkpoints (all when None)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    _write(path, to_host(state), step)
    _prune(ckpt_dir, keep)
    return path


def load_checkpoint(path: str) -> Dict:
    """A checkpoint file → ``{"magic", "step", "state"}``; a file of
    another format raises."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("magic") != MAGIC:
        raise ValueError(f"{path} is not a munit_tpu_torch training "
                         f"checkpoint (magic {MAGIC!r})")
    return blob


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None):
    """(state, step) of the latest checkpoint in ``ckpt_dir``, or of
    ``step``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {ckpt_dir}")
    blob = load_checkpoint(checkpoint_path(ckpt_dir, step))
    return blob["state"], int(blob["step"])


def is_training_checkpoint(path: str) -> bool:
    """A directory of the port's checkpoints (the run's ``checkpoints/``)
    or one of its files."""
    if os.path.isdir(path):
        return True
    return bool(_NAME.match(os.path.basename(path)))


def generator_state(path: str) -> Dict[str, torch.Tensor]:
    """The generator's ``state_dict`` from a checkpoint file, or from the
    latest checkpoint of a directory."""
    if os.path.isdir(path):
        state, _ = restore_checkpoint(path)
    else:
        state = load_checkpoint(path)["state"]
    return state["nets"]["gen"]


def resume(trainer, ckpt_dir: str) -> int:
    """Restore the latest checkpoint of ``ckpt_dir`` into ``trainer``
    (trainer.py:1337-1385); returns the iteration to continue from."""
    state, step = restore_checkpoint(ckpt_dir)
    trainer.load_state_dict(state)
    trainer.iterations = step
    print(f"Resume from iteration {step}")
    return step


class CheckpointWriter:
    """Checkpoints written by a thread beside the training loop.

    ``save()`` copies the state to the host before it returns (training
    then goes on changing the tensors in place) and queues the write; a
    thread writes each under a temporary name, renames it and prunes to
    ``keep``. A write's error is raised by the next ``save()`` or by
    ``close()``, which drains the queue."""

    def __init__(self, ckpt_dir: str, keep: Optional[int] = None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            host_state, step = item
            try:
                _write(checkpoint_path(self.ckpt_dir, step), host_state, step)
                _prune(self.ckpt_dir, self.keep)
            except BaseException as e:  # noqa: BLE001 — raised by save/close
                self._error = e

    def _raise(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, state: Dict, step: int) -> None:
        self._raise()
        self._q.put((to_host(state), step))

    def close(self) -> None:
        """Drain pending writes; idempotent."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join()
        self._raise()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
