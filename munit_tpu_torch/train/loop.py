"""The training loop: the reference cadences (train.py:159-330) over the
trainer's steps, the port's counterpart of ``munit_tpu/train/loop.py``.

Per iteration (config_256 in parens), through
``trainer.cadence_iteration`` in the JAX loop's order:
- the dis step, or the fused dis+gen step (``dis_gen_update``, the JAX
  trainer's default, equal to ``dis_update`` then ``gen_update``) when
  (it+1) % ratio_disc_gen == 0 (5);
- the DANN step with domain_adv_w > 0;
- the sim/real classifier step when (it+1) % classif_frequency == 0 (15);
- with a synthetic loader (``configs/final_test/*``), one synthetic batch
  per iteration whatever the branch: the output-level classifier step, the
  fused step on the synthetic pair (ground-truth semantics with
  synthetic_seg_gt: 1) and its classifier step, the seg-head step;
- metrics of every log_iter-th iteration buffered and written every
  ``100 // log_iter`` of them (no per-iteration device sync), with
  ``images_per_sec`` over each written window and the card's memory
  (``hbm_gb_in_use``, ``hbm_gb_peak``);
- sample grids at image_save_iter / image_display_iter, a checkpoint at
  snapshot_save_iter and, with ``eval_fid`` and the loaders' "fid" and
  "fid_metrics" (``cli/train.py::attach_fid_metrics``), the FID of the
  generator at that point, logged as ``FID``; the stop event snapshots and
  returns.

On a card the trainer's steps run as CUDA graphs (``train/graphs.py``):
each step kind's first call runs eagerly, its second captures, later ones
replay.

In a data-parallel group (``dist/mesh.py``) every rank runs the loop on its
part of each global batch; only the lead (rank 0) writes metrics, grids,
``index.html`` and checkpoints (``munit_tpu/train/loop.py:97-98, 260-274``),
and every rank takes part in the in-training FID. Each rank reaches a
barrier after each snapshot and at the end, after the lead's checkpoints
are on disk. The stop event is agreed at each iteration's end (set on any
rank, all snapshot at that step). ``images_per_sec`` counts the global
batch.

A non-finite logged loss raises ``TrainingDiverged`` when its window is
written, which happens before any checkpoint is committed, so the last
checkpoint is never a poisoned one. The FID runs eagerly under no_grad
after the checkpoint is queued: it reads the generator and writes nothing
the steps read (no optimizer state, no graph input, no random stream), so
a run with it takes the same steps as one without (on the CPU bit for
bit; on a card as closely as any two runs, whose reflect-pad backward adds
with atomics).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from munit_tpu_torch.core.ops import conv_compute_dtype
from munit_tpu_torch.data.loader import device_prefetch
from munit_tpu_torch.dist import mesh
from munit_tpu_torch.eval.sample import write_2images
from munit_tpu_torch.io.checkpoint import CheckpointWriter
from munit_tpu_torch.train.trainer import cadence_iteration
from munit_tpu_torch.utils.html import write_html
from munit_tpu_torch.utils.logging import MetricLogger


class TrainingDiverged(RuntimeError):
    """A logged loss went NaN/Inf: the optimizer state is poisoned and
    every later step is garbage; stop instead of training on."""


def device_memory_stats(device) -> Optional[dict]:
    """{hbm_gb_in_use, hbm_gb_peak} of a CUDA device; None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return {"hbm_gb_in_use": torch.cuda.memory_allocated(device) / 2**30,
            "hbm_gb_peak": torch.cuda.max_memory_allocated(device) / 2**30}


def _check_finite(metrics, step):
    """Divergence guard at the metric flush (the scalars were just read for
    logging)."""
    bad = [k for k, v in metrics.items() if not np.isfinite(float(v))]
    if bad:
        raise TrainingDiverged(
            f"non-finite loss at iteration {step}: {', '.join(sorted(bad))}. "
            "Training state is unrecoverable past this point; resume from "
            "the last checkpoint (--resume) with a lower lr or gan_w.")


class _Profile:
    """The --profile window: torch.profiler over ``n`` iterations from
    ``first``, its chrome trace written to ``<out>/trace``. The profiler
    drops device records that the clocks' skew puts outside its window, so
    the window opens and closes with PAD_S of idle."""

    PAD_S = 0.01

    def __init__(self, window, output_directory):
        self.first, self.n = window
        self.dir = os.path.join(output_directory, "trace")
        self.prof = None

    def at(self, iteration):
        if self.prof is None and iteration == self.first:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            time.sleep(self.PAD_S)
        elif self.prof is not None and iteration >= self.first + self.n:
            self.stop()

    def stop(self):
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        time.sleep(self.PAD_S)
        prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.dir, "trace.json"))


def train_loop(trainer, conf, loaders, output_directory: str,
               logger: Optional[MetricLogger] = None,
               start_iteration: int = 0,
               max_iter: Optional[int] = None,
               display_batches=None,
               profile: Optional[tuple] = None,
               stop=None,
               device=None,
               host_seconds: Optional[dict] = None) -> int:
    """Train from ``start_iteration`` to ``max_iter`` (the config's when
    None); returns the iteration reached.

    loaders: {"a", "b"}, image-and-mask loaders, and "synth", the
    synthetic-pair loader, if any (``iter_from`` gives exact data order on
    resume); "fid", the FID pairs, and "fid_metrics", the metric function
    (``eval/fid.py::prepare_inception_metrics``), if any. display_batches:
    (train_a, train_b, test_a, test_b) tensors for the sample grids. profile: (first iteration,
    iterations). stop: a threading.Event; when set, the loop snapshots the
    whole state and returns. device: where the batches go (the trainer's
    when None). host_seconds: a dict to which the host's seconds in each
    stage of an iteration are added: "next_batch" (waiting on the feed),
    "step" (issuing the steps), "bookkeeping" (the rest: metrics, their
    flush, which waits for the card, grids, checkpoints), and
    "iterations"."""
    device = torch.device(device if device is not None else trainer.device)
    lead = mesh.is_lead()
    logger = logger or MetricLogger(output_directory, enabled=lead)
    ckpt_dir = os.path.join(output_directory, "checkpoints")
    img_dir = os.path.join(output_directory, "images")
    max_iter = max_iter or conf["max_iter"]
    display = int(conf["display_size"])
    # bf16 conv operands take bf16 images, as the JAX loop feeds them
    act_dt = conv_compute_dtype()

    def stream(loader):
        src = (loader.iter_from(start_iteration) if start_iteration
               else iter(loader))
        return device_prefetch(src, device, size=2, image_dtype=act_dt)

    it_a, it_b = stream(loaders["a"]), stream(loaders["b"])
    it_s = stream(loaders["synth"]) if loaders.get("synth") else None
    pending = []
    flush_every = max(1, 100 // max(conf["log_iter"], 1))
    ckpt_writer = None
    prof = _Profile(profile, output_directory) if profile else None
    iterations = start_iteration
    tput_t0, tput_imgs = time.monotonic(), 0

    def flush():
        """Log, then divergence-check, the buffered window."""
        for step_, m_ in pending:
            logger.log_metrics(m_, step_)
        for step_, m_ in pending:
            _check_finite(m_, step_)
        pending.clear()

    def writer():
        nonlocal ckpt_writer
        if ckpt_writer is None:
            ckpt_writer = CheckpointWriter(ckpt_dir,
                                           keep=conf.get("snapshot_keep"))
        return ckpt_writer

    try:
        while iterations < max_iter:
            if prof is not None:
                prof.at(iterations)
            t_batch = time.perf_counter()
            ba, bb = next(it_a), next(it_b)
            bs = next(it_s) if it_s is not None else None
            t_step = time.perf_counter()
            trainer.iterations = iterations
            x_a, mask_a = ba["image"], ba["mask"]
            x_b, mask_b = bb["image"], bb["mask"]
            metrics = cadence_iteration(trainer, conf, iterations, x_a, x_b,
                                        mask_a, mask_b, bs)
            t_rest = time.perf_counter()

            tput_imgs += int(x_a.shape[0]) * mesh.world()
            if (iterations + 1) % conf["log_iter"] == 0:
                # device scalars, read in windows: no per-iteration sync
                pending.append((iterations + 1, metrics))
                if len(pending) >= flush_every:
                    flush()
                    dt = time.monotonic() - tput_t0
                    if dt > 0:
                        logger.log_metrics(
                            {"images_per_sec": tput_imgs / dt}, iterations + 1)
                    tput_t0, tput_imgs = time.monotonic(), 0
                    stats = device_memory_stats(device)
                    if stats:
                        logger.log_metrics(stats, iterations + 1)

            if display_batches is not None and lead:
                tr_a, tr_b, te_a, te_b = display_batches
                if (iterations + 1) % conf["image_save_iter"] == 0:
                    write_2images(trainer.sample(te_a, te_b), display,
                                  img_dir, "test_%08d" % (iterations + 1))
                    write_2images(trainer.sample(tr_a, tr_b), display,
                                  img_dir, "train_%08d" % (iterations + 1))
                    write_html(os.path.join(output_directory, "index.html"),
                               iterations + 1, conf["image_save_iter"],
                               img_dir)
                if (iterations + 1) % conf["image_display_iter"] == 0:
                    write_2images(trainer.sample(tr_a, tr_b), display,
                                  img_dir, "train_current")

            if (iterations + 1) % conf["snapshot_save_iter"] == 0:
                # a NaN since the last flush must not reach a checkpoint
                flush()
                if lead:
                    writer().save(trainer.state_dict(), iterations + 1)
                # in-training FID (train.py:119-130 prepared it, never ran
                # it; the JAX loop's hook at snapshot time)
                if conf.get("eval_fid", 0) > 0 and loaders.get("fid_metrics"):
                    fid = loaders["fid_metrics"](trainer, loaders["fid"])
                    logger.log_metrics({"FID": fid}, iterations + 1)
                mesh.barrier()

            iterations += 1
            if host_seconds is not None:
                for k, v in (("next_batch", t_step - t_batch),
                             ("step", t_rest - t_step),
                             ("bookkeeping", time.perf_counter() - t_rest),
                             ("iterations", 1)):
                    host_seconds[k] = host_seconds.get(k, 0) + v
            if mesh.any_rank(stop is not None and stop.is_set()):
                flush()
                if lead:
                    writer().save(trainer.state_dict(), iterations)
                logger.log_metrics({"preempted": 1.0}, iterations)
                if stop is not None:
                    stop.set()
                break
        last_step = pending[-1][0] if pending else None
        flush()   # the last window: logged and divergence-checked
        if last_step is not None:
            dt = time.monotonic() - tput_t0
            if dt > 0 and tput_imgs:
                logger.log_metrics({"images_per_sec": tput_imgs / dt},
                                   last_step)
    finally:
        # on any exit: stop the feed's threads, end the trace, and commit
        # the queued checkpoints before the error (if any) propagates
        for it in (it_a, it_b, it_s):
            if it is not None:
                it.close()
        if prof is not None:
            prof.stop()
        if ckpt_writer is not None:
            ckpt_writer.close()
    mesh.barrier()   # the lead's checkpoints are on disk
    return iterations
