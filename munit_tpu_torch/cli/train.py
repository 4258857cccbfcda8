"""Training CLI (reference train.py semantics), the port's counterpart of
``munit_tpu/cli/train.py``:

  python -m munit_tpu_torch train --config configs/config_256.yaml \\
      [--output_path out] [--resume] [--seed N] [--device cuda|cpu] \\
      [--dist auto|coordinator:port,num_processes,process_id] [--mesh]

Builds the masked A/B loaders and, when the config's synthetic list exists,
the synthetic-pair loader, copies the config into the run directory
``<output_path>/outputs/<config name>/``, and runs the loop
(``train/loop.py``): ``metrics.jsonl``, ``images/`` grids, ``index.html``
and ``checkpoints/``. ``--resume`` continues exactly from the latest
checkpoint. The config's ``precision:`` (default bf16, the JAX CLI's
default) sets the conv numerics: bf16 conv operands and images, or
``parity``/``f32`` (f32, TF32 off). Runs on the CUDA card by default and
raises without one; ``--device cpu`` runs the kernels' plain versions.

``--seed`` seeds the weights, the loaders' shuffles and the random styles'
stream (``guided: 0``). With ``vgg_w > 0`` the perceptual loss takes the
VGG16 state dict at ``vgg_model_path`` (torchvision's ``features.*`` or the
reference ``Vgg16``'s keys); a path that does not exist stops the run, and
no path means seeded weights, with a warning. With ``eval_fid: 1``,
``inception_ckpt_path`` and ``inception_moment_path``, each snapshot logs
the generator's ``FID`` over the ``data_list_fid_a``/``_b`` pairs.

Data parallel (``dist/mesh.py``), one process a card:

- ``--dist SPEC`` joins a group (JAX's spec, or ``auto`` under torchrun or
  SLURM: ``torchrun --nproc_per_node N -m munit_tpu_torch train ... --dist
  auto``); each process trains on ``cuda:{local rank}`` (NCCL; gloo with
  ``--device cpu``), loads its disjoint shard ``perm[rank::world]`` of
  ``batch_size`` images (the global batch is world x batch_size, as JAX's
  ``--dist``), and means its gradients, metrics and batch-norm statistics
  over the group inside the captured steps. Every rank seeds the same
  weights and style stream and resumes from the same checkpoint; the lead
  alone writes the run directory. In-training FID under ``--dist`` with
  more than one process needs ``--mesh``, as JAX's CLI says.
- ``--mesh`` without ``--dist`` uses every visible card: with N > 1 it
  starts one worker process a card itself, each reading the loader's global
  batch of ``batch_size`` and keeping its contiguous batch_size / N rows
  (JAX's one-loader mesh); with one card, or on the CPU, it is the run
  without ``--mesh``.
- ``--spatial N > 1`` (H-sharded activations) is not ported: ROADMAP
  queue 1 item 16b.
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import socket
import threading

import numpy as np
import torch

from munit_tpu_torch.cli.translate import resolve_device
from munit_tpu_torch.config import flatten_opts, get_config
from munit_tpu_torch.core import ops
from munit_tpu_torch.data.api import (get_all_data_loaders,
                                      get_data_loader_mask_and_im,
                                      get_fid_data_loader,
                                      get_synthetic_data_loader)
from munit_tpu_torch.dist import mesh
from munit_tpu_torch.eval.fid import prepare_inception_metrics
from munit_tpu_torch.eval.inception import load_inception
from munit_tpu_torch.io import checkpoint
from munit_tpu_torch.io.weights import load_segmenter_checkpoint
from munit_tpu_torch.nn.vgg import convert_vgg16_state_dict
from munit_tpu_torch.train.loop import train_loop
from munit_tpu_torch.train.trainer import MUNITTrainer
from munit_tpu_torch.utils.logging import MetricLogger
from munit_tpu_torch.utils.misc import get_git_revision_hash, prepare_sub_folder

# the JAX CLI seeds the frozen segmenter and VGG16 with their own keys,
# whatever --seed
SEGMENTER_SEED = 1
VGG_SEED = 2


def build_loaders(conf, seed=0, **shard):
    """The A and B image-and-mask training loaders, with seeds seed and
    seed + 1, the synthetic-pair loader with seed + 2 when
    ``data_list_train_a_synth`` names a file that exists, so the three
    shuffles are independent, and with ``eval_fid`` and an existing
    ``inception_moment_path`` the FID pairs' loader, which is never sharded
    (``munit_tpu/cli/train.py:33-58``). ``shard``: the training loaders'
    ``shard_index``/``shard_count`` or ``row_index``/``row_count``."""
    kw = dict(new_size=conf["new_size"], height=conf["crop_image_height"],
              width=conf["crop_image_width"], num_workers=conf["num_workers"],
              **shard)
    use_masks = conf["semantic_w"] > 0
    mask_a = conf.get("data_list_train_a_seg") if use_masks else None
    mask_b = conf.get("data_list_train_b_seg") if use_masks else None
    loaders = {
        "a": get_data_loader_mask_and_im(conf["data_list_train_a"], mask_a,
                                         conf["batch_size"], True, seed=seed,
                                         **kw),
        "b": get_data_loader_mask_and_im(conf["data_list_train_b"], mask_b,
                                         conf["batch_size"], True,
                                         seed=seed + 1, **kw)}
    synth = conf.get("data_list_train_a_synth")
    if synth and os.path.exists(str(synth)):
        loaders["synth"] = get_synthetic_data_loader(
            synth, conf["data_list_train_b_synth"],
            conf["data_list_train_b_seg_synth"], conf["seg_list_a"],
            conf["seg_list_b"], conf["batch_size"], True, seed=seed + 2,
            **kw)
    moments = conf.get("inception_moment_path")
    if conf.get("eval_fid", 0) > 0 and moments and os.path.exists(
            str(moments)):
        loaders["fid"] = get_fid_data_loader(
            conf["data_list_fid_a"], conf["data_list_fid_b"],
            max(conf["batch_size_fid"], 1), new_size=conf["new_size"],
            num_workers=conf["num_workers"])
    return loaders


def attach_fid_metrics(conf, loaders, device, use_mesh=False) -> None:
    """In-training FID (reference train.py:119-130 prepared it and never
    called it; the loop's hook at snapshot time runs it once this metric
    function is attached): InceptionV3 from ``inception_ckpt_path`` on
    ``device``, Newton-Schulz on the card and scipy on the CPU, as the JAX
    CLI chooses by backend (``munit_tpu/cli/train.py:61-90``). In a group
    of more than one process it needs ``use_mesh`` (``--mesh``), as JAX's;
    each rank then pools its slice of every FID batch."""
    if "fid" not in loaders:
        return
    ckpt = conf.get("inception_ckpt_path")
    if mesh.world() > 1 and not use_mesh:
        print("WARNING: in-training FID under --dist requires --mesh — "
              "disabled; use cli/evaluate fid offline")
    elif not (ckpt and os.path.exists(str(ckpt))):
        print("WARNING: eval_fid > 0 but inception_ckpt_path missing — "
              "in-training FID disabled")
        return
    else:
        loaders["fid_metrics"] = prepare_inception_metrics(
            conf["inception_moment_path"], load_inception(str(ckpt), device),
            newton_schulz=torch.device(device).type == "cuda",
            mesh=mesh.active())


def display_batch(loader, display: int, device) -> torch.Tensor:
    """The first ``display`` images of a loader's dataset, each drawn with
    rng(index), float32 in [-1, 1] on ``device`` (train.py:132-143)."""
    n = len(loader.dataset)
    skip_bad = os.environ.get("MUNIT_LOADER_SKIP_BAD", "0") == "1"
    imgs, i = [], 0
    while len(imgs) < min(display, n) and i < n:
        try:
            imgs.append(
                loader.dataset.get(i, np.random.default_rng(i))["image"])
        except Exception:  # noqa: BLE001 — skipped only when asked to
            if not skip_bad:
                raise
            print(f"display batch: sample {i} failed; skipping")
        i += 1
    x = np.stack(imgs)
    if x.dtype == np.uint8:   # device_prefetch's normalization, on the host
        x = x.astype(np.float32) / 255.0 * 2.0 - 1.0
    return torch.from_numpy(x).to(device)


def set_precision(conf) -> None:
    """The config's ``precision:`` → the conv numerics (bf16 by default)."""
    prec = str(conf.get("precision", "bf16")).lower()
    if prec in ("bf16", "bfloat16"):
        ops.set_conv_compute(torch.bfloat16)
    elif prec in ("parity", "f32", "float32"):
        ops.set_conv_compute(None)
    else:
        raise ValueError(f"unknown precision: {prec!r}")


def install_stop_handler() -> threading.Event:
    """SIGTERM/SIGINT set the returned event: the loop snapshots and
    returns. A second signal restores the default handler and re-raises,
    so a run stuck before the loop can still be stopped."""
    stop = threading.Event()

    def on_signal(signum, frame):
        if stop.is_set():
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
        stop.set()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, on_signal)
        except ValueError:
            pass  # not the main thread (driven from a test harness)
    return stop


def load_segmenter(trainer, conf) -> None:
    path = conf.get("semantic_ckpt_path")
    if path and os.path.exists(str(path)):
        trainer.load_segmenter(load_segmenter_checkpoint(str(path)))
        return
    print("WARNING: semantic_ckpt_path missing — using random frozen "
          "segmenter weights (loss is well-defined but meaningless)")
    trainer.segmenter.init(torch.Generator().manual_seed(SEGMENTER_SEED))


def load_vgg(trainer, conf) -> None:
    """The perceptual loss's VGG16 as the JAX CLI makes it
    (``munit_tpu/cli/train.py:257-285``)."""
    path = conf.get("vgg_model_path")
    if path and not os.path.exists(str(path)):
        raise SystemExit(
            f"vgg_w > 0 and vgg_model_path={path!r} does not exist; fix the "
            "path or unset vgg_model_path to opt into random-weight VGG16")
    if path:
        trainer.load_vgg(convert_vgg16_state_dict(torch.load(
            str(path), map_location="cpu", weights_only=True)))
        return
    print("WARNING: vgg_model_path missing — using random VGG16 weights for "
          "the perceptual loss")
    trainer.vgg.init(torch.Generator().manual_seed(VGG_SEED))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m munit_tpu_torch train")
    p.add_argument("--config", required=True)
    p.add_argument("--output_path", default=".")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--trainer", default="MUNIT",
                   help="reference train.py flag; every other value exits "
                        "'Only support MUNIT'")
    p.add_argument("--mesh", action="store_true",
                   help="data parallel over every visible card: one worker "
                        "process a card, each with its rows of the batch")
    p.add_argument("--dist", default=None, metavar="SPEC",
                   help="join a data-parallel group, one process a card: "
                        "'auto' (torchrun or SLURM) or "
                        "'coordinator:port,num_processes,process_id'; each "
                        "process loads a disjoint shard of batch_size")
    p.add_argument("--spatial", type=int, default=1,
                   help="H-sharded activations: not ported (ROADMAP 16b)")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="a torch.profiler trace of N iterations (after 2) "
                        "into <run>/trace")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def visible_cards(device) -> int:
    """The cards ``--mesh`` spreads over: those visible for ``cuda``, one
    for the CPU."""
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_worker(index: int, argv, n: int, port: int) -> None:
    opts = parse_args(argv)
    opts.dist = f"localhost:{port},{n},{index}"
    run(opts, rows=(index, n))


def spawn_mesh(argv, n: int) -> None:
    """``--mesh`` over n cards: one worker process a card in a group on a
    free local port, each keeping its rows of every batch."""
    import torch.multiprocessing as mp
    mp.spawn(_mesh_worker, args=(list(argv), n, free_port()), nprocs=n)


def main(argv=None):
    """Train as the config says; returns the iteration reached (None when
    ``--mesh`` started worker processes)."""
    argv = list(argv) if argv is not None else None
    opts = parse_args(argv)
    if opts.trainer != "MUNIT":
        raise SystemExit("Only support MUNIT")   # reference train.py:72
    mesh.check_spatial(opts.spatial)
    if opts.mesh and not opts.dist:
        n = visible_cards(resolve_device(opts.device))
        if n > 1:
            import sys
            spawn_mesh(argv if argv is not None else sys.argv[2:], n)
            return None
    return run(opts)


def run(opts, rows=None) -> int:
    """The run of parsed arguments in this process; ``rows``: (index,
    count) of a ``--mesh`` worker's rows of each batch."""
    # first, so a signal during the set-up still ends in a snapshot
    stop = install_stop_handler()
    device = resolve_device(opts.device)
    if opts.dist:
        device = mesh.init_group(opts.dist, device)
    logger, ok = None, False
    try:
        lead = mesh.is_lead()
        conf = get_config(opts.config)
        set_precision(conf)
        model_name = os.path.splitext(os.path.basename(opts.config))[0]
        output_directory = os.path.join(opts.output_path, "outputs",
                                        model_name)
        ckpt_dir, _ = prepare_sub_folder(output_directory)
        if lead:
            shutil.copy(opts.config,
                        os.path.join(output_directory, "config.yaml"))

        logger = MetricLogger(output_directory, enabled=lead)
        params = dict(flatten_opts(conf))
        git_hash = get_git_revision_hash()
        if git_hash:
            params["git_hash"] = git_hash
        logger.log_parameters(params)

        trainer = MUNITTrainer(conf, device)
        trainer.init(torch.Generator().manual_seed(opts.seed))
        trainer.seed_styles(opts.seed)
        if trainer.segmenter is not None:
            load_segmenter(trainer, conf)
        if trainer.vgg is not None:
            load_vgg(trainer, conf)
        start = checkpoint.resume(trainer, ckpt_dir) if opts.resume else 0

        if rows is not None:
            shard = dict(row_index=rows[0], row_count=rows[1])
        elif mesh.world() > 1:
            shard = dict(shard_index=mesh.rank(), shard_count=mesh.world())
        else:
            shard = {}
        loaders = build_loaders(conf, seed=opts.seed, **shard)
        attach_fid_metrics(conf, loaders, device,
                           use_mesh=opts.mesh or rows is not None)
        display = int(conf["display_size"])
        # the grids are the lead's: the display loaders are not sharded
        display_batches = (tuple(display_batch(ld, display, device)
                                 for ld in get_all_data_loaders(
                                     conf, seed=opts.seed))
                           if lead else None)
        end = train_loop(trainer, conf, loaders, output_directory, logger,
                         start_iteration=start,
                         display_batches=display_batches,
                         profile=(start + 2, opts.profile) if opts.profile
                         else None, stop=stop, device=device)
        ok = True
    finally:
        if logger is not None:
            logger.close()
        # a rank that failed leaves without the last barrier: no rank
        # carries on alone, each fails in its next collective
        mesh.shutdown(wait=ok)
    if stop.is_set() and lead:
        print(f"preempted at iteration {end}; state saved — "
              "restart with --resume to continue exactly")
    return end


if __name__ == "__main__":
    main()
