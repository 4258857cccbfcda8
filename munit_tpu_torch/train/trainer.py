"""The MUNIT training steps on one device: ``munit_tpu/train/trainer.py``
for either generator (``gen_state: 1``, the fork's dual generator, or
``gen_state: 0``, upstream MUNIT's two auto-encoders), guided or random
styles (``guided``), with or without the VGG perceptual loss (``vgg_w``),
narrow or wide forwards (``wide``) and gradient accumulation
(``grad_accum``).

- ``dis_update``      ≙ ``_dis_step_impl`` (trainer.py:690-732)
- ``gen_update``      ≙ ``_gen_step_impl`` (:1072-1115)
- ``dis_gen_update``  ≙ the fused ``_dis_gen_step_impl`` (:814-883): one
  generator forward; D is updated first against the detached fakes, then
  the generator's losses are taken against the updated D; at
  ``grad_accum > 1`` ``_dis_gen_step_accum`` (:885-1023)
- ``domain_classifier_update`` ≙ ``_dann_step_impl`` (:1258-1281), the
  A/B content-domain classifier (DANN)
- ``domain_classifier_sr_update`` ≙ ``_classifier_sr_step_impl`` (:1283-1312)
- ``output_domain_classifier_sr_update`` ≙
  ``_output_classifier_sr_step_impl`` (:1314-1333), the output-level
  sim/real classifiers: always a plain step, never an extrapolation
- ``segmentation_head_update`` ≙ ``_seg_head_step_impl`` (:1335-1366)
- ``dis_gen_grads``   ≙ ``dis_gen_grads`` (:1025-1070), the fused step's
  gradients against the current D, with no update
- ``sample``          ≙ ``sample`` (:1474-1515): the display grid's columns
- ``forward``         ≙ ``forward`` (:1443-1454): translations with the fixed
  display styles
- ``state_dict`` / ``load_state_dict``: the whole training state that a
  checkpoint holds (``io/checkpoint.py``), the counterpart of the JAX
  trainer's ``state`` pytree

``gen_update`` and ``dis_gen_update`` take ``synth`` (the synthetic-pair
alignment loss on the pixels where x_a and x_b agree) and ground-truth
semantics ``sem_gt_a``/``sem_gt_b``: the targets of the semantic loss
are then those labels, no pseudo-label pass runs, and the segmenter's 19
logits are merged into the 10 meta-classes (``merge_class_matrix``). The
generator's loss carries the DANN anonymising term (``domain_adv_w``) and
the output-level term (``output_adv_lambda``) beside the feature-level
fool term, each classifier in train-mode batch norm whose statistics are
discarded.

``wide`` follows the JAX trainer (trainer.py:258-268): ``MUNIT_WIDE`` over
the config's ``wide`` over 0 at crops of 512 and more (config_HD) and 1
below; 0 with ``gen_state: 0``. Wide (1) forwards make JAX's ``wide: 1``
calls: one style encode of both domains, the two content encoders as a
pair, one decode per domain over [recon | cross]. Narrow (0) forwards
make its ``wide: 0`` calls (:458-466, :512-529): each domain's encoders on
its own batch and a decode per translation. D runs over [fake | real] and
the frozen segmenter over both image sets at once either way, where JAX's
narrow path (:744-751, :774-782) makes a call each: the math per sample is
the same, and one call is faster on the card.
``wide: 2`` (the domains stacked as grouped convs) is refused. With
``semantic_w > 0`` the frozen ResNet34-8s segments the real images once
per gen step, outside the differentiated part, for its pseudo-label
targets (trainer.py:736-752, 841-843), and the translations inside it for
the semantic loss (:771-782, 1199-1202); its gradient reaches the
translations only. Gradients are taken with
``torch.autograd.grad`` with respect to named parameter lists, so D
collects no generator gradient and no stale ``.grad`` is left; the
optimizers update the parameters in place.

Gradient accumulation (``grad_accum: K`` or ``MUNIT_GRAD_ACCUM``; docs/
PARITY.md #12 and #12b; trainer.py:275-331, 638-686, 885-1023). A chunked
step splits the leading dim of every input (images, masks, ground truth,
random styles drawn for the whole batch first) into K equal micro-batches,
runs its body on each in turn, sums their gradients and metrics from zero
and multiplies by 1/K. Only one micro-batch's autograd residuals are live
at a time: each chunk's forward is dropped before the next starts. The
contract:

- Exact for every full-count-mean loss term, which is every shipped term
  but those of a train-mode batch-norm classifier: with ``adaptation.
  adv_lambda > 0`` or ``domain_adv_w > 0`` each micro-batch's classifier
  normalises with its own chunk's statistics, so those gradients differ
  from K = 1 (the trainer warns, as JAX's does). Pseudo-labels are taken
  per chunk: the frozen segmenter is per sample, so they equal the
  full-batch targets.
- The gen step chunks; the dis step chunks only with ``accum_chunk_dis``
  (its loss is a full-count mean and its forward keeps no residuals).
- The fused step, by default exact (≙ the dis step then the gen step):
  phase A takes D's gradients over one no-grad cross decode of the whole
  batch (chunked with ``accum_chunk_dis``), D steps, then phase B takes
  the generator's gradients over K chunked forwards against the updated D,
  and the generator steps. It costs one inference forward more than K = 1.
- ``accum_shared_fwd: 1`` (``MUNIT_ACCUM_SHARED_FWD=1``): one forward a
  micro-batch serves both D's and the generator's gradients, its
  adversarial terms taken against D before its update (PARITY #12b); both
  updates follow the loop.

Random styles (``guided: 0``): the dis, gen and fused steps draw N(0, I)
styles of shape (B, style_dim) in the images' type, in the JAX trainer's
order (trainer.py:691-694, 828-833, 1074-1080): s_a then s_b; the fused step
the dis step's pair, then the gen step's. The fused step's discriminator
fakes are decodes of its own, without gradient, of the forward's content
codes with the dis styles (:850-859). Each step takes the styles
explicitly (``styles=``, in that order), or draws them with
``draw_style`` from the trainer's ``style_gen``, a ``torch.Generator`` on
its device, on the host side of the step: a captured step reads them from
its input buffers like any input, so a replay sees the draws that an eager
call would. With guided styles no random style reaches a loss
(trainer.py:850-853, 1137-1139), so none is drawn. The display styles
(``display_s_a``, ``display_s_b``) are drawn at ``init``
(trainer.py:374-375), and a checkpoint keeps them with the style stream's
state.

The VGG16 perceptual loss (``vgg_w > 0``, trainer.py:1184-1197) takes the
frozen ``nn/vgg.py`` net, seeded by ``init`` or loaded by ``load_vgg``.

Each update step is host bookkeeping around a device body, as the JAX
trainer's jitted ``_*_step_impl`` are: the host reads the lr and the
ExtraAdam phase, writes the lr and each optimizer's bias correction into
device scalars, runs the body, then advances the optimizers' counts and
anchor flags. The body reads no Python value that changes between
iterations: K and the two accumulation switches are fixed per trainer. On
a CUDA device the bodies run as CUDA graphs, captured once per key and
replayed (``train/graphs.py``); on the CPU they run eagerly.
``dis_gen_grads`` and ``sample`` always run eagerly.

``MUNIT_INT8_DIS=1`` (trainer.py:332-335) runs the generator forward that
makes D's detached fakes in dynamic int8 (``ops.conv_quant``): the dis
step's and, at K > 1, the exact fused step's phase A (trainer.py:700-705,
984), the ``_dis_chunk`` both run; the fakes of the K = 1 and shared-forward
fused steps stay in full precision, as JAX's. The switch is read once per
trainer (``int8_dis_fakes``) and is part of each step's graph key.

Data parallel (``dist/mesh.py``; the JAX trainer under ``--mesh`` or
``--dist``): inside a process group each rank runs the steps on its part of
the global batch. ``_update`` means the gradients over the group before the
optimizer's half-step, and each step means its metrics, inside the step's
body, so a captured step reduces on every replay (over NCCL; a gloo group
on a card runs eagerly, ``_capture=False``); the train-mode batch norms
take the global batch's statistics; ``draw_style`` draws the global batch
of styles from the one seeded stream and keeps this rank's rows; the graph
key holds the group's size. With ``grad_accum`` each rank takes K chunks
of its own part. The result is the one-process step on the global batch.

``check_ported`` reads the JAX trainer's switches and refuses, naming its
ROADMAP item, each that this port lacks.
"""

from __future__ import annotations

import functools
import math
import os
import warnings
from collections import Counter
from typing import Dict, List, Tuple

import numpy as np
import torch

from munit_tpu_torch.config import dis_pyramid_floor, pyramid_message
from munit_tpu_torch.core import ops
from munit_tpu_torch.dist import mesh
from munit_tpu_torch.eval.fid import guided_a2b
from munit_tpu_torch.eval.segmap import decode_segmap
from munit_tpu_torch.losses import losses
from munit_tpu_torch.nn import classifiers, discriminator
from munit_tpu_torch.nn.generator import GenBundle
from munit_tpu_torch.nn.resnet import (NUM_CLASSES, ResNet34_8s,
                                       SegmentationHead, seg_preprocess)
from munit_tpu_torch.nn.vgg import Vgg16
from munit_tpu_torch.optim.extra_adam import (ExtraAdamState,
                                              bias_correction,
                                              extra_adam_advance,
                                              extra_adam_apply,
                                              extra_adam_init)
from munit_tpu_torch.optim.schedule import from_config as schedule_from_config
from munit_tpu_torch.train import graphs

Tensors = Dict[str, torch.Tensor]

# 19 Cityscapes classes → 10 meta-classes (merge_classes, utils.py:
# 1330-1353). Class 0 has no sources: its merged logit is 0, as in the
# reference.
_MERGE_GROUPS = {9: [14, 15, 16], 8: [13, 17, 18], 7: [11, 12], 6: [10],
                 5: [9], 4: [8], 3: [5, 6, 7], 2: [2, 3, 4], 1: [0, 1], 0: []}
GT_CLASSES = 10


def merge_class_matrix() -> np.ndarray:
    """(19, 10) 0/1 matrix: merged logits = logits @ it."""
    m = np.zeros((NUM_CLASSES, GT_CLASSES), np.float32)
    for k, srcs in _MERGE_GROUPS.items():
        for s in srcs:
            m[s, k] = 1.0
    return m


def _switch(env: str, conf: Dict, key: str, default) -> bool:
    """A JAX trainer on/off switch: the environment over the config key
    over the default, on only as "1" (trainer.py:272, 308-321)."""
    return os.environ.get(env, str(conf.get(key, default))) in ("1", 1, True)


def grad_accum_of(conf: Dict) -> int:
    """K: ``MUNIT_GRAD_ACCUM`` over ``grad_accum``, checked with the JAX
    trainer's messages (trainer.py:288-298): the environment bypasses the
    config's validation."""
    k = int(os.environ.get("MUNIT_GRAD_ACCUM",
                           str(conf.get("grad_accum", 1))))
    if k < 1:
        raise ValueError(f"grad_accum must be a positive int, got {k!r}")
    if conf["batch_size"] % k:
        raise ValueError(
            f"batch_size ({conf['batch_size']}) must be divisible by "
            f"grad_accum ({k})")
    return k


def wide_of(conf: Dict) -> int:
    """``MUNIT_WIDE`` over ``wide`` over 0 at crops of 512 and more, else
    1; 0 with ``gen_state: 0`` (trainer.py:258-268)."""
    default = 0 if conf.get("crop_image_height", 256) >= 512 else 1
    wide = int(os.environ.get("MUNIT_WIDE", str(conf.get("wide", default))))
    return wide if conf["gen_state"] == 1 else 0


# the JAX train CLI's remat values that turn it on (cli/train.py:234-239)
_REMAT_ON = ("pads", "hd", "true", "full", "1")


def check_ported(conf: Dict) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for a switch of
    the JAX trainer or its CLI that is set to what this port lacks."""
    if not _switch("MUNIT_FUSED", conf, "fused", 1):
        raise NotImplementedError(
            "MUNIT_FUSED=0 (separate dis and gen steps on gen iterations) is "
            "not ported; ROADMAP queue 1 item 21")
    if str(conf.get("remat", "")).lower() in _REMAT_ON:
        raise NotImplementedError(
            f"remat: {conf['remat']} (rematerialisation) is not ported; "
            "ROADMAP queue 1 item 13c")
    if os.environ.get("MUNIT_SEG_REMAT", "0") == "1":
        raise NotImplementedError(
            "MUNIT_SEG_REMAT=1 (the segmenter rematerialised) is not "
            "ported; ROADMAP queue 1 item 13c")
    if wide_of(conf) >= 2:
        raise NotImplementedError(
            "wide: 2 / MUNIT_WIDE=2 (the two domains stacked as grouped "
            "convs) is not ported; ROADMAP queue 1 item 13b")


def _named(module: torch.nn.Module) -> Tensors:
    return dict(module.named_parameters())


def _group_means(m: Tensors) -> Tensors:
    """A step's metrics, inside a group their means over it (one
    all-reduce)."""
    if not mesh.active():
        return m
    flat = torch.stack([v.detach().float() for v in m.values()])
    mesh.mean_over_group_([flat])
    return {k: f.to(v.dtype) for (k, v), f in zip(m.items(), flat.unbind())}


class MUNITTrainer:
    """The config's nets, optimizer states and training steps on one
    device. Seed the weights with ``init(generator)`` or load them."""

    def __init__(self, conf: Dict, device="cuda", _capture: bool = True):
        """``_capture=False`` runs the steps eagerly on a card too: only for
        comparing the two on the same state."""
        check_ported(conf)
        if dis_pyramid_floor(conf) < 1:
            raise ValueError(pyramid_message(conf))
        self.conf = conf
        self.device = torch.device(device)
        self.gan_type = conf["dis"]["gan_type"]
        self.use_extra = "extra" in conf["optimizer"]
        self.recon_mask = conf["recon_mask"] == 1
        ad = conf["adaptation"]
        self.semantic_w = float(conf["semantic_w"]) > 0
        self.full_adaptation = ad["full_adaptation"] == 1
        self.crop = conf["crop_image_height"]
        self.use_classifier_sr = ad["dfeat_lambda"] > 0
        self.domain_adv_w = float(conf["domain_adv_w"]) > 0
        self.use_output_classifier_sr = ad["output_classifier_lambda"] > 0
        self.train_seg = ad["sem_seg_lambda"] > 0
        self.guided = conf["guided"] == 1
        self.style_dim = conf["gen"]["style_dim"]
        self.wide = wide_of(conf)
        self.grad_accum = grad_accum_of(conf)
        self.accum_shared_fwd = _switch("MUNIT_ACCUM_SHARED_FWD", conf,
                                        "accum_shared_fwd", 0)
        self.accum_chunk_dis = _switch("MUNIT_ACCUM_CHUNK_DIS", conf,
                                       "accum_chunk_dis", 0)
        self.int8_dis_fakes = os.environ.get("MUNIT_INT8_DIS", "0") == "1"
        if self.grad_accum > 1 and (ad["adv_lambda"] > 0
                                    or conf["domain_adv_w"] > 0):
            warnings.warn(
                "grad_accum > 1 with a train-mode BatchNorm classifier "
                "loss (adaptation.adv_lambda > 0 or domain_adv_w > 0): "
                "each micro-batch normalizes with its own chunk "
                "statistics, so these gradients deviate from "
                "grad_accum=1 (all other shipped terms stay exact). "
                "See docs/PARITY.md.", stacklevel=2)
        self.lr_schedule = schedule_from_config(conf)
        self.iterations = 0
        self.hw = {k: float(conf[k]) for k in
                   ("gan_w", "recon_x_w", "recon_s_w", "recon_c_w",
                    "recon_x_cyc_w", "vgg_w", "semantic_w", "domain_adv_w",
                    "recon_synth_w")}
        self.hw["adv_lambda"] = float(ad["adv_lambda"])
        self.hw["output_adv_lambda"] = float(ad["output_adv_lambda"])

        self.gen = GenBundle(conf, device, trainable=True)
        self.dis_a = discriminator.build(conf, device)
        self.dis_b = discriminator.build(conf, device)
        g = conf["gen"]
        content_dim = g["dim"] * 2 ** g["n_downsample"]
        content_hw = tuple(conf[k] // 2 ** g["n_downsample"] for k in
                           ("crop_image_height", "crop_image_width"))
        # the fool term needs the classifiers too (trainer.py:1217-1223)
        self.classifier_sr_a = self.classifier_sr_b = None
        if self.use_classifier_sr or self.hw["adv_lambda"] > 0:
            self.classifier_sr_a, self.classifier_sr_b = (
                classifiers.DomainClassifier(content_dim, content_hw).to(
                    device=device, memory_format=torch.channels_last)
                for _ in range(2))
        # frozen: seeded by init() or loaded by load_segmenter()
        self.segmenter = (ResNet34_8s(NUM_CLASSES).frozen_on(device)
                          if self.semantic_w else None)
        # frozen: seeded by init() or loaded by load_vgg()
        self.vgg = Vgg16().frozen_on(device) if self.hw["vgg_w"] > 0 else None
        # the random styles' stream (seed_styles) and the display styles
        # (drawn by init)
        self.style_gen = torch.Generator(device=self.device)
        self.style_gen.manual_seed(0)
        display = int(conf["display_size"])
        self.display_s_a = torch.zeros(display, self.style_dim,
                                       device=self.device)
        self.display_s_b = torch.zeros_like(self.display_s_a)
        # the 19 → 10 merge of the ground-truth semantic loss, on the device
        # once: a captured step may copy nothing from the host
        self._merge = torch.from_numpy(merge_class_matrix()).to(self.device)

        def on_device(net):
            return net.to(device=device, memory_format=torch.channels_last)
        self.dann = (on_device(classifiers.DomainClassifier(content_dim,
                                                            content_hw))
                     if self.domain_adv_w else None)
        # the gen term needs the output classifiers too (trainer.py:
        # 1227-1233)
        self.output_classifier_sr_a = self.output_classifier_sr_b = None
        if self.use_output_classifier_sr or self.hw["output_adv_lambda"] > 0:
            self.output_classifier_sr_a = discriminator.build(conf, device)
            self.output_classifier_sr_b = discriminator.build(conf, device)
        self.seg_head = (on_device(SegmentationHead(content_dim, GT_CLASSES))
                         if self.train_seg else None)
        self.gen_opt = extra_adam_init(self.gen_params())
        self.dis_opt = extra_adam_init(self.dis_params())
        self.classif_sr_opt = (extra_adam_init(self.classifier_params())
                               if self.classifier_sr_a is not None else None)
        self.dann_opt = (extra_adam_init(_named(self.dann))
                         if self.dann is not None else None)
        self.output_classif_sr_opt = (
            extra_adam_init(self.output_classifier_params())
            if self.output_classifier_sr_a is not None else None)
        self.seg_opt = (extra_adam_init(_named(self.seg_head))
                        if self.seg_head is not None else None)
        # the lr, then each optimizer's bias correction, as the steps read
        # them on the device; written before every step
        self._slot = {k: i + 1 for i, k in enumerate(self._opts())}
        self._scalars = torch.zeros(1 + len(self._slot), device=self.device)
        self._scalar_views = self._scalars.unbind()
        self._capture = _capture and self.device.type == "cuda"
        if self._capture and mesh.active() and mesh.backend() != "nccl":
            raise ValueError(
                f"captured steps reduce over NCCL; this group is "
                f"{mesh.backend()}: pass _capture=False")
        self._graphs = graphs.StepGraphs(self.device)

    # ---------------------------------------------------------- parameters

    def gen_params(self) -> Tensors:
        return _named(self.gen.module)

    def dis_params(self) -> Tensors:
        return {**{f"a.{k}": v for k, v in _named(self.dis_a).items()},
                **{f"b.{k}": v for k, v in _named(self.dis_b).items()}}

    def classifier_params(self) -> Tensors:
        return {
            **{f"a.{k}": v for k, v in _named(self.classifier_sr_a).items()},
            **{f"b.{k}": v for k, v in _named(self.classifier_sr_b).items()}}

    def output_classifier_params(self) -> Tensors:
        return {
            **{f"a.{k}": v
               for k, v in _named(self.output_classifier_sr_a).items()},
            **{f"b.{k}": v
               for k, v in _named(self.output_classifier_sr_b).items()}}

    def init(self, generator: torch.Generator) -> None:
        """Seeded reference init of every net, the frozen ones too, then the
        display styles (N(0, I), float32); the draws are made on the CPU
        from ``generator`` and copied to the device."""
        nets = [self.gen, self.dis_a, self.dis_b]
        if self.classifier_sr_a is not None:
            nets += [self.classifier_sr_a, self.classifier_sr_b]
        if self.segmenter is not None:
            nets.append(self.segmenter)
        nets += [n for n in (self.dann, self.output_classifier_sr_a,
                             self.output_classifier_sr_b, self.seg_head,
                             self.vgg)
                 if n is not None]
        for net in nets:
            net.init(generator)
        with torch.no_grad():
            for t in (self.display_s_a, self.display_s_b):
                t.copy_(torch.randn(t.shape, generator=generator))
        self._graphs.clear()

    def seed_styles(self, seed: int) -> None:
        """Seed the random styles' stream (``guided: 0``)."""
        self.style_gen.manual_seed(seed)

    def draw_style(self, bsz: int, dtype: torch.dtype) -> torch.Tensor:
        """One random style batch: N(0, I) of shape (bsz, style_dim) in
        ``dtype``, from ``style_gen`` on the trainer's device. Inside a
        group, the global batch's draw (bsz x world rows), of which this
        rank keeps its own."""
        world, r = mesh.world(), mesh.rank()
        s = torch.randn((bsz * world, self.style_dim),
                        generator=self.style_gen, device=self.device,
                        dtype=dtype)
        return s if world == 1 else s[r * bsz:(r + 1) * bsz]

    def load_segmenter(self, state_dict: Tensors) -> None:
        """The frozen segmenter's weights, reference ``resnet34_8s.*``
        keys (``io/weights.py::load_segmenter_checkpoint``)."""
        if self.segmenter is None:
            raise ValueError("no segmenter: semantic_w is 0")
        self.segmenter.load_state_dict(state_dict)
        self._graphs.clear()

    def load_vgg(self, state_dict: Tensors) -> None:
        """The frozen VGG16's weights in this port's (the reference
        ``Vgg16``'s) keys (``nn/vgg.py::convert_vgg16_state_dict``)."""
        if self.vgg is None:
            raise ValueError("no VGG: vgg_w is 0")
        self.vgg.load_state_dict(state_dict)
        self._graphs.clear()

    # --------------------------------------------------------------- state

    def _nets(self) -> Dict[str, torch.nn.Module]:
        nets = {"gen": self.gen.module, "dis_a": self.dis_a,
                "dis_b": self.dis_b}
        if self.classifier_sr_a is not None:
            nets.update(classifier_sr_a=self.classifier_sr_a,
                        classifier_sr_b=self.classifier_sr_b)
        if self.dann is not None:
            nets["dann"] = self.dann
        if self.output_classifier_sr_a is not None:
            nets.update(output_classifier_sr_a=self.output_classifier_sr_a,
                        output_classifier_sr_b=self.output_classifier_sr_b)
        if self.seg_head is not None:
            nets["seg_head"] = self.seg_head
        return nets

    def _opts(self) -> Dict[str, ExtraAdamState]:
        opts = {"gen": self.gen_opt, "dis": self.dis_opt,
                "classif_sr": self.classif_sr_opt, "dann": self.dann_opt,
                "output_classif_sr": self.output_classif_sr_opt,
                "seg": self.seg_opt}
        return {k: o for k, o in opts.items() if o is not None}

    def state_dict(self) -> Dict:
        """The whole training state, by reference (no copy): every
        trainable net's parameters and buffers (the classifiers' running
        statistics too), each optimizer's ``ExtraAdamState``,
        ``iterations``, and ``styles``: the display styles and the state of
        the random styles' stream (a copy). The frozen segmenter and VGG
        are not part of it."""
        return {
            "iterations": self.iterations,
            "styles": {"display_s_a": self.display_s_a,
                       "display_s_b": self.display_s_b,
                       "device": self.device.type,
                       "generator": self.style_gen.get_state()},
            "nets": {k: m.state_dict() for k, m in self._nets().items()},
            "opt": {k: {"count": o.count, "mu": o.mu, "nu": o.nu,
                        "params_copy": o.params_copy,
                        "has_copy": o.has_copy}
                    for k, o in self._opts().items()}}

    def load_state_dict(self, state: Dict) -> None:
        """Copy a ``state_dict()`` into this trainer's tensors, in place
        (device and memory format stay, and so do the captured steps); the
        nets and their names must match. A state without ``styles`` leaves
        the display styles and the style stream as they are, and one whose
        stream is of another device type than the trainer's raises."""
        nets, opts = self._nets(), self._opts()
        if set(state["nets"]) != set(nets) or set(state["opt"]) != set(opts):
            raise ValueError(
                f"checkpoint holds nets {sorted(state['nets'])} and "
                f"optimizers {sorted(state['opt'])}; this config has "
                f"{sorted(nets)} and {sorted(opts)}")
        for k, m in nets.items():
            m.load_state_dict(state["nets"][k])
        with torch.no_grad():
            for k, o in opts.items():
                saved = state["opt"][k]
                for field in ("mu", "nu", "params_copy"):
                    dst, src = getattr(o, field), saved[field]
                    if set(dst) != set(src):
                        raise ValueError(f"optimizer {k}.{field}: the "
                                         "checkpoint's names differ")
                    for name, t in dst.items():
                        t.copy_(src[name])
                o.count = int(saved["count"])
                o.has_copy = bool(saved["has_copy"])
            if "styles" in state:
                styles = state["styles"]
                if styles["device"] != self.device.type:
                    raise ValueError(
                        f"the checkpoint's style stream is a "
                        f"{styles['device']} generator's; this trainer's "
                        f"is on {self.device.type}")
                self.display_s_a.copy_(styles["display_s_a"])
                self.display_s_b.copy_(styles["display_s_b"])
                self.style_gen.set_state(styles["generator"])
        self.iterations = int(state["iterations"])

    # ------------------------------------------------------------- forwards

    def _style_codes(self, x_a, x_b):
        """Both domains' style codes: one call of the shared encoder over
        [x_a | x_b] (wide 1), or each domain's own encoder (gen_state 0)."""
        gen = self.gen
        if not self.wide:
            return gen.encode_style(x_a, 1), gen.encode_style(x_b, 2)
        s = gen.encode_style(torch.cat([x_a, x_b]))
        return s[:x_a.shape[0]], s[x_a.shape[0]:]

    def _cross_decode(self, x_a, x_b, styles=()):
        """The cross translations (x_ba, x_ab) of the dis step
        (trainer.py:440-467), with the exemplar styles, or with the random
        ``styles`` (s_a, s_b) when guided is 0."""
        gen = self.gen
        s_a, s_b = styles if styles else self._style_codes(x_a, x_b)
        c_a, c_b = gen.encode_content(x_a, 1), gen.encode_content(x_b, 2)
        return gen.decode(c_b, s_a, 1), gen.decode(c_a, s_b, 2)

    def _gen_forward(self, x_a, x_b, styles=()) -> Tensors:
        """The gen step's generator forward (trainer.py:469-535):
        within-domain recon, cross decode, re-encode, cycle decode. The
        cross decodes take the exemplar styles, or the random ``styles``
        (s_a, s_b) when guided is 0, which are then the style recon's
        targets (``s_a_t``, ``s_b_t``)."""
        gen, bsz = self.gen, x_a.shape[0]
        s_a_p, s_b_p = self._style_codes(x_a, x_b)
        s_a, s_b = styles if styles else (s_a_p, s_b_p)
        c_a, c_b = gen.encode_content(x_a, 1), gen.encode_content(x_b, 2)
        if self.wide:
            # wave 1: [recon | cross] per domain
            out1 = gen.decode(torch.cat([c_a, c_b]), torch.cat([s_a_p, s_a]),
                              1)
            out2 = gen.decode(torch.cat([c_b, c_a]), torch.cat([s_b_p, s_b]),
                              2)
            x_a_recon, x_ba = out1[:bsz], out1[bsz:]
            x_b_recon, x_ab = out2[:bsz], out2[bsz:]
        else:
            x_a_recon, x_b_recon = (gen.decode(c_a, s_a_p, 1),
                                    gen.decode(c_b, s_b_p, 2))
            x_ba, x_ab = gen.decode(c_b, s_a, 1), gen.decode(c_a, s_b, 2)
        # wave 2: re-encode the fakes
        s_a_recon, s_b_recon = self._style_codes(x_ba, x_ab)
        c_b_recon = gen.encode_content(x_ba, 1)
        c_a_recon = gen.encode_content(x_ab, 2)
        fw = dict(c_a=c_a, c_b=c_b, s_a_t=s_a, s_b_t=s_b,
                  x_a_recon=x_a_recon, x_b_recon=x_b_recon, x_ba=x_ba,
                  x_ab=x_ab, c_a_recon=c_a_recon, c_b_recon=c_b_recon,
                  s_a_recon=s_a_recon, s_b_recon=s_b_recon)
        if self.hw["recon_x_cyc_w"] > 0:
            fw["x_aba"] = gen.decode(c_a_recon, s_a_p, 1)
            fw["x_bab"] = gen.decode(c_b_recon, s_b_p, 2)
        return fw

    def _vgg_features(self, img):
        return self.vgg(self.vgg.preprocess(img))

    # ------------------------------------------------------------- semantic

    def _segment(self, img):
        """Frozen segmenter logits (B, H, W, 19) of a [-1, 1] image."""
        return self.segmenter(seg_preprocess(img))

    def _semantic_targets(self, x_a, x_b):
        """Pseudo-labels of the real images (trainer.py:736-752): one pass
        over [x_a | x_b] whatever ``wide``, outside any gradient (the
        frozen segmenter in eval mode gives each sample the same logits as
        JAX's narrow passes, one per image set)."""
        if not self.semantic_w:
            return None
        with torch.no_grad():
            t = self._segment(torch.cat([x_a, x_b])).argmax(dim=-1)
        bsz = x_a.shape[0]
        return t[:bsz], t[bsz:]

    def _sem_loss_from_logits(self, logits, target, mask, has_gt=False):
        """Masked CE, the mask resized to the crop; plain CE with
        ``full_adaptation: 1`` (trainer.py:754-763). Against ground-truth
        targets the 19 logits are merged into the 10 meta-classes first."""
        n_cls = NUM_CLASSES
        if has_gt:
            logits, n_cls = logits @ self._merge, GT_CLASSES
        if self.full_adaptation:
            return losses.cross_entropy_loss(logits, target)
        m = ops.resize_nearest(mask, (self.crop, self.crop))[..., 0]
        return losses.semantic_seg_loss_masked(logits, target, m, n_cls)

    def _semantic_loss_pair(self, x_ab, x_ba, targets, mask_a, mask_b,
                            has_gt=False):
        """Both translations through one segmenter pass whatever ``wide``,
        as ``_semantic_targets``, held against the targets of their
        sources: x_ab against (t_a, mask_a), x_ba against (t_b, mask_b)
        (trainer.py:771-782, 1199-1202)."""
        bsz = x_ab.shape[0]
        logits = self._segment(torch.cat([x_ab, x_ba]))
        t_a, t_b = targets
        return (self._sem_loss_from_logits(logits[:bsz], t_a, mask_a, has_gt)
                + self._sem_loss_from_logits(logits[bsz:], t_b, mask_b,
                                             has_gt))

    def _targets(self, x_a, x_b, sem_gt_a, sem_gt_b):
        """The semantic loss's targets: the ground-truth labels when given
        (no segmenter pass), else the pseudo-labels."""
        if sem_gt_a is not None:
            return sem_gt_a.long(), sem_gt_b.long()
        return self._semantic_targets(x_a, x_b)

    def _dis_apply_fr(self, dis, x_fake, x_real):
        """One D pass over [fake | real] → (outs_fake, outs_real)."""
        bsz = x_fake.shape[0]
        outs = dis(torch.cat([x_fake, x_real]))
        return [o[:bsz] for o in outs], [o[bsz:] for o in outs]

    def _dis_loss(self, x_ba, x_ab, x_a, x_b):
        """calc_dis_loss of both discriminators (trainer.py:784-812), each
        over [fake | real] whatever ``wide``: the JAX trainer's narrow path
        applies D to each apart, the same math per sample."""
        fa, ra = self._dis_apply_fr(self.dis_a, x_ba, x_a)
        fb, rb = self._dis_apply_fr(self.dis_b, x_ab, x_b)
        la = losses.dis_gan_loss(fa, ra, self.gan_type)
        lb = losses.dis_gan_loss(fb, rb, self.gan_type)
        total = self.hw["gan_w"] * (la + lb)
        return total, {"loss_dis_a": la, "loss_dis_b": lb,
                       "loss_dis_total": total}

    def _gen_loss(self, fw, x_a, x_b, mask_a, mask_b, sem_targets,
                  synth=False, has_gt=False):
        """The gen step's loss over a generator forward (trainer.py:
        1117-1256), against the current weights of D and the classifiers;
        the classifiers' batch statistics are discarded. ``sem_targets``:
        (t_a, t_b), the pseudo-labels or the ground truth (``has_gt``), or
        None when semantic_w is 0. ``synth``: a synthetic pair, whose
        translations are held to the other image where the two agree."""
        hw, l1 = self.hw, losses.recon_l1
        m = {"loss_gen_recon_x_a": l1(fw["x_a_recon"], x_a),
             "loss_gen_recon_x_b": l1(fw["x_b_recon"], x_b),
             "loss_gen_recon_s_a": l1(fw["s_a_recon"], fw["s_a_t"]),
             "loss_gen_recon_s_b": l1(fw["s_b_recon"], fw["s_b_t"]),
             "loss_gen_recon_c_a": l1(fw["c_a_recon"], fw["c_a"]),
             "loss_gen_recon_c_b": l1(fw["c_b_recon"], fw["c_b"])}
        zero = torch.zeros((), device=x_a.device)
        if "x_aba" in fw:
            if self.recon_mask:
                m["loss_gen_cycrecon_x_a"] = losses.recon_l1_masked(
                    fw["x_aba"], x_a, mask_a)
                m["loss_gen_cycrecon_x_b"] = losses.recon_l1_masked(
                    fw["x_bab"], x_b, mask_b)
            else:
                m["loss_gen_cycrecon_x_a"] = l1(fw["x_aba"], x_a)
                m["loss_gen_cycrecon_x_b"] = l1(fw["x_bab"], x_b)
        else:
            m["loss_gen_cycrecon_x_a"] = m["loss_gen_cycrecon_x_b"] = zero
        if synth:
            # the pixels where the pair agrees exactly, in the inputs' type
            # (trainer.py:1160-1168)
            aligned = ((x_a - x_b).abs().sum(dim=-1, keepdim=True)
                       == 0).to(x_a.dtype)
            m["loss_gen_recon_synth"] = (
                losses.recon_l1_masked(fw["x_ab"], x_b, 1.0 - aligned)
                + losses.recon_l1_masked(fw["x_ba"], x_a, 1.0 - aligned))
        else:
            m["loss_gen_recon_synth"] = zero
        m["loss_gen_adv_a"] = losses.gen_gan_loss(self.dis_a(fw["x_ba"]),
                                                  self.gan_type)
        m["loss_gen_adv_b"] = losses.gen_gan_loss(self.dis_b(fw["x_ab"]),
                                                  self.gan_type)
        if self.vgg is not None:
            feats = self._vgg_features
            m["loss_gen_vgg_a"] = losses.vgg_perceptual_loss(
                feats(fw["x_ba"]), feats(x_b))
            m["loss_gen_vgg_b"] = losses.vgg_perceptual_loss(
                feats(fw["x_ab"]), feats(x_a))
        else:
            m["loss_gen_vgg_a"] = m["loss_gen_vgg_b"] = zero
        if self.semantic_w:
            m["loss_sem_seg"] = self._semantic_loss_pair(
                fw["x_ab"], fw["x_ba"], sem_targets, mask_a, mask_b, has_gt)
        else:
            m["loss_sem_seg"] = zero
        if self.domain_adv_w:
            # anonymise the content codes (trainer.py:1206-1214)
            m["domain_adv_loss_gen"] = losses.domain_adv_loss(
                self.dann(fw["c_a"]), self.dann(fw["c_b"]), minimize=False)
        else:
            m["domain_adv_loss_gen"] = zero
        if hw["adv_lambda"] > 0:
            m["loss_classifier_adv_sr"] = losses.classifier_sr_loss(
                self.classifier_sr_a(fw["c_a"]),
                self.classifier_sr_b(fw["c_b"]), domain_synth=synth,
                fool=True)
        else:
            m["loss_classifier_adv_sr"] = zero
        if hw["output_adv_lambda"] > 0:
            m["loss_output_classifier_adv_sr"] = (
                losses.gen_sr_loss(self.output_classifier_sr_a(fw["x_ba"]))
                + losses.gen_sr_loss(self.output_classifier_sr_b(fw["x_ab"])))
        else:
            m["loss_output_classifier_adv_sr"] = zero
        # the JAX package's order of the sum
        total = (hw["gan_w"] * (m["loss_gen_adv_a"] + m["loss_gen_adv_b"])
                 + hw["recon_x_w"] * (m["loss_gen_recon_x_a"]
                                      + m["loss_gen_recon_x_b"])
                 + hw["recon_s_w"] * (m["loss_gen_recon_s_a"]
                                      + m["loss_gen_recon_s_b"])
                 + hw["recon_c_w"] * (m["loss_gen_recon_c_a"]
                                      + m["loss_gen_recon_c_b"])
                 + hw["recon_x_cyc_w"] * (m["loss_gen_cycrecon_x_a"]
                                          + m["loss_gen_cycrecon_x_b"])
                 + hw["vgg_w"] * (m["loss_gen_vgg_a"] + m["loss_gen_vgg_b"])
                 + hw["semantic_w"] * m["loss_sem_seg"]
                 + hw["domain_adv_w"] * m["domain_adv_loss_gen"]
                 + hw["recon_synth_w"] * m["loss_gen_recon_synth"]
                 + hw["adv_lambda"] * m["loss_classifier_adv_sr"]
                 + hw["output_adv_lambda"]
                 * m["loss_output_classifier_adv_sr"])
        m["loss_gen_total"] = total
        return total, m

    def _masks(self, x_a, mask_a, mask_b):
        z = None
        if mask_a is None or mask_b is None:
            z = torch.zeros_like(x_a[..., :1])
        return (mask_a if mask_a is not None else z,
                mask_b if mask_b is not None else z)

    @staticmethod
    def _grads(loss, params: Tensors) -> Tensors:
        names = list(params)
        gs = torch.autograd.grad(loss, [params[k] for k in names])
        return dict(zip(names, gs))

    def _accum(self, chunk_fn, inputs, chunked=True) -> Tuple[Tensors,
                                                              Tensors]:
        """``chunk_fn(*inputs) -> (grads, metrics)``, or with K > 1 and
        ``chunked`` its mean over K equal slices of every input's leading
        dim (None stays None), run one after another: the sums start from
        zero and are multiplied by 1/K, as ``_accum_grads`` does
        (trainer.py:638-686). A chunk's forward is dropped before the next
        one runs."""
        k = self.grad_accum
        if k == 1 or not chunked:
            return chunk_fn(*inputs)
        bsz = next(t for t in inputs if t is not None).shape[0]
        if bsz % k:
            raise ValueError(f"batch {bsz} not divisible by grad_accum {k}")
        parts = [(None,) * k if t is None else t.chunk(k) for t in inputs]
        sums = None
        for i in range(k):
            out = chunk_fn(*(p[i] for p in parts))
            if sums is None:
                sums = tuple({n: torch.zeros_like(v) for n, v in d.items()}
                             for d in out)
            for acc, d in zip(sums, out):
                torch._foreach_add_(list(acc.values()),
                                    [v.detach() for v in d.values()])
            del out
        for acc in sums:
            torch._foreach_mul_(list(acc.values()), 1.0 / k)
        return sums

    # ---------------------------------------------------------- optimizer

    def _phase(self) -> bool:
        """ExtraAdam parity: extrapolate on even iterations (trainer.py:229)."""
        return bool(self.use_extra and self.iterations % 2 == 0)

    def _lr(self) -> float:
        return float(self.lr_schedule(self.iterations))

    def _update(self, grads, name, params, extrapolate):
        """An optimizer's half-step on the device, with the lr and its bias
        correction read from the device scalars; inside a group, on the
        gradients' mean over it."""
        c = self.conf
        mesh.mean_over_group_(list(grads.values()))
        extra_adam_apply(grads, self._opts()[name], params,
                         self._scalar_views[0],
                         self._scalar_views[self._slot[name]], extrapolate,
                         b1=c["beta1"], b2=c["beta2"], eps=1e-8,
                         weight_decay=c["weight_decay"])

    def _write_scalars(self, lr: float) -> None:
        """One fill each: a kernel that carries its value, so that the host
        neither waits for the card nor keeps a buffer for it."""
        c = self.conf
        vals = [lr] + [bias_correction(o.count + 1, c["beta1"], c["beta2"])
                       for o in self._opts().values()]
        for t, v in zip(self._scalar_views, vals):
            t.fill_(v)

    def _step(self, kind, body, tensors, opts, static=(), lr_metric=False,
              phase=None):
        """One update step: the host's bookkeeping around ``body(
        extrapolate, *static, *tensors)``, its device work, which updates
        the optimizers ``opts``. ``phase`` pins the ExtraAdam phase (the
        iteration's when None). Returns the body's metrics, detached."""
        lr = self._lr()
        extrapolate = self._phase() if phase is None else phase
        self._write_scalars(lr)
        states = [self._opts()[k] for k in opts]

        def run(*ts):
            return _group_means(body(extrapolate, *static, *ts))
        if self._capture:
            key = graphs.step_key(kind, extrapolate,
                                  [o.has_copy for o in states], tensors,
                                  static + (("world", mesh.world()),
                                            ("int8_dis", self.int8_dis_fakes)))
            m = self._graphs.run(key, run, tensors)
        else:
            m = {k: v.detach() for k, v in run(*tensors).items()}
        for o in states:
            extra_adam_advance(o, extrapolate)
        if lr_metric:
            m["lr"] = lr
        return m

    # --------------------------------------------------------------- steps

    def _styles(self, styles, n: int, x) -> tuple:
        """A step's random styles (guided 0): ``styles`` as given, or ``n``
        draws in x's type, in order; none with guided styles."""
        if self.guided:
            if styles is not None:
                raise ValueError("guided: 1 takes no random styles")
            return ()
        if styles is None:
            return tuple(self.draw_style(x.shape[0], x.dtype)
                         for _ in range(n))
        if len(styles) != n:
            raise ValueError(f"this step takes {n} style batches, got "
                             f"{len(styles)}")
        return tuple(styles)

    def dis_update(self, x_a, x_b, styles=None) -> Tensors:
        """One discriminator step against detached fakes. ``styles``:
        (s_a, s_b) with guided 0, drawn when None."""
        return self._step("dis", self._dis_body,
                          (x_a, x_b, *self._styles(styles, 2, x_a)),
                          ("dis",), lr_metric=True)

    def _dis_chunk(self, x_a, x_b, *styles):
        """D's gradients and metrics on detached cross decodes (int8 with
        ``MUNIT_INT8_DIS=1``)."""
        with torch.no_grad(), ops.conv_quant(self.int8_dis_fakes):
            x_ba, x_ab = self._cross_decode(x_a, x_b, styles)
        total, m = self._dis_loss(x_ba, x_ab, x_a, x_b)
        return self._grads(total, self.dis_params()), m

    def _dis_body(self, extrapolate, x_a, x_b, *styles) -> Tensors:
        grads, m = self._accum(self._dis_chunk, (x_a, x_b, *styles),
                               self.accum_chunk_dis)
        self._update(grads, "dis", self.dis_params(), extrapolate)
        return m

    def _gen_inputs(self, x_a, x_b, mask_a, mask_b, synth, sem_gt_a,
                    sem_gt_b, styles, n_styles):
        """(tensors, static) of a gen or fused step: the images, masks,
        ground truth if given and random styles; whether the pair is
        synthetic and whether ground truth is given are static, as the JAX
        steps' ``static_argnames``."""
        has_gt = sem_gt_a is not None
        if has_gt != (sem_gt_b is not None):
            raise ValueError("give both ground-truth maps or neither")
        tensors = (x_a, x_b, mask_a, mask_b)
        if has_gt:
            tensors += (sem_gt_a, sem_gt_b)
        tensors += self._styles(styles, n_styles, x_a)
        return tensors, (bool(synth), has_gt)

    def _split_gen_inputs(self, has_gt, x_a, mask_a, mask_b, rest):
        """(mask_a, mask_b, sem_gt_a, sem_gt_b, styles) of a gen or fused
        body's inputs after the images: zero masks for those not given."""
        mask_a, mask_b = self._masks(x_a, mask_a, mask_b)
        if has_gt:
            return mask_a, mask_b, rest[0], rest[1], rest[2:]
        return mask_a, mask_b, None, None, rest

    def gen_update(self, x_a, x_b, mask_a=None, mask_b=None, synth=False,
                   sem_gt_a=None, sem_gt_b=None, styles=None) -> Tensors:
        """One generator step against the current discriminators.
        ``styles``: (s_a, s_b) with guided 0, drawn when None."""
        tensors, static = self._gen_inputs(x_a, x_b, mask_a, mask_b, synth,
                                           sem_gt_a, sem_gt_b, styles, 2)
        return self._step("gen", self._gen_body, tensors, ("gen",),
                          static=static)

    def _gen_chunk(self, synth, has_gt, x_a, x_b, mask_a, mask_b, sem_gt_a,
                   sem_gt_b, *styles):
        """The generator's gradients and metrics against the current D."""
        targets = self._targets(x_a, x_b, sem_gt_a, sem_gt_b)
        total, m = self._gen_loss(self._gen_forward(x_a, x_b, styles), x_a,
                                  x_b, mask_a, mask_b, targets, synth, has_gt)
        return self._grads(total, self.gen_params()), m

    def _gen_body(self, extrapolate, synth, has_gt, x_a, x_b, mask_a, mask_b,
                  *rest) -> Tensors:
        mask_a, mask_b, sem_gt_a, sem_gt_b, styles = self._split_gen_inputs(
            has_gt, x_a, mask_a, mask_b, rest)
        grads, m = self._accum(
            functools.partial(self._gen_chunk, synth, has_gt),
            (x_a, x_b, mask_a, mask_b, sem_gt_a, sem_gt_b, *styles))
        self._update(grads, "gen", self.gen_params(), extrapolate)
        return m

    def dis_gen_update(self, x_a, x_b, mask_a=None, mask_b=None,
                       synth=False, sem_gt_a=None, sem_gt_b=None,
                       styles=None) -> Tensors:
        """The fused dis + gen step: one generator forward; D steps first on
        its detached cross decodes, then the generator's losses are taken
        against the updated D (at K > 1 the module docstring's variants).
        With guided 0, D's fakes are decodes of their own with the dis
        styles, and ``styles`` is (dis s_a, dis s_b, gen s_a, gen s_b),
        drawn when None."""
        tensors, static = self._gen_inputs(x_a, x_b, mask_a, mask_b, synth,
                                           sem_gt_a, sem_gt_b, styles, 4)
        return self._step("dis_gen", self._dis_gen_body, tensors,
                          ("dis", "gen"), static=static, lr_metric=True)

    def _dis_fakes(self, fw, styles):
        """The fused step's fakes for D: the forward's cross decodes with
        guided styles; else decodes of the forward's content codes with the
        dis styles, without gradient (trainer.py:850-859)."""
        if not styles:
            return fw["x_ba"].detach(), fw["x_ab"].detach()
        s_a, s_b = styles
        with torch.no_grad():
            return (self.gen.decode(fw["c_b"], s_a, 1),
                    self.gen.decode(fw["c_a"], s_b, 2))

    def _shared_chunk(self, synth, has_gt, x_a, x_b, mask_a, mask_b,
                      sem_gt_a, sem_gt_b, *styles):
        """One forward serving D's gradients and the generator's, both
        against the current D: {"dis": ..., "gen": ...} and the metrics."""
        targets = self._targets(x_a, x_b, sem_gt_a, sem_gt_b)
        fw = self._gen_forward(x_a, x_b, styles[2:])
        total_d, m_dis = self._dis_loss(*self._dis_fakes(fw, styles[:2]),
                                        x_a, x_b)
        grads = {f"dis/{k}": g for k, g in self._grads(
            total_d, self.dis_params()).items()}
        total_g, m_gen = self._gen_loss(fw, x_a, x_b, mask_a, mask_b,
                                        targets, synth, has_gt)
        grads.update((f"gen/{k}", g) for k, g in self._grads(
            total_g, self.gen_params()).items())
        return grads, {**m_dis, **m_gen}

    def _dis_gen_body(self, extrapolate, synth, has_gt, x_a, x_b, mask_a,
                      mask_b, *rest) -> Tensors:
        mask_a, mask_b, sem_gt_a, sem_gt_b, styles = self._split_gen_inputs(
            has_gt, x_a, mask_a, mask_b, rest)
        dis_params, gen_params = self.dis_params(), self.gen_params()
        if self.grad_accum > 1 and self.accum_shared_fwd:
            grads, m = self._accum(
                functools.partial(self._shared_chunk, synth, has_gt),
                (x_a, x_b, mask_a, mask_b, sem_gt_a, sem_gt_b, *styles))
            for name, params in (("dis", dis_params), ("gen", gen_params)):
                self._update({k: grads[f"{name}/{k}"] for k in params}, name,
                             params, extrapolate)
            return m
        if self.grad_accum > 1:
            # phase A: D's gradients over a no-grad cross decode, D steps;
            # phase B: the generator's, chunked, against the updated D
            grads_d, m_dis = self._accum(self._dis_chunk,
                                         (x_a, x_b, *styles[:2]),
                                         self.accum_chunk_dis)
            self._update(grads_d, "dis", dis_params, extrapolate)
            del grads_d
            grads_g, m_gen = self._accum(
                functools.partial(self._gen_chunk, synth, has_gt),
                (x_a, x_b, mask_a, mask_b, sem_gt_a, sem_gt_b, *styles[2:]))
            self._update(grads_g, "gen", gen_params, extrapolate)
            return {**m_dis, **m_gen}
        targets = self._targets(x_a, x_b, sem_gt_a, sem_gt_b)
        fw = self._gen_forward(x_a, x_b, styles[2:])
        total_d, m_dis = self._dis_loss(*self._dis_fakes(fw, styles[:2]),
                                        x_a, x_b)
        self._update(self._grads(total_d, dis_params), "dis", dis_params,
                     extrapolate)
        total_g, m_gen = self._gen_loss(fw, x_a, x_b, mask_a, mask_b,
                                        targets, synth, has_gt)
        self._update(self._grads(total_g, gen_params), "gen", gen_params,
                     extrapolate)
        return {**m_dis, **m_gen}

    def dis_gen_grads(self, x_a, x_b, mask_a=None,
                      mask_b=None) -> Tuple[Tensors, Tensors]:
        """(dis grads, gen grads) of one fused step, both against the
        current D, with no update (trainer.py:1025-1070), inside a group
        their means over it; guided styles only, as in the JAX package."""
        if not self.guided:
            raise ValueError("dis_gen_grads takes guided styles only")
        mask_a, mask_b = self._masks(x_a, mask_a, mask_b)
        targets = self._semantic_targets(x_a, x_b)
        fw = self._gen_forward(x_a, x_b)
        total_d, _ = self._dis_loss(fw["x_ba"].detach(), fw["x_ab"].detach(),
                                    x_a, x_b)
        grads_d = self._grads(total_d, self.dis_params())
        total_g, _ = self._gen_loss(fw, x_a, x_b, mask_a, mask_b, targets)
        grads_g = self._grads(total_g, self.gen_params())
        mesh.mean_over_group_([*grads_d.values(), *grads_g.values()])
        return grads_d, grads_g

    @torch.no_grad()
    def _content_codes(self, x_a, x_b):
        """Detached content codes of both domains."""
        return self.gen.encode_content(x_a, 1), self.gen.encode_content(x_b, 2)

    def domain_classifier_update(self, x_a, x_b) -> Tensors:
        """One step of the A/B content-domain classifier (DANN) on detached
        content codes: its batch statistics chain, the b pass starting from
        what the a pass wrote."""
        return self._step("dann", self._dann_body, (x_a, x_b), ("dann",))

    def _dann_body(self, extrapolate, x_a, x_b) -> Tensors:
        c_a, c_b = self._content_codes(x_a, x_b)
        params = _named(self.dann)
        out_a = self.dann(c_a, update_stats=True)
        out_b = self.dann(c_b, update_stats=True)
        loss = losses.domain_adv_loss(out_a, out_b, minimize=True)
        self._update(self._grads(loss, params), "dann", params, extrapolate)
        return {"domain_class_loss": loss,
                "prob_a_as_a": torch.sigmoid(out_a[0, 0]),
                "prob_b_as_b": torch.sigmoid(out_b[0, 0])}

    def domain_classifier_sr_update(self, x_a, x_b, domain_synth: bool,
                                    lamb: float) -> Tensors:
        """One step of the sim/real classifiers on detached content codes;
        each keeps its own batch-statistics update."""
        return self._step("classifier_sr", self._classifier_sr_body,
                          (x_a, x_b), ("classif_sr",),
                          static=(bool(domain_synth), float(lamb)))

    def _classifier_sr_body(self, extrapolate, domain_synth, lamb, x_a,
                            x_b) -> Tensors:
        c_a, c_b = self._content_codes(x_a, x_b)
        params = self.classifier_params()
        loss = lamb * losses.classifier_sr_loss(
            self.classifier_sr_a(c_a, update_stats=True),
            self.classifier_sr_b(c_b, update_stats=True),
            domain_synth=domain_synth, fool=False)
        self._update(self._grads(loss, params), "classif_sr", params,
                     extrapolate)
        return {"loss_classifier_sr": loss}

    def output_domain_classifier_sr_update(self, x_ar, x_as, x_br,
                                           x_bs) -> Tensors:
        """One step of the output-level sim/real classifiers: each domain's
        MsImageDis takes its synthetic images to 0 and its real ones to 1,
        scaled by ``output_classifier_lambda``. The reference calls the
        optimizer's plain ``step()`` (trainer.py:1279): never an
        extrapolation, whatever the iteration's phase."""
        lamb = float(self.conf["adaptation"]["output_classifier_lambda"])
        return self._step("output_classifier_sr",
                          self._output_classifier_sr_body,
                          (x_ar, x_as, x_br, x_bs), ("output_classif_sr",),
                          static=(lamb,), phase=False)

    def _output_classifier_sr_body(self, extrapolate, lamb, x_ar, x_as, x_br,
                                   x_bs) -> Tensors:
        params = self.output_classifier_params()
        sim_b, real_b = self._dis_apply_fr(self.output_classifier_sr_b, x_bs,
                                           x_br)
        sim_a, real_a = self._dis_apply_fr(self.output_classifier_sr_a, x_as,
                                           x_ar)
        loss = lamb * (losses.dis_sr_loss(sim_b, real_b)
                       + losses.dis_sr_loss(sim_a, real_a))
        self._update(self._grads(loss, params), "output_classif_sr", params,
                     extrapolate)
        return {"loss_output_classifier_sr": loss}

    def segmentation_head_update(self, x_a, x_b, target_a,
                                 target_b) -> Tensors:
        """One step of the seg head on detached content codes against
        ground-truth labels (B, H, W) at the crop: the head runs on a, then
        on b from the statistics a wrote; its logits are resized
        bilinearly to the crop; the loss is ``sem_seg_lambda`` times the sum
        of the two CEs."""
        lamb = float(self.conf["adaptation"]["sem_seg_lambda"])
        return self._step("seg_head", self._seg_head_body,
                          (x_a, x_b, target_a, target_b), ("seg",),
                          static=(lamb,))

    def _seg_head_body(self, extrapolate, lamb, x_a, x_b, target_a,
                       target_b) -> Tensors:
        c_a, c_b = self._content_codes(x_a, x_b)
        params = _named(self.seg_head)
        size = (self.crop, self.crop)
        out_a = ops.resize_bilinear(self.seg_head(c_a, update_stats=True),
                                    size)
        out_b = ops.resize_bilinear(self.seg_head(c_b, update_stats=True),
                                    size)
        loss = lamb * (losses.cross_entropy_loss(out_a, target_a)
                       + losses.cross_entropy_loss(out_b, target_b))
        self._update(self._grads(loss, params), "seg", params, extrapolate)
        return {"loss_semantic_head": loss}

    # ------------------------------------------------------------ sampling

    @torch.no_grad()
    def forward(self, x_a, x_b) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x_ab, x_ba) with the fixed display styles (MUNIT_Trainer.forward,
        trainer.py:1443-1454)."""
        gen, n = self.gen, x_a.shape[0]
        x_ba = gen.decode(gen.encode_content(x_b, 2), self.display_s_a[:n], 1)
        x_ab = gen.decode(gen.encode_content(x_a, 1), self.display_s_b[:n], 2)
        return x_ab, x_ba

    @torch.no_grad()
    def sample_fid(self, x_a, x_b) -> torch.Tensor:
        """The FID translation (trainer.py:1465-1472): a's content decoded
        with b's style into domain b, for either gen_state and guided
        setting; eager, outside the captured steps, and no draw from any
        generator."""
        return guided_a2b(self.gen, x_a, x_b)

    @torch.no_grad()
    def sample(self, x_a, x_b) -> Tuple[torch.Tensor, ...]:
        """The display grid's columns (trainer.py:1474-1515): per direction
        (x, recon, x_ab1, x_ab2). Guided, both translations take the other
        domain's image's style; with guided 0, x_ab1 takes the fixed display
        style and x_ab2 a draw of a fresh generator seeded 0, made anew on
        each call (on the CPU, then moved), as the JAX loop calls ``sample``
        without an rng. With the segmenter, 12 columns: per direction (x,
        recon, seg(x), x_ab1, seg(x_ab1), x_ab2), each overlay the
        Cityscapes colours of the segmenter's labels in [0, 1]."""
        gen, n = self.gen, x_a.shape[0]
        c_a, s_a = gen.encode(x_a, 1)
        c_b, s_b = gen.encode(x_b, 2)
        x_a_recon = gen.decode(c_a, s_a, 1)
        x_b_recon = gen.decode(c_b, s_b, 2)
        if self.guided:
            x_ab1 = x_ab2 = gen.decode(c_a, s_b, 2)
            x_ba1 = x_ba2 = gen.decode(c_b, s_a, 1)
        else:
            g = torch.Generator().manual_seed(0)
            s_a2, s_b2 = (torch.randn((n, self.style_dim), generator=g).to(
                self.device) for _ in range(2))
            x_ab1 = gen.decode(c_a, self.display_s_b[:n], 2)
            x_ab2 = gen.decode(c_a, s_b2, 2)
            x_ba1 = gen.decode(c_b, self.display_s_a[:n], 1)
            x_ba2 = gen.decode(c_b, s_a2, 1)
        if self.segmenter is None:
            return (x_a, x_a_recon, x_ab1, x_ab2, x_b, x_b_recon, x_ba1,
                    x_ba2)

        def overlay(img):
            labels = self._segment(img).argmax(dim=-1).cpu().numpy()
            rgb = np.stack([decode_segmap(lb) for lb in labels])
            return torch.from_numpy(rgb.astype(np.float32) / 255.0).to(
                img.device)

        return (x_a, x_a_recon, overlay(x_a), x_ab1, overlay(x_ab1), x_ab2,
                x_b, x_b_recon, overlay(x_b), x_ba1, overlay(x_ba1), x_ba2)


# The optimizers each step kind of the cadence updates.
STEP_OPTS = {"dis": ("dis",), "dis_gen": ("dis", "gen"), "dann": ("dann",),
             "classifier_sr": ("classif_sr",),
             "output_classifier_sr": ("output_classif_sr",),
             "dis_gen_synth": ("dis", "gen"),
             "classifier_sr_synth": ("classif_sr",), "seg_head": ("seg",)}


def cadence_steps(conf: Dict, iteration: int,
                  synth: bool = False) -> List[Tuple[str, bool]]:
    """The steps that the JAX loop's cadence (``munit_tpu/train/loop.py:
    183-227``) runs at ``iteration``, in its order, each as (kind,
    extrapolate): a dis step, or the fused dis+gen step on every
    ``ratio_disc_gen``-th iteration; the DANN step with ``domain_adv_w >
    0``; the sim/real classifier step on every ``classif_frequency``-th.
    With a synthetic batch (``synth``): the output-level classifier step on
    every ``output_classif_freq``-th (never extrapolating); on every
    ``synthetic_frequency``-th the fused step on the synthetic pair and, on
    the classifier's iterations, the classifier step on it; the seg-head
    step. ExtraAdam extrapolates on even iterations."""
    ad = conf["adaptation"]
    phase = "extra" in conf["optimizer"] and iteration % 2 == 0
    kinds = ["dis_gen" if (iteration + 1) % conf["ratio_disc_gen"] == 0
             else "dis"]
    if conf["domain_adv_w"] > 0:
        kinds.append("dann")
    classif = (ad["dfeat_lambda"] > 0
               and (iteration + 1) % ad["classif_frequency"] == 0)
    if classif:
        kinds.append("classifier_sr")
    steps = [(k, phase) for k in kinds]
    if not synth:
        return steps
    if ad["output_classifier_lambda"] > 0 and \
            (iteration + 1) % ad["output_classif_freq"] == 0:
        steps.append(("output_classifier_sr", False))
    if conf["synthetic_frequency"] > 0:
        if iteration % conf["synthetic_frequency"] == 0:
            steps.append(("dis_gen_synth", phase))
            if classif:
                steps.append(("classifier_sr_synth", phase))
        if ad["sem_seg_lambda"] > 0:
            steps.append(("seg_head", phase))
    return steps


def step_variants(conf: Dict, iterations, synth: bool = False):
    """(kind, extrapolate, anchor flags of the optimizers it updates) of
    each step of the cadence over ``iterations``, which run from 0: what
    a step's graph key depends on besides its inputs. The flags follow the
    optimizers as the steps advance them: the synthetic fused step of an
    even iteration extrapolates from the anchor that the real one set."""
    has_copy: Dict[str, bool] = {}
    for it in iterations:
        for kind, phase in cadence_steps(conf, it, synth):
            opts = STEP_OPTS[kind]
            yield kind, phase, tuple(has_copy.get(o, False) for o in opts)
            for o in opts:
                has_copy[o] = phase


def capture_warmup(conf: Dict, synth: bool = False) -> int:
    """Iterations from 0 after which every step variant of the cadence's
    steady state has run twice, once eagerly and once captured: from then
    on a card only replays."""
    ad = conf["adaptation"]
    period = math.lcm(2, conf["ratio_disc_gen"], ad["classif_frequency"],
                      ad["output_classif_freq"],
                      max(conf["synthetic_frequency"], 1))
    # after one period every optimizer has stepped: the anchor flags repeat,
    # so every variant of the steady state runs twice within three periods
    n = 3 * period
    steps = [len(cadence_steps(conf, it, synth)) for it in range(n)]
    variants = list(step_variants(conf, range(n), synth))
    want = set(variants[sum(steps[:period]):])
    seen: Counter = Counter()
    at = 0
    for it, k in enumerate(steps):
        if all(seen[v] >= 2 for v in want):
            return it
        seen.update(variants[at:at + k])
        at += k
    return n


def cadence_step(trainer, conf: Dict, kind: str, x_a, x_b, mask_a, mask_b,
                 synth=None) -> Dict:
    """One step of the cadence, of a kind that ``cadence_steps`` names, on
    the iteration's real batch and its synthetic batch ``synth``
    ({image_a, image_b, mask, sem_a, sem_b}, or None)."""
    ad = conf["adaptation"]
    if kind == "dis":
        return trainer.dis_update(x_a, x_b)
    if kind == "dis_gen":
        return trainer.dis_gen_update(x_a, x_b, mask_a, mask_b)
    if kind == "dann":
        return trainer.domain_classifier_update(x_a, x_b)
    if kind == "classifier_sr":
        return trainer.domain_classifier_sr_update(
            x_a, x_b, domain_synth=False, lamb=ad["dfeat_lambda"])
    x_as, x_bs = synth["image_a"], synth["image_b"]
    if kind == "output_classifier_sr":
        return trainer.output_domain_classifier_sr_update(x_a, x_as, x_b,
                                                          x_bs)
    if kind == "dis_gen_synth":
        gt = ((synth["sem_a"], synth["sem_b"]) if conf["synthetic_seg_gt"]
              else (None, None))
        return trainer.dis_gen_update(x_as, x_bs, synth["mask"],
                                      synth["mask"], synth=True,
                                      sem_gt_a=gt[0], sem_gt_b=gt[1])
    if kind == "classifier_sr_synth":
        return trainer.domain_classifier_sr_update(
            x_as, x_bs, domain_synth=True, lamb=ad["dfeat_lambda"])
    if kind == "seg_head":
        return trainer.segmentation_head_update(x_as, x_bs, synth["sem_a"],
                                                synth["sem_b"])
    raise ValueError(f"unknown step kind {kind!r}")


def cadence_iteration(trainer, conf: Dict, iteration: int, x_a, x_b,
                      mask_a, mask_b, synth=None) -> Dict:
    """The steps of one iteration of the cadence (``cadence_steps``) on the
    trainer, their metrics merged, a later step's over an earlier one's as
    the JAX loop merges them. ``synth``: the synthetic batch or None."""
    m = {}
    for kind, _ in cadence_steps(conf, iteration, synth is not None):
        m.update(cadence_step(trainer, conf, kind, x_a, x_b, mask_a, mask_b,
                              synth))
    return m


def train_steps(trainer: MUNITTrainer, x_a, x_b, mask_a, mask_b,
                iterations: List[int], synth=None) -> List[Dict]:
    """The cadence over the given iterations on fixed tensors (bench.py's
    without ``synth``, the synthetic batch)."""
    out = []
    for it in iterations:
        trainer.iterations = it
        out.append(cadence_iteration(trainer, trainer.conf, it, x_a, x_b,
                                     mask_a, mask_b, synth))
    return out
