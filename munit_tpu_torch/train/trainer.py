"""The MUNIT training steps on one device: ``munit_tpu/train/trainer.py``
for ``gen_state: 1``, ``guided: 1`` and ``grad_accum: 1``.

- ``dis_update``      ≙ ``_dis_step_impl`` (trainer.py:690-732)
- ``gen_update``      ≙ ``_gen_step_impl`` (:1072-1115)
- ``dis_gen_update``  ≙ the fused ``_dis_gen_step_impl`` (:814-883): one
  generator forward; D is updated first against the detached fakes, then
  the generator's losses are taken against the updated D
- ``domain_classifier_sr_update`` ≙ ``_classifier_sr_step_impl`` (:1283-1312)
- ``dis_gen_grads``   ≙ ``dis_gen_grads`` (:1025-1070), the fused step's
  gradients against the current D, with no update
- ``sample``          ≙ ``sample`` (:1474-1515), guided: the display grid's
  columns
- ``state_dict`` / ``load_state_dict``: the whole training state that a
  checkpoint holds (``io/checkpoint.py``), the counterpart of the JAX
  trainer's ``state`` pytree

Every forward makes the JAX trainer's ``wide: 1`` calls (its default at
256 px): one style encode of both domains, the two content encoders as a
pair, and one decode per domain over [recon | cross]. With ``semantic_w >
0`` the frozen ResNet34-8s segments [x_a | x_b] once per gen step, outside
the differentiated part, for its pseudo-label targets (trainer.py:736-752,
841-843), and [x_ab | x_ba] once inside it for the semantic loss
(:771-782, 1199-1202); its gradient reaches the translations only.
Gradients are taken with ``torch.autograd.grad`` with respect to named
parameter lists, so D collects no generator gradient and no stale ``.grad``
is left; the optimizers update the parameters in place. With guided
styles no random style reaches a loss (trainer.py:850-853, 1137-1139), so
none is drawn.

Each of the four update steps is host bookkeeping around a device body,
as the JAX trainer's jitted ``_*_step_impl`` are: the host reads the lr
and the ExtraAdam phase, writes the lr and each optimizer's bias correction
into device scalars, runs the body, then advances the optimizers' counts
and anchor flags. The body reads no Python value that changes between
iterations. On a CUDA device the bodies run as CUDA graphs, captured once
per key and replayed (``train/graphs.py``); on the CPU they run eagerly.
``dis_gen_grads`` and ``sample`` always run eagerly.

Not ported yet, and refused when its weight is on: VGG (``vgg_w``), DANN
(``domain_adv_w``), synthetic pairs (``recon_synth_w``) and with them the
ground-truth semantic targets (``has_sem_gt``, ``merge_class_matrix``),
output-level DA (``output_adv_lambda``, ``output_classifier_lambda``), the
seg head (``sem_seg_lambda``), ``grad_accum > 1`` and ``guided: 0``
(ROADMAP.md).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Tuple

import numpy as np
import torch

from munit_tpu_torch.config import dis_pyramid_floor, pyramid_message
from munit_tpu_torch.core import ops
from munit_tpu_torch.eval.segmap import decode_segmap
from munit_tpu_torch.losses import losses
from munit_tpu_torch.nn import classifiers, discriminator
from munit_tpu_torch.nn.generator import GenBundle
from munit_tpu_torch.nn.resnet import NUM_CLASSES, ResNet34_8s, seg_preprocess
from munit_tpu_torch.optim.extra_adam import (ExtraAdamState,
                                              bias_correction,
                                              extra_adam_advance,
                                              extra_adam_apply,
                                              extra_adam_init)
from munit_tpu_torch.optim.schedule import from_config as schedule_from_config
from munit_tpu_torch.train import graphs

Tensors = Dict[str, torch.Tensor]

# (config key or adaptation key, weight name, the slice that brings it)
_NOT_PORTED = (
    ("vgg_w", "the VGG loss", "ROADMAP queue 1 item 12"),
    ("domain_adv_w", "the DANN loss", "ROADMAP queue 1 item 11"),
    ("recon_synth_w", "the synthetic-pair loss", "ROADMAP queue 1 item 11"),
    ("adaptation.output_adv_lambda", "output-level DA",
     "ROADMAP queue 1 item 11"),
    ("adaptation.output_classifier_lambda", "output-level DA",
     "ROADMAP queue 1 item 11"),
    ("adaptation.sem_seg_lambda", "the seg head", "ROADMAP queue 1 item 11"),
)


def _lookup(conf, key):
    for part in key.split("."):
        conf = conf[part]
    return conf


def check_ported(conf: Dict) -> None:
    """Raise NotImplementedError for what this slice of the port lacks."""
    if conf["guided"] != 1:
        raise NotImplementedError(
            "guided: 0 (random styles) is not ported; ROADMAP queue 1 item 9")
    if conf["grad_accum"] != 1:
        raise NotImplementedError(
            "grad_accum > 1 is not ported; ROADMAP queue 1 item 13")
    for key, what, where in _NOT_PORTED:
        if float(_lookup(conf, key)) > 0:
            raise NotImplementedError(
                f"{key} > 0 ({what}) is not ported; {where}")


def _named(module: torch.nn.Module) -> Tensors:
    return dict(module.named_parameters())


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
        self.lr_schedule = schedule_from_config(conf)
        self.iterations = 0
        self.hw = {k: float(conf[k]) for k in
                   ("gan_w", "recon_x_w", "recon_s_w", "recon_c_w",
                    "recon_x_cyc_w", "semantic_w")}
        self.hw["adv_lambda"] = float(ad["adv_lambda"])

        self.gen = GenBundle(conf, device, trainable=True)
        self.dis_a = discriminator.build(conf, device)
        self.dis_b = discriminator.build(conf, device)
        g = conf["gen"]
        content_dim = g["dim"] * 2 ** g["n_downsample"]
        # the fool term needs the classifiers too (trainer.py:1217-1223)
        self.classifier_sr_a = self.classifier_sr_b = None
        if self.use_classifier_sr or self.hw["adv_lambda"] > 0:
            self.classifier_sr_a, self.classifier_sr_b = (
                classifiers.DomainClassifier(content_dim).to(
                    device=device, memory_format=torch.channels_last)
                for _ in range(2))
        # frozen: seeded by init() or loaded by load_segmenter()
        self.segmenter = (ResNet34_8s(NUM_CLASSES).frozen_on(device)
                          if self.semantic_w else None)
        self.gen_opt = extra_adam_init(self.gen_params())
        self.dis_opt = extra_adam_init(self.dis_params())
        self.classif_sr_opt = (extra_adam_init(self.classifier_params())
                               if self.classifier_sr_a is not None else None)
        # the lr, then each optimizer's bias correction, as the steps read
        # them on the device; written before every step
        self._slot = {k: i + 1 for i, k in enumerate(self._opts())}
        self._scalars = torch.zeros(1 + len(self._slot), device=self.device)
        self._scalar_views = self._scalars.unbind()
        self._capture = _capture and self.device.type == "cuda"
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

    def init(self, generator: torch.Generator) -> None:
        """Seeded reference init of every net; the draws are made on the
        CPU from ``generator`` and copied to the device."""
        nets = [self.gen, self.dis_a, self.dis_b]
        if self.classifier_sr_a is not None:
            nets += [self.classifier_sr_a, self.classifier_sr_b]
        if self.segmenter is not None:
            nets.append(self.segmenter)
        for net in nets:
            net.init(generator)
        self._graphs.clear()

    def load_segmenter(self, state_dict: Tensors) -> None:
        """The frozen segmenter's weights, reference ``resnet34_8s.*``
        keys (``io/weights.py::load_segmenter_checkpoint``)."""
        if self.segmenter is None:
            raise ValueError("no segmenter: semantic_w is 0")
        self.segmenter.load_state_dict(state_dict)
        self._graphs.clear()

    # --------------------------------------------------------------- state

    def _nets(self) -> Dict[str, torch.nn.Module]:
        nets = {"gen": self.gen.module, "dis_a": self.dis_a,
                "dis_b": self.dis_b}
        if self.classifier_sr_a is not None:
            nets.update(classifier_sr_a=self.classifier_sr_a,
                        classifier_sr_b=self.classifier_sr_b)
        return nets

    def _opts(self) -> Dict[str, ExtraAdamState]:
        opts = {"gen": self.gen_opt, "dis": self.dis_opt}
        if self.classif_sr_opt is not None:
            opts["classif_sr"] = self.classif_sr_opt
        return opts

    def state_dict(self) -> Dict:
        """The whole training state, by reference (no copy): every
        trainable net's parameters and buffers (the classifiers' running
        statistics too), each optimizer's ``ExtraAdamState`` and
        ``iterations``. The frozen segmenter is not part of it."""
        return {
            "iterations": self.iterations,
            "nets": {k: m.state_dict() for k, m in self._nets().items()},
            "opt": {k: {"count": o.count, "mu": o.mu, "nu": o.nu,
                        "params_copy": o.params_copy,
                        "has_copy": o.has_copy}
                    for k, o in self._opts().items()}}

    def load_state_dict(self, state: Dict) -> None:
        """Copy a ``state_dict()`` into this trainer's tensors, in place
        (device and memory format stay, and so do the captured steps); the
        nets and their names must match."""
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
        self.iterations = int(state["iterations"])

    # ------------------------------------------------------------- forwards

    def _cross_decode(self, x_a, x_b):
        """Codes and cross translations (trainer.py:440-467, wide 1)."""
        gen, bsz = self.gen, x_a.shape[0]
        s = gen.encode_style(torch.cat([x_a, x_b]))
        s_a, s_b = s[:bsz], s[bsz:]
        c_a, c_b = gen.encode_content(x_a, 1), gen.encode_content(x_b, 2)
        x_ba = gen.decode(c_b, s_a, 1)
        x_ab = gen.decode(c_a, s_b, 2)
        return c_a, s_a, c_b, s_b, x_ba, x_ab

    def _gen_forward(self, x_a, x_b) -> Tensors:
        """The gen step's generator forward (trainer.py:469-535, wide 1):
        within-domain recon, cross decode, re-encode, cycle decode."""
        gen, bsz = self.gen, x_a.shape[0]
        s = gen.encode_style(torch.cat([x_a, x_b]))
        s_a, s_b = s[:bsz], s[bsz:]
        c_a, c_b = gen.encode_content(x_a, 1), gen.encode_content(x_b, 2)
        # wave 1: [recon | cross] per domain, guided styles
        out1 = gen.decode(torch.cat([c_a, c_b]), torch.cat([s_a, s_a]), 1)
        out2 = gen.decode(torch.cat([c_b, c_a]), torch.cat([s_b, s_b]), 2)
        x_a_recon, x_ba = out1[:bsz], out1[bsz:]
        x_b_recon, x_ab = out2[:bsz], out2[bsz:]
        # wave 2: re-encode the fakes
        s_r = gen.encode_style(torch.cat([x_ba, x_ab]))
        c_b_recon = gen.encode_content(x_ba, 1)
        c_a_recon = gen.encode_content(x_ab, 2)
        fw = dict(c_a=c_a, c_b=c_b, s_a_p=s_a, s_b_p=s_b,
                  x_a_recon=x_a_recon, x_b_recon=x_b_recon, x_ba=x_ba,
                  x_ab=x_ab, c_a_recon=c_a_recon, c_b_recon=c_b_recon,
                  s_a_recon=s_r[:bsz], s_b_recon=s_r[bsz:])
        if self.hw["recon_x_cyc_w"] > 0:
            fw["x_aba"] = gen.decode(c_a_recon, s_a, 1)
            fw["x_bab"] = gen.decode(c_b_recon, s_b, 2)
        return fw

    # ------------------------------------------------------------- semantic

    def _segment(self, img):
        """Frozen segmenter logits (B, H, W, 19) of a [-1, 1] image."""
        return self.segmenter(seg_preprocess(img))

    def _semantic_targets(self, x_a, x_b):
        """Pseudo-labels of the real images (trainer.py:736-752, wide 1):
        one pass over [x_a | x_b], outside any gradient."""
        if not self.semantic_w:
            return None
        with torch.no_grad():
            t = self._segment(torch.cat([x_a, x_b])).argmax(dim=-1)
        bsz = x_a.shape[0]
        return t[:bsz], t[bsz:]

    def _sem_loss_from_logits(self, logits, target, mask):
        """Masked CE over the 19 classes, the mask resized to the crop;
        plain CE with ``full_adaptation: 1`` (trainer.py:754-763)."""
        if self.full_adaptation:
            return losses.cross_entropy_loss(logits, target)
        m = ops.resize_nearest(mask, (self.crop, self.crop))[..., 0]
        return losses.semantic_seg_loss_masked(logits, target, m, NUM_CLASSES)

    def _semantic_loss_pair(self, x_ab, x_ba, targets, mask_a, mask_b):
        """Both translations through one segmenter pass, held against the
        targets of their sources: x_ab against (t_a, mask_a), x_ba against
        (t_b, mask_b) (trainer.py:771-782, 1199-1202)."""
        bsz = x_ab.shape[0]
        logits = self._segment(torch.cat([x_ab, x_ba]))
        t_a, t_b = targets
        return (self._sem_loss_from_logits(logits[:bsz], t_a, mask_a)
                + self._sem_loss_from_logits(logits[bsz:], t_b, mask_b))

    def _dis_apply_fr(self, dis, x_fake, x_real):
        """One D pass over [fake | real] → (outs_fake, outs_real)."""
        bsz = x_fake.shape[0]
        outs = dis(torch.cat([x_fake, x_real]))
        return [o[:bsz] for o in outs], [o[bsz:] for o in outs]

    def _dis_loss(self, x_ba, x_ab, x_a, x_b):
        """calc_dis_loss of both discriminators (trainer.py:784-812)."""
        fa, ra = self._dis_apply_fr(self.dis_a, x_ba, x_a)
        fb, rb = self._dis_apply_fr(self.dis_b, x_ab, x_b)
        la = losses.dis_gan_loss(fa, ra, self.gan_type)
        lb = losses.dis_gan_loss(fb, rb, self.gan_type)
        total = self.hw["gan_w"] * (la + lb)
        return total, {"loss_dis_a": la, "loss_dis_b": lb,
                       "loss_dis_total": total}

    def _gen_loss(self, fw, x_a, x_b, mask_a, mask_b, sem_targets):
        """The gen step's loss over a generator forward (trainer.py:
        1117-1254), against the current weights of D and the classifiers;
        the classifiers' batch statistics are discarded. ``sem_targets``:
        the pseudo-labels (t_a, t_b), or None when semantic_w is 0."""
        hw, l1 = self.hw, losses.recon_l1
        m = {"loss_gen_recon_x_a": l1(fw["x_a_recon"], x_a),
             "loss_gen_recon_x_b": l1(fw["x_b_recon"], x_b),
             "loss_gen_recon_s_a": l1(fw["s_a_recon"], fw["s_a_p"]),
             "loss_gen_recon_s_b": l1(fw["s_b_recon"], fw["s_b_p"]),
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
        m["loss_gen_adv_a"] = losses.gen_gan_loss(self.dis_a(fw["x_ba"]),
                                                  self.gan_type)
        m["loss_gen_adv_b"] = losses.gen_gan_loss(self.dis_b(fw["x_ab"]),
                                                  self.gan_type)
        if hw["adv_lambda"] > 0:
            m["loss_classifier_adv_sr"] = losses.classifier_sr_loss(
                self.classifier_sr_a(fw["c_a"]),
                self.classifier_sr_b(fw["c_b"]), domain_synth=False,
                fool=True)
        else:
            m["loss_classifier_adv_sr"] = zero
        if self.semantic_w:
            m["loss_sem_seg"] = self._semantic_loss_pair(
                fw["x_ab"], fw["x_ba"], sem_targets, mask_a, mask_b)
        else:
            m["loss_sem_seg"] = zero
        total = (hw["gan_w"] * (m["loss_gen_adv_a"] + m["loss_gen_adv_b"])
                 + hw["recon_x_w"] * (m["loss_gen_recon_x_a"]
                                      + m["loss_gen_recon_x_b"])
                 + hw["recon_s_w"] * (m["loss_gen_recon_s_a"]
                                      + m["loss_gen_recon_s_b"])
                 + hw["recon_c_w"] * (m["loss_gen_recon_c_a"]
                                      + m["loss_gen_recon_c_b"])
                 + hw["recon_x_cyc_w"] * (m["loss_gen_cycrecon_x_a"]
                                          + m["loss_gen_cycrecon_x_b"])
                 + hw["semantic_w"] * m["loss_sem_seg"]
                 + hw["adv_lambda"] * m["loss_classifier_adv_sr"])
        m["loss_gen_total"] = total
        return total, m

    @staticmethod
    def _no_sem_gt(sem_gt_a, sem_gt_b):
        if sem_gt_a is not None or sem_gt_b is not None:
            raise NotImplementedError(
                "ground-truth semantic targets (has_sem_gt, "
                "merge_class_matrix: the synthetic-pair step) are not "
                "ported; ROADMAP queue 1 item 11")

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

    # ---------------------------------------------------------- optimizer

    def _phase(self) -> bool:
        """ExtraAdam parity: extrapolate on even iterations (trainer.py:229)."""
        return bool(self.use_extra and self.iterations % 2 == 0)

    def _lr(self) -> float:
        return float(self.lr_schedule(self.iterations))

    def _update(self, grads, name, params, extrapolate):
        """An optimizer's half-step on the device, with the lr and its bias
        correction read from the device scalars."""
        c = self.conf
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

    def _step(self, kind, body, tensors, opts, static=(), lr_metric=False):
        """One update step: the host's bookkeeping around ``body(
        extrapolate, *static, *tensors)``, its device work, which updates
        the optimizers ``opts``. Returns the body's metrics, detached."""
        lr, extrapolate = self._lr(), self._phase()
        self._write_scalars(lr)
        states = [self._opts()[k] for k in opts]

        def run(*ts):
            return body(extrapolate, *static, *ts)
        if self._capture:
            key = graphs.step_key(kind, extrapolate,
                                  [o.has_copy for o in states], tensors,
                                  static)
            m = self._graphs.run(key, run, tensors)
        else:
            m = {k: v.detach() for k, v in run(*tensors).items()}
        for o in states:
            extra_adam_advance(o, extrapolate)
        if lr_metric:
            m["lr"] = lr
        return m

    # --------------------------------------------------------------- steps

    def dis_update(self, x_a, x_b) -> Tensors:
        """One discriminator step against detached fakes."""
        return self._step("dis", self._dis_body, (x_a, x_b), ("dis",),
                          lr_metric=True)

    def _dis_body(self, extrapolate, x_a, x_b) -> Tensors:
        with torch.no_grad():
            *_, x_ba, x_ab = self._cross_decode(x_a, x_b)
        params = self.dis_params()
        total, m = self._dis_loss(x_ba, x_ab, x_a, x_b)
        self._update(self._grads(total, params), "dis", params, extrapolate)
        return m

    def gen_update(self, x_a, x_b, mask_a=None, mask_b=None, sem_gt_a=None,
                   sem_gt_b=None) -> Tensors:
        """One generator step against the current discriminators."""
        self._no_sem_gt(sem_gt_a, sem_gt_b)
        return self._step("gen", self._gen_body, (x_a, x_b, mask_a, mask_b),
                          ("gen",))

    def _gen_body(self, extrapolate, x_a, x_b, mask_a, mask_b) -> Tensors:
        mask_a, mask_b = self._masks(x_a, mask_a, mask_b)
        targets = self._semantic_targets(x_a, x_b)
        params = self.gen_params()
        total, m = self._gen_loss(self._gen_forward(x_a, x_b), x_a, x_b,
                                  mask_a, mask_b, targets)
        self._update(self._grads(total, params), "gen", params, extrapolate)
        return m

    def dis_gen_update(self, x_a, x_b, mask_a=None, mask_b=None,
                       sem_gt_a=None, sem_gt_b=None) -> Tensors:
        """The fused dis + gen step: one generator forward; D steps first on
        its detached cross decodes, then the generator's losses are taken
        against the updated D."""
        self._no_sem_gt(sem_gt_a, sem_gt_b)
        return self._step("dis_gen", self._dis_gen_body,
                          (x_a, x_b, mask_a, mask_b), ("dis", "gen"),
                          lr_metric=True)

    def _dis_gen_body(self, extrapolate, x_a, x_b, mask_a, mask_b) -> Tensors:
        mask_a, mask_b = self._masks(x_a, mask_a, mask_b)
        targets = self._semantic_targets(x_a, x_b)
        fw = self._gen_forward(x_a, x_b)
        dis_params = self.dis_params()
        total_d, m_dis = self._dis_loss(fw["x_ba"].detach(),
                                        fw["x_ab"].detach(), x_a, x_b)
        self._update(self._grads(total_d, dis_params), "dis", dis_params,
                     extrapolate)
        gen_params = self.gen_params()
        total_g, m_gen = self._gen_loss(fw, x_a, x_b, mask_a, mask_b,
                                        targets)
        self._update(self._grads(total_g, gen_params), "gen", gen_params,
                     extrapolate)
        return {**m_dis, **m_gen}

    def dis_gen_grads(self, x_a, x_b, mask_a=None,
                      mask_b=None) -> Tuple[Tensors, Tensors]:
        """(dis grads, gen grads) of one fused step, both against the
        current D, with no update (trainer.py:1025-1070)."""
        mask_a, mask_b = self._masks(x_a, mask_a, mask_b)
        targets = self._semantic_targets(x_a, x_b)
        fw = self._gen_forward(x_a, x_b)
        total_d, _ = self._dis_loss(fw["x_ba"].detach(), fw["x_ab"].detach(),
                                    x_a, x_b)
        grads_d = self._grads(total_d, self.dis_params())
        total_g, _ = self._gen_loss(fw, x_a, x_b, mask_a, mask_b, targets)
        return grads_d, self._grads(total_g, self.gen_params())

    def domain_classifier_sr_update(self, x_a, x_b, domain_synth: bool,
                                    lamb: float) -> Tensors:
        """One step of the sim/real classifiers on detached content codes;
        each keeps its own batch-statistics update."""
        return self._step("classifier_sr", self._classifier_sr_body,
                          (x_a, x_b), ("classif_sr",),
                          static=(bool(domain_synth), float(lamb)))

    def _classifier_sr_body(self, extrapolate, domain_synth, lamb, x_a,
                            x_b) -> Tensors:
        with torch.no_grad():
            c_a = self.gen.encode_content(x_a, 1)
            c_b = self.gen.encode_content(x_b, 2)
        params = self.classifier_params()
        loss = lamb * losses.classifier_sr_loss(
            self.classifier_sr_a(c_a, update_stats=True),
            self.classifier_sr_b(c_b, update_stats=True),
            domain_synth=domain_synth, fool=False)
        self._update(self._grads(loss, params), "classif_sr", params,
                     extrapolate)
        return {"loss_classifier_sr": loss}

    # ------------------------------------------------------------ sampling

    @torch.no_grad()
    def sample(self, x_a, x_b) -> Tuple[torch.Tensor, ...]:
        """The display grid's columns, guided (trainer.py:1474-1515): per
        direction (x, recon, x_ab, x_ab), each style taken from the other
        domain's image. With the segmenter, 12 columns: per direction (x,
        recon, seg(x), x_ab, seg(x_ab), x_ab), each overlay the Cityscapes
        colours of the segmenter's labels in [0, 1]."""
        gen = self.gen
        c_a, s_a = gen.encode(x_a, 1)
        c_b, s_b = gen.encode(x_b, 2)
        x_a_recon = gen.decode(c_a, s_a, 1)
        x_b_recon = gen.decode(c_b, s_b, 2)
        x_ab = gen.decode(c_a, s_b, 2)
        x_ba = gen.decode(c_b, s_a, 1)
        if self.segmenter is None:
            return (x_a, x_a_recon, x_ab, x_ab, x_b, x_b_recon, x_ba, x_ba)

        def overlay(img):
            labels = self._segment(img).argmax(dim=-1).cpu().numpy()
            rgb = np.stack([decode_segmap(lb) for lb in labels])
            return torch.from_numpy(rgb.astype(np.float32) / 255.0).to(
                img.device)

        return (x_a, x_a_recon, overlay(x_a), x_ab, overlay(x_ab), x_ab,
                x_b, x_b_recon, overlay(x_b), x_ba, overlay(x_ba), x_ba)


def cadence_steps(conf: Dict, iteration: int) -> List[Tuple[str, bool]]:
    """The steps that ``bench.py``'s cadence runs at ``iteration``, each as
    (kind, extrapolate): a dis step, or the fused dis+gen step on every
    ``ratio_disc_gen``-th iteration, then the sim/real classifier step on
    every ``classif_frequency``-th; ExtraAdam extrapolates on even
    iterations."""
    ad = conf["adaptation"]
    phase = "extra" in conf["optimizer"] and iteration % 2 == 0
    kinds = ["dis_gen" if (iteration + 1) % conf["ratio_disc_gen"] == 0
             else "dis"]
    if ad["dfeat_lambda"] > 0 and (iteration + 1) % ad["classif_frequency"] == 0:
        kinds.append("classifier_sr")
    return [(k, phase) for k in kinds]


def capture_warmup(conf: Dict) -> int:
    """Iterations from 0 after which every step variant of the cadence has
    run twice, once eagerly and once captured: from then on a card only
    replays."""
    ad = conf["adaptation"]
    period = math.lcm(2, conf["ratio_disc_gen"], ad["classif_frequency"])
    want = {v for it in range(period) for v in cadence_steps(conf, it)}
    seen: Counter = Counter()
    it = 0
    while any(seen[v] < 2 for v in want):
        seen.update(cadence_steps(conf, it))
        it += 1
    return it


def cadence_iteration(trainer, conf: Dict, iteration: int, x_a, x_b,
                      mask_a, mask_b) -> Dict:
    """The steps of one iteration of the cadence (``cadence_steps``) on the
    trainer, their metrics merged."""
    ad = conf["adaptation"]
    m = {}
    for kind, _ in cadence_steps(conf, iteration):
        if kind == "dis":
            m.update(trainer.dis_update(x_a, x_b))
        elif kind == "dis_gen":
            m.update(trainer.dis_gen_update(x_a, x_b, mask_a, mask_b))
        else:
            m.update(trainer.domain_classifier_sr_update(
                x_a, x_b, domain_synth=False, lamb=ad["dfeat_lambda"]))
    return m


def train_steps(trainer: MUNITTrainer, x_a, x_b, mask_a, mask_b,
                iterations: List[int]) -> List[Dict]:
    """``bench.py``'s cadence over the given iterations on fixed tensors."""
    out = []
    for it in iterations:
        trainer.iterations = it
        out.append(cadence_iteration(trainer, trainer.conf, it, x_a, x_b,
                                     mask_a, mask_b))
    return out
