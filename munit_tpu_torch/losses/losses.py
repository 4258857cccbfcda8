"""The training losses, on NHWC tensors: counterparts of
``munit_tpu/losses/losses.py`` (reference trainer.py:279-305, 638-667,
706-771, networks.py:79-115). Losses compute in at least float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from munit_tpu_torch.core.ops import upcast_f32


def recon_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (upcast_f32(x) - upcast_f32(y)).abs().mean()


def recon_l1_masked(x: torch.Tensor, y: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """L1 over the unmasked region, mean(|(x - y) (1 - mask)|): divided by
    the full element count, as the reference does (trainer.py:292-305).
    mask (B, H, W, 1) broadcasts over C."""
    d = (upcast_f32(x) - upcast_f32(y)) * (1.0 - upcast_f32(mask))
    return d.abs().mean()


def _bce_with_logits(logits, target: float):
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target))


def dis_gan_loss(outs_fake: Sequence[torch.Tensor],
                 outs_real: Sequence[torch.Tensor],
                 gan_type: str = "lsgan") -> torch.Tensor:
    """Summed over the scales: lsgan mean(f²) + mean((r - 1)²); nsgan
    BCE(f, 0) + BCE(r, 1)."""
    loss = 0.0
    for o_f, o_r in zip(outs_fake, outs_real):
        o_f, o_r = upcast_f32(o_f), upcast_f32(o_r)
        if gan_type == "lsgan":
            loss = loss + o_f.square().mean() + (o_r - 1.0).square().mean()
        elif gan_type == "nsgan":
            loss = loss + _bce_with_logits(o_f, 0.0) + _bce_with_logits(o_r, 1.0)
        else:
            raise ValueError(f"Unsupported GAN type: {gan_type}")
    return loss


def gen_gan_loss(outs_fake: Sequence[torch.Tensor],
                 gan_type: str = "lsgan") -> torch.Tensor:
    """Summed over the scales: lsgan mean((f - 1)²); nsgan BCE(f, 1)."""
    loss = 0.0
    for o in outs_fake:
        o = upcast_f32(o)
        if gan_type == "lsgan":
            loss = loss + (o - 1.0).square().mean()
        elif gan_type == "nsgan":
            loss = loss + _bce_with_logits(o, 1.0)
        else:
            raise ValueError(f"Unsupported GAN type: {gan_type}")
    return loss


def classifier_sr_loss(out_a: torch.Tensor, out_b: torch.Tensor,
                       domain_synth: bool, fool: bool) -> torch.Tensor:
    """Sim/real feature-classifier loss (trainer.py:638-667): the target is
    0.5 for the generator's fool term, else 0 (synthetic) or 1 (real)."""
    t = 0.5 if fool else (0.0 if domain_synth else 1.0)
    return (out_a - t).square().mean() + (out_b - t).square().mean()


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over every pixel (B·H·W). logits (..., C)
    with the classes last (NHWC), labels (...) integer."""
    c = logits.shape[-1]
    return F.cross_entropy(upcast_f32(logits).reshape(-1, c),
                           labels.reshape(-1).long())


def semantic_seg_loss_masked(logits: torch.Tensor, target: torch.Tensor,
                             mask: torch.Tensor,
                             num_classes: int) -> torch.Tensor:
    """The reference's mask-as-extra-logit-channel construction
    (trainer.py:744-767): masked pixels are relabelled ``num_classes``,
    their logits zeroed, and the mask itself appended as one more logit
    channel, so a masked pixel's gradient to the logits is ~0.

    logits (B, H, W, C); target (B, H, W) integer; mask (B, H, W) in
    {0, 1}."""
    m = upcast_f32(mask)
    m_long = mask.long()
    relabelled = (1 - m_long) * target.long() + m_long * num_classes
    masked = upcast_f32(logits) * (1.0 - m)[..., None]
    return cross_entropy_loss(torch.cat([masked, m[..., None]], dim=-1),
                              relabelled)
