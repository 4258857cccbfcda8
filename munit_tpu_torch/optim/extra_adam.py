"""ExtraAdam and Adam as functions over named parameter lists:
``munit_tpu/optim/extra_adam.py``.

Semantics of the reference (extraadam.py:14-168, driven by trainer.py:
225-277), as the JAX package has them:

- extrapolation (even iterations): the Adam update from the gradient at the
  current point; the parameters are saved first when no copy is held, then
  moved: x_{t+1/2} = x_t + u.
- step (odd iterations): the Adam update from the gradient at the
  extrapolated point, applied to the saved parameters: x_{t+1} = x_t + u.
  Without a saved copy it is a plain Adam step.
- The moments and the step count advance on both half-steps.
- Weight decay is L2, added to the gradient.
- Parameters, gradients and moments keep the parameters' type (f32, also
  in bf16 training); a gradient of another type raises.
- u = -lr * sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps): eps sits
  beside sqrt(v), not beside the bias-corrected sqrt(v) as in
  ``torch.optim.Adam``; the two differ on the first steps.

``adam`` is the same update that never extrapolates (``optimizer: adam``).
The update runs in place on the parameters and the state, with PyTorch's
multi-tensor (``torch._foreach_*``) ops, one launch per op for all leaves.

A half-step is split as the trainer's captured steps need it:
``extra_adam_apply`` is its device work, with lr and the bias correction
given as floats or as 0-dim tensors on the device (a CUDA graph replays
whatever those tensors hold, where a float would be baked into it);
``extra_adam_advance`` moves the host's ``count`` and ``has_copy``, once
per real step. ``extra_adam_update`` is both.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import torch


@dataclass
class ExtraAdamState:
    count: int                      # Adam step count (both half-steps)
    mu: Dict[str, torch.Tensor]     # first moment
    nu: Dict[str, torch.Tensor]     # second moment
    params_copy: Dict[str, torch.Tensor]   # the anchor of the extrapolation
    has_copy: bool


def extra_adam_init(params: Dict[str, torch.Tensor]) -> ExtraAdamState:
    def zeros():
        return {k: torch.zeros_like(p, memory_format=torch.preserve_format)
                for k, p in params.items()}
    return ExtraAdamState(0, zeros(), zeros(), zeros(), False)


def bias_correction(count: int, b1: float = 0.5, b2: float = 0.999) -> float:
    """sqrt(1 - b2^t) / (1 - b1^t) of the t-th half-step: its step size for
    an lr of 1."""
    return math.sqrt(1.0 - b2 ** count) / (1.0 - b1 ** count)


@torch.no_grad()
def extra_adam_apply(grads: Dict[str, torch.Tensor], state: ExtraAdamState,
                     params: Dict[str, torch.Tensor], lr, correction,
                     extrapolate: bool, b1: float = 0.5, b2: float = 0.999,
                     eps: float = 1e-8, weight_decay: float = 0.0) -> None:
    """The device work of one half-step, in place on ``params`` and the
    state's tensors, with the step size lr * correction (``correction``:
    ``bias_correction(state.count + 1)``). lr and correction are floats or
    0-dim float32 tensors on the parameters' device. Reads
    ``state.has_copy`` and changes no host value. ``grads`` and ``params``
    have the same names."""
    names = list(params)
    p: List[torch.Tensor] = [params[k] for k in names]
    g: List[torch.Tensor] = [grads[k] for k in names]
    for k, pk, gk in zip(names, p, g):
        if gk.dtype != pk.dtype:
            # bf16 training keeps parameters, gradients and moments in f32
            raise TypeError(f"{k}: a {gk.dtype} gradient for a {pk.dtype} "
                            "parameter")
    m = [state.mu[k] for k in names]
    v = [state.nu[k] for k in names]
    pc = [state.params_copy[k] for k in names]
    neg_step = -(lr * correction)
    if weight_decay:
        g = torch._foreach_add(g, p, alpha=weight_decay)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g, alpha=1.0 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
    denom = torch._foreach_sqrt(v)
    torch._foreach_add_(denom, eps)
    if extrapolate:
        if not state.has_copy:
            torch._foreach_copy_(pc, p)
    elif state.has_copy:
        torch._foreach_copy_(p, pc)
    # p + (-step * m) / denom, the JAX package's order of operations
    torch._foreach_addcdiv_(p, torch._foreach_mul(m, neg_step), denom)


def extra_adam_advance(state: ExtraAdamState,
                       extrapolate: bool) -> ExtraAdamState:
    """The host's part of one half-step: the count, and whether an anchor
    is held."""
    state.count += 1
    state.has_copy = bool(extrapolate)
    return state


def extra_adam_update(grads: Dict[str, torch.Tensor], state: ExtraAdamState,
                      params: Dict[str, torch.Tensor], lr,
                      extrapolate: bool, b1: float = 0.5, b2: float = 0.999,
                      eps: float = 1e-8,
                      weight_decay: float = 0.0) -> ExtraAdamState:
    """One half-step, in place on ``params`` and ``state``; returns the
    state. lr: a float or a 0-dim tensor."""
    extra_adam_apply(grads, state, params, lr,
                     bias_correction(state.count + 1, b1, b2), extrapolate,
                     b1, b2, eps, weight_decay)
    return extra_adam_advance(state, extrapolate)


def adam(grads, state: ExtraAdamState, params, lr: float, b1: float = 0.5,
         b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> ExtraAdamState:
    """Plain Adam: the same update, never extrapolating."""
    return extra_adam_update(grads, state, params, lr, False, b1, b2, eps,
                             weight_decay)
