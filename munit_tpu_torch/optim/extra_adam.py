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
- u = -lr * sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps): eps sits
  beside sqrt(v), not beside the bias-corrected sqrt(v) as in
  ``torch.optim.Adam``; the two differ on the first steps.

``adam`` is the same update that never extrapolates (``optimizer: adam``).
The update runs in place on the parameters and the state, with PyTorch's
multi-tensor (``torch._foreach_*``) ops, one launch per op for all leaves.
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


@torch.no_grad()
def extra_adam_update(grads: Dict[str, torch.Tensor], state: ExtraAdamState,
                      params: Dict[str, torch.Tensor], lr: float,
                      extrapolate: bool, b1: float = 0.5, b2: float = 0.999,
                      eps: float = 1e-8,
                      weight_decay: float = 0.0) -> ExtraAdamState:
    """One half-step, in place on ``params`` and ``state``; returns the
    state. ``grads`` and ``params`` have the same names."""
    names = list(params)
    p: List[torch.Tensor] = [params[k] for k in names]
    g: List[torch.Tensor] = [grads[k] for k in names]
    m = [state.mu[k] for k in names]
    v = [state.nu[k] for k in names]
    pc = [state.params_copy[k] for k in names]
    count = state.count + 1
    step_size = lr * math.sqrt(1.0 - b2 ** count) / (1.0 - b1 ** count)
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
    torch._foreach_addcdiv_(p, m, denom, value=-step_size)
    state.count = count
    state.has_copy = bool(extrapolate)
    return state


def adam(grads, state: ExtraAdamState, params, lr: float, b1: float = 0.5,
         b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> ExtraAdamState:
    """Plain Adam: the same update, never extrapolating."""
    return extra_adam_update(grads, state, params, lr, False, b1, b2, eps,
                             weight_decay)
