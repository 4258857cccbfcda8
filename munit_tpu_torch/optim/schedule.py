"""Learning-rate schedules: ``munit_tpu/optim/schedule.py``.

The reference steps torch's StepLR once at the start of every iteration, so
during 0-based iteration ``it`` the lr is lr0 * gamma^((it + 1) // step_size)
(utils.py:1035-1060; train.py:172). ``lr_policy: constant`` does not decay.
"""

from __future__ import annotations


def step_lr(lr0: float, step_size: int, gamma: float):
    def schedule(iteration: int) -> float:
        return lr0 * (gamma ** ((iteration + 1) // step_size))
    return schedule


def from_config(hp: dict):
    policy = hp.get("lr_policy", "constant")
    lr0 = hp["lr"]
    if policy == "constant":
        return lambda it: lr0
    if policy == "step":
        return step_lr(lr0, hp["step_size"], hp["gamma"])
    raise NotImplementedError(f"learning rate policy [{policy}] is not implemented")
