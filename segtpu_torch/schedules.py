"""Learning-rate schedules as functions of the update count.

Counterpart of ``segtpu/schedules.py``: Poly, and OneCycle with its
momentum schedule. Update t (counting from 0) reads both at ``T = t + 1``:
the original torch scheduler consumes T=0 when it is built.
"""

from __future__ import annotations

import math


def poly(base_lr: float, num_epochs: int, iters_per_epoch: int,
         warmup_epochs: int = 0, power: float = 0.9):
    """Poly decay ``base_lr * (1 - T/N)^0.9`` with optional linear warmup.

    Update t (counting from 0) uses ``T = t + 1``: the original torch
    scheduler consumes T=0 when it is built, so the first applied rate is
    already one tick decayed and the last update reaches 0.
    """
    total = num_epochs * iters_per_epoch
    warmup = warmup_epochs * iters_per_epoch

    def schedule(step: int) -> float:
        t = step + 1.0
        if warmup > 0 and t < warmup:
            return base_lr * t / warmup
        return base_lr * max(1.0 - t / total, 0.0) ** power

    return schedule


def one_cycle(base_lr: float, num_epochs: int, iters_per_epoch: int,
              momentums=(0.85, 0.95), div_factor: float = 25.0, phase1: float = 0.3):
    """OneCycle: a cosine ramp from ``base_lr / div_factor`` to ``base_lr``
    over the first ``phase1`` of training, then a cosine anneal to
    ``base_lr / (div_factor * 1e4)``; the momentum cycles the other way,
    ``momentums[1]`` down to ``momentums[0]`` and back. Returns
    ``(lr_schedule, momentum_schedule)``, both read at ``T = t + 1``."""
    total = num_epochs * iters_per_epoch
    p1 = int(total * phase1)
    p2 = total - p1
    low_lr = base_lr / div_factor
    final_lr = base_lr / (div_factor * 1e4)
    mom_lo, mom_hi = momentums
    mom_diff = mom_hi - mom_lo

    def phase_cos(step: int):
        """(in the first phase, the cosine factor of the current phase);
        a phase of length 0 is never the current one."""
        t = step + 1.0
        if t <= p1:
            return True, (1.0 + math.cos(math.pi * t / p1)) / 2.0
        return False, (1.0 + math.cos(math.pi * min(t - p1, p2) / p2)) / 2.0

    def lr_schedule(step: int) -> float:
        first, cos = phase_cos(step)
        if first:
            return base_lr - (base_lr - low_lr) * cos
        return final_lr + (base_lr - final_lr) * cos

    def momentum_schedule(step: int) -> float:
        first, cos = phase_cos(step)
        if first:
            return mom_lo + mom_diff * cos
        return mom_hi - mom_diff * cos

    return lr_schedule, momentum_schedule


#: the Poly entry returns one schedule; OneCycle's returns (lr, momentum)
SCHEDULERS = {"Poly": poly, "OneCycle": one_cycle}


def get_schedule(name: str):
    if name not in SCHEDULERS:
        raise KeyError(f"unknown lr_scheduler {name!r}; available: {sorted(SCHEDULERS)}")
    return SCHEDULERS[name]
