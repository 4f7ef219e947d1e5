"""Learning-rate schedules: functions of the integer step."""
from __future__ import annotations

import math


def constant_lr(lr):
    return lambda step: float(lr)


def multistep_lr(base_lr, milestones, gamma):
    """The paper's MultiStepLR: milestones in *steps* (convert epochs
    upstream), multiplicative ``gamma`` at each milestone passed."""
    ms = sorted(milestones)

    def fn(step):
        n = sum(int(step) >= m for m in ms)
        return float(base_lr) * gamma ** n

    return fn


def cosine_lr(base_lr, total_steps, *, warmup=0, min_ratio=0.1):
    def fn(step):
        step = float(step)
        warm = min(step / max(warmup, 1), 1.0)
        prog = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0),
                   1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(
            math.pi * prog))
        return base_lr * warm * cos

    return fn
