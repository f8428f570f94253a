"""Step-size schedules (counterpart of ``repro.optim.schedules``).

A schedule maps the integer step (a Python int) to an fp32 scalar."""
from __future__ import annotations

import math

import numpy as np


def constant(value: float):
    return lambda step: np.float32(value)


def diminishing(eta0: float, decay: float = 1.0):
    """eta0 / (1 + decay * t): the survey's sum-eta = inf, sum-eta^2 <
    inf condition (Appendix A.2)."""
    return lambda step: np.float32(eta0) / (
        np.float32(1.0) + np.float32(decay) * np.float32(step))


def cosine_warmup(base: float, warmup: int, total: int, floor: float = 0.0):
    def fn(step):
        s = np.float32(step)
        if s < warmup:
            return np.float32(base) * s / np.float32(max(warmup, 1))
        prog = np.clip((s - np.float32(warmup))
                       / np.float32(max(total - warmup, 1)), 0, 1)
        return np.float32(floor + 0.5 * (base - floor)
                          * (1 + math.cos(math.pi * float(prog))))
    return fn
