"""Learning-rate schedules (pure functions of the step counter), as
``repro.optim.schedules``: computed in float32 as the reference computes
them, op for op, on the host (numpy float32 scalars), and returned as the
Python float of that float32 value.  The step is a Python int: the port
keeps the optimizer's step counter on the host."""
from __future__ import annotations

import numpy as np

_F = np.float32


def constant(lr: float):
    return lambda step: float(_F(lr))


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        s = _F(step)
        return float(_F(lr) * np.minimum(_F(1.0), s / _F(max(1, warmup_steps))))
    return fn


def cosine_decay(lr: float, warmup_steps: int, total_steps: int,
                 final_fraction: float = 0.1):
    def fn(step):
        s = _F(step)
        warm = np.minimum(_F(1.0), s / _F(max(1, warmup_steps)))
        frac = np.clip((s - _F(warmup_steps))
                       / _F(max(1, total_steps - warmup_steps)),
                       _F(0.0), _F(1.0))
        # (1 - final_fraction) * 0.5 is a Python (double) product, then a
        # weak scalar: rounded once to float32, as in the reference
        cos = _F(final_fraction) + _F((1 - final_fraction) * 0.5) * (
            _F(1.0) + np.cos(_F(np.pi) * frac))
        return float(_F(lr) * warm * cos)
    return fn


def exponential_decay(lr: float, decay_rate: float, decay_steps: int):
    def fn(step):
        return float(_F(lr) * np.power(_F(decay_rate),
                                       _F(step) / _F(decay_steps)))
    return fn
