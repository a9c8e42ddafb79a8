"""Learning-rate schedules (port of ``repro.optim.schedules``): pure
functions of the int step, evaluated in f32 as the reference does, and
returned as Python floats."""
from __future__ import annotations

import numpy as np

_f32 = np.float32


def linear_warmup(step: int, warmup: int, peak: float) -> float:
    return float(_f32(peak) * min(_f32(1.0),
                                  _f32(step + 1) / _f32(max(warmup, 1))))


def cosine_decay(step: int, warmup: int, total: int, peak: float,
                 floor_frac: float = 0.1) -> float:
    """Linear warmup then cosine decay to ``floor_frac * peak``."""
    if step < warmup:
        return linear_warmup(step, warmup, peak)
    t = min(max(_f32(step - warmup) / _f32(max(total - warmup, 1)),
                _f32(0.0)), _f32(1.0))
    cos = _f32(0.5) * (_f32(1.0) + np.cos(_f32(np.pi) * t, dtype=_f32))
    return float(_f32(peak) * (_f32(floor_frac)
                               + _f32(1.0 - floor_frac) * cos))


def constant(step: int, peak: float) -> float:
    del step
    return float(_f32(peak))


def make_schedule(kind: str = "cosine", *, peak: float = 3e-4,
                  warmup: int = 100, total: int = 10000,
                  floor_frac: float = 0.1):
    """Returns step -> lr."""
    if kind == "cosine":
        return lambda s: cosine_decay(s, warmup, total, peak, floor_frac)
    if kind == "linear":
        return lambda s: linear_warmup(s, warmup, peak)
    if kind == "constant":
        return lambda s: constant(s, peak)
    raise ValueError(f"unknown schedule {kind!r}; valid choices: cosine, "
                     f"linear, constant")
