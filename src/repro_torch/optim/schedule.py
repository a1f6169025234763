"""Learning-rate schedules as ``step -> lr`` callables (counterpart of
``repro.optim.schedule``; only ``constant`` is ported)."""
from __future__ import annotations


def constant(lr: float):
    return lambda step: float(lr)
