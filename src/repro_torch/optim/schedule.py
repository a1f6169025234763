"""Learning-rate schedules as ``step -> lr`` callables (counterpart of
``repro.optim.schedule``).  Each computes in f32, in the reference's order
of operations as XLA compiles it on the CPU where that was found to matter
(the warmup's constants folded into ``lr * f32(1 / w)``; the warmup
cosine's division a product with the f32 reciprocal; ``a * b + c`` one
fused multiply-add), and returns a Python float that is an f32 value, as
the optimizers multiply by it.  XLA's f32 cosine is not correctly rounded,
so the cosine schedules agree with the reference to a few ulps of ``lr``;
``step_decay`` and the warmup agree bit for bit."""
from __future__ import annotations

import numpy as np

_F32 = np.float32


def _cos(x):
    """f32 cosine, correctly rounded."""
    return _F32(np.cos(np.float64(x)))


def _fma(a, b, c):
    """``a * b + c`` rounded once to f32, as XLA on the CPU contracts it
    (the f32 product is exact in f64)."""
    return _F32(np.float64(a) * np.float64(b) + np.float64(c))


def constant(lr: float):
    return lambda step: float(lr)


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def fn(step):
        t = np.minimum(_F32(step), _F32(decay_steps)) / _F32(decay_steps)
        cos = _F32(0.5) * (_F32(1.0) + _cos(_F32(np.pi) * t))
        return float(_F32(lr) * _fma(_F32(1 - alpha), cos, _F32(alpha)))

    return fn


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int, alpha: float = 0.0):
    def fn(step):
        s = _F32(step)
        warm = s * (_F32(lr) * _F32(1.0 / max(warmup_steps, 1)))  # XLA folds the constants
        t = np.clip((s - _F32(warmup_steps)) * _F32(1.0 / max(total_steps - warmup_steps, 1)), _F32(0.0), _F32(1.0))
        cos = _F32(lr) * _fma(_F32((1 - alpha) * 0.5), _F32(1.0) + _cos(_F32(np.pi) * t), _F32(alpha))
        return float(warm if s < _F32(warmup_steps) else cos)

    return fn


def step_decay(lr: float, boundaries: tuple, factor: float = 0.1):
    def fn(step):
        s = _F32(step)
        k = _F32(sum(1.0 for b in boundaries if s >= _F32(b)))
        return float(_F32(lr) * _F32(factor) ** k)

    return fn
