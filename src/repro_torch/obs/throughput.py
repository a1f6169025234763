"""Host-side throughput: steps/s and tokens/s of a train loop.

Counterpart of ``repro.obs.throughput``.  For honest numbers the device
must be synchronized inside the window: call :meth:`Throughput.update`
after ``torch.cuda.synchronize()`` (or after reading a metric to the host,
which synchronizes).
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass(frozen=True)
class Rate:
    """One measurement window's throughput."""

    steps_per_s: float
    tokens_per_s: float
    steps: int
    tokens: int
    seconds: float


def _rate(steps: int, tokens: int, dt: float) -> Rate:
    # a window shorter than the clock's resolution (dt == 0) has no rate:
    # 0.0, not steps / 1e-9
    if dt <= 0.0:
        return Rate(0.0, 0.0, steps, tokens, max(dt, 0.0))
    return Rate(steps / dt, tokens / dt, steps, tokens, dt)


class Throughput:
    """Windowed and lifetime steps/s and tokens/s.  ``update(steps,
    tokens)`` returns the :class:`Rate` of the window since the previous
    update (the first opens at construction); ``lifetime()`` covers
    everything since construction."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._start = self._t0 = clock()
        self.total_steps = 0
        self.total_tokens = 0

    def update(self, steps: int, tokens: int = 0) -> Rate:
        now = self._clock()
        dt, self._t0 = now - self._t0, now
        self.total_steps += steps
        self.total_tokens += tokens
        return _rate(steps, tokens, dt)

    def lifetime(self) -> Rate:
        return _rate(self.total_steps, self.total_tokens, self._clock() - self._start)
