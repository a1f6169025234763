"""Launch counters of the kernel wrappers, safe across threads.

Each wrapper carries plain integer attributes (``fn.launches``, and
``fn.calls`` where one call makes several launches) that a run resets and
reads to show that its main path went through the kernels.  ``fn.launches
+= 1`` is a read-modify-write, which threads can interleave and lose an
update in; the permute engine runs one agent per thread
(``repro_torch.comm.exchange.spmd_run``), so every wrapper bumps its
counters through :func:`bump`, under one lock.
"""
from __future__ import annotations

import threading

_lock = threading.Lock()


def bump(fn, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` to the integer attribute ``attr`` of ``fn``, atomically."""
    with _lock:
        setattr(fn, attr, getattr(fn, attr) + n)
