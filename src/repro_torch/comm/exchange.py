"""Neighbour exchange between agents: the port's ``axis_index`` and ``ppermute``.

The reference's permute engine runs inside ``shard_map`` with one agent per
device and exchanges with ``jax.lax.axis_index`` and ``jax.lax.ppermute``.
Here an exchange object is passed explicitly: its ``rank`` and ``size``
stand for the axis index and size, and ``ppermute(tensors, perm)`` has
``jax.lax.ppermute``'s semantics for each tensor of the tuple:

* ``perm`` is a list of ``(src, dst)`` pairs, each rank at most once as a
  source and at most once as a destination;
* rank ``dst`` receives what rank ``src`` sent;
* a rank that no pair sends to receives zeros;
* a pair ``(k, k)`` delivers rank k's own tensors.

Every rank calls ``ppermute`` with the same ``perm`` in the same order.
``psum(tensor)`` is ``jax.lax.psum`` over the ranks: every rank gets the
sum of every rank's tensor (the permute engine's adaptive round gate takes
its global disagreement from it), the same bits on every rank.

Two implementations:

* :class:`ThreadExchange`, through :func:`spmd_run`: K agents as K threads of
  one process on one device, the counterpart of the reference's forced
  K-device mesh in one process.  ``ppermute`` is a mailbox between two
  barrier waits: every rank deposits its tensors, then reads its source's
  and clones them, then waits until every rank has read.  On a CUDA device
  every thread launches on its current stream (the device's default stream
  unless the caller set another, the same for every thread), so stream
  order keeps a clone after the sender's writes; nothing moves to the CPU.
  ``psum`` is the same mailbox: rank 0 adds the K deposited tensors in rank
  order 0..K-1 and every rank takes a copy of that one sum (K + 1 device
  operations a call, not K^2).
* :class:`DistExchange`: one rank per process over ``torch.distributed``;
  ``ppermute`` is one ``batch_isend_irecv`` per call (a send to this rank's
  destination and a receive from its source for each tensor); ``psum`` is
  one ``all_reduce``.  The caller
  starts the process group: NCCL with one rank per card, or gloo for CPU
  tensors.  A CUDA tensor under gloo raises; nothing is staged through the
  host.
"""
from __future__ import annotations

import threading
from typing import Callable, Sequence

import torch

from repro_torch.device import resolve_device

Perm = Sequence[tuple[int, int]]


def _peers(perm: Perm, rank: int, size: int) -> tuple[int | None, int | None]:
    """``(src, dst)`` of ``rank`` in ``perm``: whom it receives from and
    sends to (``None`` where no pair names it)."""
    src = dst = None
    seen_src, seen_dst = set(), set()
    for s, d in perm:
        s, d = int(s), int(d)
        if not (0 <= s < size and 0 <= d < size):
            raise ValueError(f"ppermute pair {(s, d)} out of range for {size} ranks")
        if s in seen_src or d in seen_dst:
            raise ValueError(f"ppermute perm names a rank twice as source or destination: {list(perm)}")
        seen_src.add(s)
        seen_dst.add(d)
        if d == rank:
            src = s
        if s == rank:
            dst = d
    return src, dst


class _Hub:
    """What the K threads of one :func:`spmd_run` share."""

    def __init__(self, size: int, timeout: float):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=timeout)
        self.mailbox: list = [None] * size
        self.total = None  # psum: rank 0's sum, or None when the ranks' tensors differ


class ThreadExchange:
    """One rank of K agents run as threads of one process (see the module
    docstring); made by :func:`spmd_run`."""

    def __init__(self, hub: _Hub, rank: int, device: torch.device):
        self._hub = hub
        self.rank = rank
        self.size = hub.size
        self.device = device

    def ppermute(self, tensors: tuple, perm: Perm) -> tuple:
        tensors = tuple(tensors)
        for t in tensors:
            if t.device != self.device:
                raise ValueError(f"rank {self.rank} runs on {self.device}, got a tensor on {t.device}")
        src, _ = _peers(perm, self.rank, self.size)
        hub = self._hub
        hub.mailbox[self.rank] = tensors
        hub.barrier.wait()
        if src is None:
            out = tuple(torch.zeros_like(t) for t in tensors)
        else:
            got = hub.mailbox[src]
            if len(got) != len(tensors) or any(
                a.shape != b.shape or a.dtype != b.dtype for a, b in zip(got, tensors)
            ):
                raise ValueError(f"rank {self.rank} and its source {src} sent different tensors")
            out = tuple(t.clone() for t in got)
        hub.barrier.wait()
        return out

    def psum(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``tensor`` (same shape and dtype on every
        rank), added in rank order by rank 0: every rank reads a copy of
        the same bits."""
        if tensor.device != self.device:
            raise ValueError(f"rank {self.rank} runs on {self.device}, got a tensor on {tensor.device}")
        hub = self._hub
        hub.mailbox[self.rank] = (tensor,)
        hub.barrier.wait()
        if self.rank == 0:
            parts = [hub.mailbox[k][0] for k in range(self.size)]
            total = None
            if all(p.shape == tensor.shape and p.dtype == tensor.dtype for p in parts):
                total = parts[0].clone()
                for p in parts[1:]:
                    total.add_(p)
            hub.total = total
        hub.barrier.wait()  # no rank deposits again before rank 0 has read every part
        if hub.total is None:
            raise ValueError(f"rank {self.rank}: the ranks passed psum different tensors")
        return hub.total.clone()


def spmd_run(fn: Callable, K: int, *, device: "torch.device | str | None" = None,
             timeout: float = 120.0) -> list:
    """Run ``fn(rank, exchange)`` for ranks ``0 .. K-1``, each in its own
    thread with a :class:`ThreadExchange`; returns the results in rank
    order.  The counterpart of ``shard_map`` over a K-device mesh in one
    process.

    ``device``: where the agents' tensors live (``exchange.device``), CUDA
    by default (raises without a GPU; pass ``device="cpu"`` for the CPU).
    The first exception in any rank aborts the others' barrier waits and
    is raised here; a barrier wait longer than ``timeout`` seconds (ranks
    calling ``ppermute`` a different number of times) fails, it never
    hangs."""
    if K < 1:
        raise ValueError(f"spmd_run needs K >= 1, got {K}")
    dev = resolve_device(device)
    hub = _Hub(K, timeout)
    results: list = [None] * K
    errors: list = []

    def run(rank: int) -> None:
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            results[rank] = fn(rank, ThreadExchange(hub, rank, dev))
        except Exception as e:  # handed to the caller below
            errors.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,), name=f"spmd-rank-{r}") for r in range(K)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        # the rank that failed first, not the waits its abort broke
        raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)), errors[0])
    return results


class DistExchange:
    """One rank per process over ``torch.distributed`` (module docstring).
    ``group``: the process group (default: the world)."""

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistExchange needs torch.distributed.init_process_group first")
        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self._backend = str(dist.get_backend(group)).lower()

    def ppermute(self, tensors: tuple, perm: Perm) -> tuple:
        dist = self._dist
        tensors = tuple(t.contiguous() for t in tensors)
        for t in tensors:
            if t.device.type == "cuda" and self._backend == "gloo":
                raise ValueError(
                    "DistExchange: a CUDA tensor under the gloo backend; use NCCL for card "
                    "tensors (nothing is staged through the host)"
                )
        src, dst = _peers(perm, self.rank, self.size)
        if src == self.rank:
            return tuple(t.clone() for t in tensors)
        out = tuple(torch.zeros_like(t) if src is None else torch.empty_like(t) for t in tensors)
        ops = []
        peer = lambda r: dist.get_global_rank(self.group, r) if self.group is not None else r  # noqa: E731
        if dst is not None and dst != self.rank:
            ops += [dist.P2POp(dist.isend, t, peer(dst), self.group) for t in tensors]
        if src is not None:
            ops += [dist.P2POp(dist.irecv, t, peer(src), self.group) for t in out]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def psum(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``tensor``: one ``all_reduce``."""
        if tensor.device.type == "cuda" and self._backend == "gloo":
            raise ValueError("DistExchange: a CUDA tensor under the gloo backend; use NCCL for card tensors")
        out = tensor.contiguous().clone()
        self._dist.all_reduce(out, op=self._dist.ReduceOp.SUM, group=self.group)
        return out
