"""Fused DRT distance statistics: the permute engine's neighbour statistics.

``drt_dist(x, y)`` returns ``[sum((x - y)^2), sum(y^2)]`` as a (2,) f32
tensor, for two tensors of one shape (any size >= 1).
``drt_dist_slots(x, y, slots)`` returns the same pair for every slot of a
:class:`SlotTable` over two (D,) rows, as (L, 2): the permute consensus
engine calls it once per neighbour exchange, with its own decoded slab row
as ``x``, the neighbour's as ``y`` and its DRT layer segments as the slots
(so the second column is the NEIGHBOUR's squared norm).  That is the
reference's per-slot ``drt_dist`` calls, stacked.

It replaces the Pallas TPU kernel ``repro/kernels/drt_dist.py``
``drt_dist``.  On CUDA tensors both wrappers launch the hand-written Hopper
kernel ``csrc/drt_dist.cu`` (built with nvcc for sm_90a, bound with ctypes)
or raise; on CPU tensors they run :func:`drt_dist_ref` (per slot), the
plain PyTorch version.  There is no fallback from one to the other.

The TPU kernel accumulates over a sequential grid; CUDA blocks run in no
order, so each block sums one (slot, chunk) pair and the last block of a
slot, picked by an integer ticket, sums the slot's partials in chunk order:
one launch a call (:data:`LAUNCHES_PER_CALL`), no floating-point atomics,
two runs give identical bits.  The plain version sums in torch's order, so
the two agree to a relative tolerance of the sums, not bit for bit.

``drt_dist.launches`` counts launches of the kernel from either wrapper
(CPU calls do not count).
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading

import torch

from repro_torch.kernels.counters import bump

LAUNCHES_PER_CALL = 1
CHUNK = 256 * 8  # elements a block sums (csrc/drt_dist.cu kChunk: 256 threads x 8)


@dataclasses.dataclass(frozen=True)
class SlotTable:
    """Slots ``[start, stop)`` of a row: ``bounds`` on the host, ``chunks``
    the kernel's (n_chunks, 5) int64 table (begin, end, slot, first chunk
    of the slot, chunks of the slot), slot by slot, on the device."""

    bounds: tuple[tuple[int, int], ...]
    chunks: torch.Tensor


def slot_table(bounds, device) -> SlotTable:
    """The :class:`SlotTable` of ``bounds`` ((start, stop) pairs, each slot
    non-empty) with its chunk table on ``device``."""
    bounds = tuple((int(s), int(e)) for s, e in bounds)
    rows = []
    for p, (s, e) in enumerate(bounds):
        if not 0 <= s < e:
            raise ValueError(f"slot {p} is [{s}, {e}): slots need 0 <= start < stop")
        first, count = len(rows), -(-(e - s) // CHUNK)
        rows += [(s + i * CHUNK, min(e, s + (i + 1) * CHUNK), p, first, count) for i in range(count)]
    if not rows:
        raise ValueError("a slot table needs at least one slot")
    return SlotTable(bounds, torch.tensor(rows, dtype=torch.int64, device=device))


def drt_dist_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`drt_dist`."""
    xf, yf = x.float(), y.float()
    d = xf - yf
    return torch.stack([(d * d).sum(), (yf * yf).sum()])


def drt_dist_slots_ref(x: torch.Tensor, y: torch.Tensor, slots: SlotTable) -> torch.Tensor:
    """Plain PyTorch version of :func:`drt_dist_slots`: :func:`drt_dist_ref`
    of each slot, stacked."""
    return torch.stack([drt_dist_ref(x[s:e], y[s:e]) for s, e in slots.bounds])


def _check(x, y):
    if x.shape != y.shape:
        raise ValueError(f"drt_dist needs equal shapes, got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"x on {x.device}, y on {y.device}")
    if x.numel() < 1:
        raise ValueError("drt_dist needs at least one element")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"drt_dist runs on CPU or CUDA tensors, got {x.device}")


def drt_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[sum((x - y)^2), sum(y^2)]`` as (2,) f32: one kernel launch on
    CUDA tensors, :func:`drt_dist_ref` on CPU tensors."""
    _check(x, y)
    if x.device.type == "cpu":
        return drt_dist_ref(x, y)
    n = x.numel()
    return _launch(x, y, None, n, -(-n // CHUNK), 1).view(2)


def drt_dist_slots(x: torch.Tensor, y: torch.Tensor, slots: SlotTable) -> torch.Tensor:
    """The (L, 2) statistics of every slot of ``slots`` over the (D,) rows
    ``x`` and ``y``: one kernel launch on CUDA tensors (the table on their
    device), :func:`drt_dist_slots_ref` on CPU tensors."""
    _check(x, y)
    if x.ndim != 1:
        raise ValueError(f"drt_dist_slots takes (D,) rows, got {tuple(x.shape)}")
    if max(e for _, e in slots.bounds) > x.shape[0]:
        raise ValueError(f"slots reach past the rows' {x.shape[0]} elements")
    if x.device.type == "cpu":
        return drt_dist_slots_ref(x, y, slots)
    if slots.chunks.device != x.device:
        raise ValueError(f"the slot table lies on {slots.chunks.device}, the rows on {x.device}")
    return _launch(x, y, slots.chunks, x.shape[0], slots.chunks.shape[0], len(slots.bounds))


def _launch(x, y, table, n, n_chunks, n_slots):
    """One launch over ``n_chunks`` chunks into a new (n_slots, 2) tensor."""
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"the drt_dist kernel takes float32 operands, got {x.dtype} and {y.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("the drt_dist kernel needs contiguous operands")
    fn = _fn()
    out = torch.empty(n_slots, 2, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        partial, tickets = _workspace(x.device, stream, n_chunks, n_slots)
        err = fn(x.data_ptr(), y.data_ptr(), None if table is None else table.data_ptr(), n, n_chunks,
                 partial.data_ptr(), tickets.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"drt_dist kernel launch failed: CUDA error {err}")
    bump(drt_dist, n=LAUNCHES_PER_CALL)
    return out


drt_dist.launches = 0

# Per (device, stream): the partial pairs and the slots' tickets.  Launches
# on one stream run in order, so they share them; every launch leaves the
# tickets at 0, as the kernel needs them.
_workspaces: dict = {}
_workspace_lock = threading.Lock()


def _workspace(device, stream, n_chunks, n_slots):
    key = (device.index, stream)
    with _workspace_lock:
        partial, tickets = _workspaces.get(key, (None, None))
        if partial is None or partial.numel() < 2 * n_chunks:
            partial = torch.empty(2 * n_chunks, dtype=torch.float32, device=device)
        if tickets is None or tickets.numel() < n_slots:
            tickets = torch.zeros(n_slots, dtype=torch.int32, device=device)
        _workspaces[key] = partial, tickets
    return partial, tickets


_typed_fn = None


def _fn():
    """The built kernel's entry point with its C signature set."""
    global _typed_fn
    if _typed_fn is None:
        from repro_torch.kernels import build

        fn = build.load("drt_dist").drt_dist_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _typed_fn = fn
    return _typed_fn
