"""The chunk plan and the ticket workspace of a DRT round's stats launch.

The stats launch of ``slab_encode_combine`` and of the edge kernels
(``csrc/slab_codec.cu``, ``csrc/slab_segment.cu``; the reduction in
``csrc/split_reduce.cuh``) sums per-layer statistics over every column of
the slab in ONE launch.  Its blocks take one chunk each: up to
:data:`CHUNK_BLOCKS` consecutive 128-column blocks of one layer, a layer's
blocks split into chunks of near-equal length.  Each block writes one
partial; an integer ticket per layer picks the layer's last block, which
sums the layer's partials in chunk order; a last ticket picks the block
that finishes the last layer, which computes the mixing weights.

:func:`chunk_plan` builds the plan's tables from ``block_layer`` (the
layout's non-decreasing block -> layer map) on the host, once per map
tensor: a map on the card is copied to the host on first use only.
:func:`tickets` is the per-(device, stream) ticket workspace: one zeroed
int32 per layer and one for the round.  Launches on one stream run in
order and each leaves its tickets at 0, so they share it.  The stats
launch streams the slab with 16-byte ``cp.async`` copies:
:func:`check_aligned` raises unless its operands start 16-byte aligned (it
never copies them).
"""
from __future__ import annotations

import dataclasses
import threading
import weakref

import numpy as np
import torch

CHUNK_BLOCKS = 10  # column blocks a stats block sums at most
ALIGN = 16  # bytes: the base address of every operand the stats launch streams


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """``chunks`` (n_chunks, 4) int32 rows (layer, first block, end block,
    0), layer by layer; ``layers`` (L, 2) int32 rows (first chunk, chunks);
    ``n_busy`` the layers that have a chunk (the round ticket's count)."""

    chunks: torch.Tensor
    layers: torch.Tensor
    n_chunks: int
    n_busy: int


def plan_chunks(block_layer: np.ndarray, num_layers: int, chunk_blocks: int = CHUNK_BLOCKS):
    """The plan's ``(chunks, layers)`` int32 tables of a block -> layer map
    (numpy): layer ``p``'s ``n_p`` blocks in ``ceil(n_p / chunk_blocks)``
    chunks, chunk ``i`` of ``m`` holding blocks ``[b0 + floor(i n_p / m),
    b0 + floor((i + 1) n_p / m))``.  Raises unless the map is
    non-decreasing with values in ``[0, num_layers)``."""
    bl = np.asarray(block_layer).astype(np.int64).ravel()
    if bl.size < 1 or chunk_blocks < 1:
        raise ValueError("a chunk plan needs at least one block and chunk_blocks >= 1")
    if bl.min() < 0 or bl.max() >= num_layers:
        raise ValueError(f"block_layer values must lie in [0, {num_layers}), got {bl.min()}..{bl.max()}")
    if np.any(np.diff(bl) < 0):
        raise ValueError("block_layer must be non-decreasing (each layer's blocks contiguous)")
    starts = np.searchsorted(bl, np.arange(num_layers + 1))
    chunks, layers = [], np.zeros((num_layers, 2), np.int32)
    for p in range(num_layers):
        b0, n = int(starts[p]), int(starts[p + 1] - starts[p])
        m = -(-n // chunk_blocks)
        layers[p] = (len(chunks), m)
        chunks += [(p, b0 + i * n // m, b0 + (i + 1) * n // m, 0) for i in range(m)]
    return np.asarray(chunks, np.int32).reshape(-1, 4), layers


def chunk_plan(block_layer: torch.Tensor, num_layers: int) -> ChunkPlan:
    """The :class:`ChunkPlan` of ``block_layer`` on its device, cached while
    that tensor lives and is not written to (:func:`per_tensor`)."""

    def build():
        chunks, layers = plan_chunks(block_layer.cpu().numpy(), num_layers)
        dev = block_layer.device
        return ChunkPlan(torch.from_numpy(chunks).to(dev), torch.from_numpy(layers).to(dev),
                         chunks.shape[0], int((layers[:, 1] > 0).sum()))

    return per_tensor(block_layer, ("chunk_plan", num_layers), build)


def zero_idle_layers(stats: torch.Tensor, plan: ChunkPlan) -> torch.Tensor:
    """``stats`` (L, ...) with the rows of layers that have no chunk set to
    0: the stats launch never writes them (a layer without columns sums to
    0, as the plain versions give)."""
    if plan.n_busy == stats.shape[0]:
        return stats
    idle = plan.layers[:, 1] == 0
    return stats.masked_fill(idle.view(-1, *([1] * (stats.dim() - 1))), 0.0)


_memo: dict = {}
_memo_lock = threading.Lock()


def per_tensor(t: torch.Tensor, tag, make):
    """``make()``, computed once per ``(t, tag)`` and kept while ``t`` lives
    and is not written to (its version counter): host work derived from a
    static map, such as a plan or a range check that syncs the device, is
    paid on the map's first use only."""
    key = (id(t), tag)
    with _memo_lock:
        hit = _memo.get(key)
        if hit is not None and hit[0]() is t and hit[1] == t._version:
            return hit[2]
    value = make()
    ref = weakref.ref(t, lambda _: _forget(key))
    with _memo_lock:
        _memo[key] = (ref, t._version, value)
    return value


def _forget(key):
    with _memo_lock:
        hit = _memo.get(key)
        if hit is not None and hit[0]() is None:
            del _memo[key]


_tickets: dict = {}
_tickets_lock = threading.Lock()


def tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 tickets for launches on ``stream``
    (``cudaStream_t`` as an int) of ``device``."""
    key = (device.index, stream)
    with _tickets_lock:
        t = _tickets.get(key)
        if t is None or t.numel() < n:
            t = _tickets[key] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    return t


def check_aligned(name: str, **tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` unless every tensor's data starts ``ALIGN``-byte
    aligned (the kernel reads rows of them in 16-byte pieces)."""
    for key, t in tensors.items():
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name} needs a {ALIGN}-byte aligned {key} (read in {ALIGN}-byte pieces), "
                             f"got one at {t.data_ptr() % ALIGN} bytes past it")
