"""The weighted neighbour combine: ``out = sum_n a[n] * xs[n]``.

``weighted_combine(a, xs)`` takes ``a`` (N,) f32 and ``xs`` (N, ...) f32 or
bf16 and returns an ``xs[0]``-shaped tensor in ``xs``'s dtype, accumulated
in f32.  A batched call takes ``a`` (M, N), one weight row per output, and
returns (M, ...) in ONE launch.

``weighted_combine_segments(W, xs, table)`` is the same kernel over a table
of column segments of one (N, n_cols) operand, each segment with its own
(M, N) weights ``W[p]`` of a stacked (P, M, N) view, in ONE launch; the
columns in no segment are written 0.  The reference's per-slot consensus
combine runs the TPU kernel under ``jax.vmap`` over the output agents, once
per DRT layer slot: here that is one launch over every slot
(``repro_torch.core.consensus.combine_slab_per_slot``).  The tables are
:class:`SegmentTable` s (:func:`segment_table`; a slab layout caches its
own).  ``weighted_combine`` is the one-segment launch of the same kernel.

It replaces the Pallas TPU kernel ``repro/kernels/combine.py``
``weighted_combine``.  On a CUDA tensor the wrappers launch the
hand-written Hopper kernel ``csrc/combine.cu`` (built with nvcc for
sm_90a, bound with ctypes) or raise; on a CPU tensor they run
:func:`weighted_combine_ref` / :func:`weighted_combine_segments_ref`, the
plain PyTorch versions.  There is no fallback from one to the other.  Both
sum over n in the Pallas body's order and round product and sum apart, so
they agree bit for bit.

Operands are read where they lie: the weights through their strides (the
per-slot combine passes its (L, K, K) matrices transposed, a view), the
rows of ``xs`` any stride apart (each row contiguous; a column slice of a
slab goes in without a copy).  The kernel is bound by device memory (see
the source note).

``weighted_combine.launches`` counts kernel launches of both wrappers (CPU
calls do not count).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels.counters import bump

MAX_SOURCES = 64  # largest N the kernel takes (csrc/combine_rows.cuh kMaxSources)
TILE_COLS = 512  # columns of a tile, the kernel's work item (csrc/combine_rows.cuh kTile)
DTYPES = (torch.float32, torch.bfloat16)
_I32_MAX = 2**31 - 1


# -- segment tables ------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class SegmentTable:
    """Column segments of an ``(N, n_cols)`` operand: ``segments`` ((first
    column, width, p, sid), ...) in column order, disjoint; ``p`` picks the
    segment's weight matrix, ``sid`` its scale column (``dequant_combine``;
    0 for ``weighted_combine``).  ``tiles`` is the kernel's (n_tiles, 4)
    int64 work list on ``tiles.device`` (:func:`plan_tiles`)."""

    segments: tuple
    n_cols: int
    tiles: torch.Tensor
    max_p: int
    max_sid: int


def plan_tiles(segments, n_cols: int, tile: int = TILE_COLS) -> np.ndarray:
    """The kernel's tiles of a segment list (numpy, int64 rows (first
    column, end column, p, sid)): each segment, and each run of columns of
    ``[0, n_cols)`` in no segment (``p = -1``: written 0), cut at the
    multiples of ``tile``.  Raises ``ValueError`` on a segment with a
    negative index, an empty width or columns past ``n_cols``, and on two
    segments that overlap."""
    segs = sorted(tuple(int(v) for v in seg) for seg in segments)
    if n_cols < 1 or not segs:
        raise ValueError(f"a segment table needs n_cols >= 1 and a segment, got {n_cols} and {len(segs)}")
    rows, at = [], 0

    def cut(a, b, p, sid):
        while a < b:
            e = min(b, (a // tile + 1) * tile)
            rows.append((a, e, p, sid))
            a = e

    for c0, width, p, sid in segs:
        if c0 < 0 or width < 1 or c0 + width > n_cols or p < 0 or sid < 0:
            raise ValueError(f"segment (col0 {c0}, width {width}, p {p}, sid {sid}) out of range for "
                             f"{n_cols} columns")
        if c0 < at:
            raise ValueError(f"segments overlap: one starts at column {c0}, inside another ending at {at}")
        cut(at, c0, -1, 0)
        cut(c0, c0 + width, p, sid)
        at = c0 + width
    cut(at, n_cols, -1, 0)
    return np.asarray(rows, np.int64)


def segment_table(segments, n_cols: int, device) -> SegmentTable:
    """A checked :class:`SegmentTable` with its tiles on ``device``."""
    segs = tuple(sorted(tuple(int(v) for v in seg) for seg in segments))
    tiles = plan_tiles(segs, n_cols)
    return SegmentTable(segs, int(n_cols), torch.from_numpy(tiles).to(device),
                        max(s[2] for s in segs), max(s[3] for s in segs))


# -- plain PyTorch versions ----------------------------------------------------


def weighted_combine_ref(a: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`weighted_combine`: the kernel's
    ordered loop over the sources, one rounded product and one rounded sum
    per source, then the cast to ``xs``'s dtype."""
    w, x, shape = _rows(a, xs)
    acc = w[:, :1] * x[0]
    for n in range(1, x.shape[0]):
        acc = acc + w[:, n : n + 1] * x[n]
    return acc.to(xs.dtype).reshape(shape)


def weighted_combine_segments_ref(W: torch.Tensor, xs: torch.Tensor, table: SegmentTable) -> torch.Tensor:
    """Plain PyTorch version of :func:`weighted_combine_segments`: each
    segment through :func:`weighted_combine_ref`, zeros elsewhere."""
    check_segments("weighted_combine", W, xs, table)
    out = torch.zeros((W.shape[1], table.n_cols), dtype=xs.dtype, device=xs.device)
    for c0, width, p, _ in table.segments:
        out[:, c0 : c0 + width] = weighted_combine_ref(W[p], xs[:, c0 : c0 + width])
    return out


# -- wrappers ------------------------------------------------------------------


def weighted_combine(a: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``sum_n a[n] * xs[n]`` (``a`` (N,)) or, batched, ``out[m] = sum_n
    a[m, n] * xs[n]`` (``a`` (M, N)): ONE kernel launch on CUDA tensors,
    :func:`weighted_combine_ref` on CPU tensors."""
    _check(a, xs)
    if xs.device.type == "cpu":
        return weighted_combine_ref(a, xs)
    _check_card(a, xs)
    N = xs.shape[0]
    n = xs[0].numel()
    ldx = xs.stride(0) if N > 1 else n
    if not xs[0].is_contiguous() or ldx < n:
        raise ValueError("the weighted_combine kernel needs disjoint contiguous source rows")
    W = a[None] if a.dim() == 2 else a[None, None]  # views, any strides
    return _launch(W, xs, ldx, None, n).reshape(_out_shape(a, xs))


def weighted_combine_segments(W: torch.Tensor, xs: torch.Tensor, table: SegmentTable) -> torch.Tensor:
    """``out[m, c] = sum_n W[p, m, n] * xs[n, c]`` for the columns ``c`` of
    each segment ``(col0, width, p, _)`` of ``table``, 0 in no segment:
    ``W`` a (P, M, N) f32 view (any strides), ``xs`` (N, n_cols) f32 or bf16
    with contiguous rows; returns (M, n_cols) in ``xs``'s dtype.  ONE kernel
    launch on CUDA tensors (counted as one ``weighted_combine`` launch),
    :func:`weighted_combine_segments_ref` on CPU tensors."""
    check_segments("weighted_combine", W, xs, table)
    if xs.device.type == "cpu":
        return weighted_combine_segments_ref(W, xs, table)
    _check_card(W, xs, table.tiles)
    N, n_cols = xs.shape
    if xs.stride(1) != 1 or (N > 1 and xs.stride(0) < n_cols):
        raise ValueError("the weighted_combine kernel needs disjoint contiguous source rows")
    return _launch(W, xs, xs.stride(0), table.tiles, n_cols)


weighted_combine.launches = 0


def _launch(W, xs, ldx, tiles, n_cols):
    """One launch over ``tiles`` (None: one segment over ``[0, n_cols)``);
    returns the new (M, n_cols) output."""
    fn = _kernel()  # a failed build raises here, before anything is allocated
    N = xs.shape[0]
    ws = weight_strides(W)
    out = torch.empty((W.shape[1], n_cols), dtype=xs.dtype, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = fn(W.data_ptr(), *ws, xs.data_ptr(), ldx, out.data_ptr(), out.stride(0),
                 None if tiles is None else tiles.data_ptr(), 0 if tiles is None else tiles.shape[0],
                 n_cols, W.shape[1], N, int(xs.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"weighted_combine kernel launch failed: CUDA error {err}")
    bump(weighted_combine)
    return out


def weight_strides(W: torch.Tensor) -> tuple:
    """The (P, M, N) weight view's element strides as C ints (0 along a
    dimension of size 1); raises ``ValueError`` where its extent does not
    fit one."""
    strides = tuple(st if d > 1 else 0 for d, st in zip(W.shape, W.stride()))
    if sum((d - 1) * st for d, st in zip(W.shape, strides)) > _I32_MAX:
        raise ValueError(f"the combine kernels index weights with 32-bit offsets; got strides {W.stride()}")
    return strides


def _check(a: torch.Tensor, xs: torch.Tensor) -> None:
    if xs.dim() < 1 or a.dim() not in (1, 2) or a.shape[-1] != xs.shape[0]:
        raise ValueError(
            f"weighted_combine needs a (N,) or (M, N) and xs (N, ...), got {tuple(a.shape)} "
            f"and {tuple(xs.shape)}"
        )
    if xs.shape[0] < 1 or xs[0].numel() < 1:
        raise ValueError(f"weighted_combine needs at least one source element, got {tuple(xs.shape)}")
    if a.device != xs.device:
        raise ValueError(f"a on {a.device}, xs on {xs.device}")


def check_segments(name: str, W: torch.Tensor, xs: torch.Tensor, table: SegmentTable) -> None:
    """Shapes and devices of a segment call: ``W`` (P, M, N), ``xs`` (N,
    table.n_cols), every segment's ``p`` below P."""
    if W.dim() != 3 or xs.dim() != 2 or W.shape[2] != xs.shape[0] or min(W.shape) < 1:
        raise ValueError(f"{name}_segments needs W (P, M, N) and xs (N, n_cols), got {tuple(W.shape)} "
                         f"and {tuple(xs.shape)}")
    if xs.shape[1] != table.n_cols:
        raise ValueError(f"the segment table spans {table.n_cols} columns, xs has {xs.shape[1]}")
    if table.max_p >= W.shape[0]:
        raise ValueError(f"a segment's weight index {table.max_p} is out of range for {W.shape[0]} matrices")
    if W.device != xs.device:
        raise ValueError(f"W on {W.device}, xs on {xs.device}")


def _check_card(W: torch.Tensor, xs: torch.Tensor, tiles: "torch.Tensor | None" = None) -> None:
    if xs.device.type != "cuda":
        raise ValueError(f"weighted_combine runs on CPU or CUDA tensors, got {xs.device}")
    if tiles is not None and tiles.device != xs.device:
        raise ValueError(f"the segment table's tiles are on {tiles.device}, xs on {xs.device}")
    if xs.dtype not in DTYPES or W.dtype != torch.float32:
        raise TypeError(
            f"the weighted_combine kernel takes f32 weights and f32 or bf16 sources, got a "
            f"{W.dtype} and xs {xs.dtype}"
        )
    if not 1 <= xs.shape[0] <= MAX_SOURCES:
        raise ValueError(f"the weighted_combine kernel takes 1..{MAX_SOURCES} sources, got N={xs.shape[0]}")


def _out_shape(a: torch.Tensor, xs: torch.Tensor) -> tuple:
    return (*a.shape[:-1], *xs.shape[1:])


def _rows(a: torch.Tensor, xs: torch.Tensor):
    """``(w (M, N) f32, x (N, n) f32, output shape)`` of a combine."""
    _check(a, xs)
    N = xs.shape[0]
    return a.float().reshape(-1, N), xs.float().reshape(N, -1), _out_shape(a, xs)


_typed_fn = None


def _kernel():
    global _typed_fn
    if _typed_fn is None:
        from repro_torch.kernels import build

        P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn = build.load("combine").weighted_combine_segments
        fn.argtypes = [P, I, I, I, P, I64, P, I64, P, I64, I64, I, I, I, P]
        fn.restype = ctypes.c_int
        _typed_fn = fn
    return _typed_fn
