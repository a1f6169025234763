"""Whole-slab per-layer combines: the gather engine's agent mixing and the
permute engine's source combine.

``slab_combine(A_blocks, slab)`` computes

    out[k, c] = sum_l A_blocks[c // 128, l, k] * slab[l, c]

for ``A_blocks`` (n_blocks, K, K) f32 and ``slab`` (K, n_blocks * 128) f32:
every 128-column block of the packed slab belongs to one DRT layer
(``SlabLayout.block_layer``) and is mixed by that layer's (K, K) matrix.

It replaces the Pallas TPU kernel ``repro/kernels/slab_combine.py``
``slab_combine``.  On a CUDA tensor the wrapper launches the hand-written
Hopper kernel ``csrc/slab_combine.cu`` (built with nvcc for sm_90a, bound
with ctypes) or raises; on a CPU tensor it runs :func:`slab_combine_ref`,
the plain PyTorch version.  There is no fallback from one to the other.

The kernel is bound by device memory (see the source note): it reads the
slab and A_blocks once and writes the output once.  It streams both through
a ring of shared-memory tiles loaded by the Tensor Memory Accelerator, so
their base addresses must be 16-byte aligned (``kernels/tma.py``; a
contiguous tensor from PyTorch's allocator is); the wrapper raises on one
that is not and never copies.

``slab_source_combine(w_blocks, srcs)`` computes

    out[c] = sum_n w_blocks[c // 128, n] * srcs[n][c]

for ``w_blocks`` (n_blocks, N) f32 and ``srcs`` either a stacked
(N, n_blocks * 128) f32 tensor or a sequence of N (n_blocks * 128,) f32
tensors: the permute engine's combine of one agent's own slab and the N - 1
slabs it received, each 128-column block weighted by its layer's mixing
column.  The engine passes the sequence, so nothing is stacked: the kernel
reads each source where it lies (its pointer travels in the launch's
parameters), and each must be contiguous and start 16-byte aligned (the
kernel reads 4 columns at a time), or the wrapper raises ``ValueError``
before any launch.  It replaces the Pallas TPU kernel
``slab_source_combine`` of the same module; the kernel
(``csrc/slab_combine.cu``) and :func:`slab_source_combine_ref` both sum
over n in order and round product and sum apart, so they agree bit for bit,
in either form.

``slab_dequant_combine(A, scales, col_seg, q_slab[, block_map])`` is the
fused int8 form of ``slab_combine``: the (K, D) int8 wire ``q_slab`` is
decoded column by column (``scales[l, col_seg[c]] * q[l, c]``) inside the
kernel and mixed as ``slab_combine`` mixes, so the decoded f32 slab never
reaches device memory.  ``A`` is the per-block ``A_blocks``, or a (P, K, K)
stack read through ``block_map`` (each block's matrix index): the slab path
passes its (L, K, K) mixing and the layout's ``block_layer``, so no
per-block copy is made.  It replaces the Pallas TPU kernel
``slab_dequant_combine`` of the same module, which rebuilds the per-column
scales with a one-hot matmul; the CUDA kernel gathers them through
``col_seg``.  The ids of ``col_seg`` and of the map are checked before any
launch, once per map tensor while it is not written to, so the path's call
is one device operation with no host sync.  Its plain version
:func:`slab_dequant_combine_ref` decodes, then runs :func:`slab_combine_ref`.

``slab_combine.launches``, ``slab_dequant_combine.launches`` and
``slab_source_combine.launches`` count kernel launches (CPU calls do not
count), so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import layer_chunks, tma
from repro_torch.kernels.counters import bump

LANES = 128  # column-block width; SlabLayout pads every layer segment to it
MAX_AGENTS = 64  # largest K the kernel takes (its shared-memory budget)
MAX_SOURCES = 64  # largest N slab_source_combine takes (one weight per thread)


def slab_combine_ref(A_blocks: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`slab_combine`: one batched matmul over
    the column blocks, ``(nb, K, K)^T x (nb, K, 128)``."""
    K, D = slab.shape
    nb = A_blocks.shape[0]
    x = slab.float().view(K, nb, LANES).transpose(0, 1)  # (nb, K, 128)
    out = torch.bmm(A_blocks.float().transpose(1, 2), x)  # (nb, K, 128)
    return out.transpose(0, 1).reshape(K, D).to(slab.dtype)


def _check(A_blocks: torch.Tensor, slab: torch.Tensor) -> None:
    if slab.dim() != 2 or A_blocks.dim() != 3:
        raise ValueError(
            f"slab_combine needs A_blocks (nb, K, K) and slab (K, D), got "
            f"{tuple(A_blocks.shape)} and {tuple(slab.shape)}"
        )
    K, D = slab.shape
    nb = A_blocks.shape[0]
    if nb * LANES != D:
        raise ValueError(f"slab width {D} != {nb} blocks x {LANES} lanes")
    if tuple(A_blocks.shape[1:]) != (K, K):
        raise ValueError(f"A_blocks must be ({nb}, {K}, {K}), got {tuple(A_blocks.shape)}")
    if A_blocks.device != slab.device:
        raise ValueError(f"A_blocks on {A_blocks.device}, slab on {slab.device}")


def slab_combine(A_blocks: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    """Whole-slab per-layer agent mixing in ONE kernel launch (CUDA tensors)
    or through :func:`slab_combine_ref` (CPU tensors).  Returns a new
    (K, D) tensor in the slab's dtype."""
    _check(A_blocks, slab)
    if slab.device.type == "cpu":
        return slab_combine_ref(A_blocks, slab)
    if slab.device.type != "cuda":
        raise ValueError(f"slab_combine runs on CPU or CUDA tensors, got {slab.device}")
    if slab.dtype != torch.float32 or A_blocks.dtype != torch.float32:
        raise TypeError(
            f"the slab_combine kernel takes float32 operands, got A_blocks "
            f"{A_blocks.dtype} and slab {slab.dtype}"
        )
    if not (slab.is_contiguous() and A_blocks.is_contiguous()):
        raise ValueError("the slab_combine kernel needs contiguous operands")
    K = slab.shape[0]
    if not 1 <= K <= MAX_AGENTS:
        raise ValueError(f"the slab_combine kernel takes 1..{MAX_AGENTS} agents, got K={K}")
    fn = _kernel()
    out = torch.empty_like(slab)
    maps = [tma.pack(m) for m in slab_combine_tensor_maps(A_blocks, slab, out)]
    with torch.cuda.device(slab.device):
        stream = torch.cuda.current_stream(slab.device).cuda_stream
        err = fn(A_blocks.data_ptr(), slab.data_ptr(), out.data_ptr(), K, A_blocks.shape[0], *maps, stream)
    if err < 0:
        raise RuntimeError(f"slab_combine: the driver refused a tensor map (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"slab_combine kernel launch failed: CUDA error {err}")
    bump(slab_combine)
    return out


slab_combine.launches = 0


def slab_combine_tensor_maps(A_blocks: torch.Tensor, slab: torch.Tensor, out: torch.Tensor):
    """The kernel's three TMA maps (``kernels/tma.py``): the slab and the
    output as (D, K) in boxes of (128 columns, K rows), and ``A_blocks``
    seen flat in boxes of at most 256 floats, enough for one block's K^2
    floats from the 16-byte boundary at or below them (3 more when
    K % 4 != 0; the kernel's ``a_span``).  Raises ``ValueError`` on a base
    address that TMA refuses."""
    K = slab.shape[0]
    span = K * K + (3 if K % 4 else 0)
    a_box = min(tma.MAX_BOX, -(-span // 4) * 4)
    return (
        tma.tensor_map_args(slab, (1, 0), (LANES, K), name="slab"),
        tma.tensor_map_args(A_blocks.reshape(-1), (0,), (a_box,), name="A_blocks"),
        tma.tensor_map_args(out, (1, 0), (LANES, K), name="out"),
    )


def slab_dequant_combine_ref(A, scales, col_seg, q_slab, block_map=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`slab_dequant_combine`: the decoded
    slab ``scales[l, col_seg[c]] * q[l, c]`` (one rounded product, as the
    kernel forms it), then :func:`slab_combine_ref` with each block's
    matrix (``A[block_map]`` where a map is given)."""
    A_blocks = A if block_map is None else A[block_map.reshape(-1).long()]
    seg = col_seg.reshape(-1).long()
    return slab_combine_ref(A_blocks, scales.float()[:, seg] * q_slab.float())


def _check_ids(ids: torch.Tensor, n: int, what: str, has: str) -> None:
    """Raise ``ValueError`` unless every id lies in ``[0, n)``.  The range
    costs one device sync, on the map's first use only
    (``layer_chunks.per_tensor``): a layout's static maps are checked once."""
    lo, hi = layer_chunks.per_tensor(ids, "id range", lambda: tuple(int(v) for v in torch.aminmax(ids.reshape(-1))))
    if lo < 0 or hi >= n:
        raise ValueError(f"{what} {lo}..{hi}; {has} {n}")


def slab_dequant_combine(A, scales, col_seg, q_slab, block_map=None) -> torch.Tensor:
    """Fused int8 dequantize + whole-slab combine in ONE kernel launch (CUDA
    tensors) or through :func:`slab_dequant_combine_ref` (CPU tensors):

        out[k, c] = sum_l A_c[l, k] * scales[l, col_seg[c]] * q[l, c]

    with ``A_c`` column ``c``'s block's matrix: ``A[c // 128]`` for ``A``
    (n_blocks, K, K) (the API's ``A_blocks``), or ``A[block_map[c // 128]]``
    for a (P, K, K) stack and ``block_map`` (n_blocks,) int32 (the layout's
    ``block_layer``: no per-block copy of the matrices).  ``scales`` (K,
    n_segs) f32, ``col_seg`` (n_blocks, 128) or (D,) int32 (the layout's
    ``col_scale_seg``), ``q_slab`` (K, D) int8.  Every segment id must lie
    in ``[0, n_segs)`` and every map entry in ``[0, P)``: checked before any
    launch, each map tensor once while it is not written to.  Returns a new
    (K, D) f32 tensor."""
    if q_slab.dim() != 2 or A.dim() != 3 or q_slab.shape[1] % LANES:
        raise ValueError(f"slab_dequant_combine needs A (P, K, K) and q_slab (K, n_blocks x {LANES}), got "
                         f"{tuple(A.shape)} and {tuple(q_slab.shape)}")
    K, D = q_slab.shape
    nb = D // LANES
    if tuple(A.shape[1:]) != (K, K) or (block_map is None and A.shape[0] != nb):
        raise ValueError(f"A must be ({nb}, {K}, {K}), or (P, {K}, {K}) with a block map, got {tuple(A.shape)}")
    if scales.dim() != 2 or scales.shape[0] != K or col_seg.numel() != D:
        raise ValueError(
            f"slab_dequant_combine needs scales ({K}, n_segs) and col_seg of {D} entries, got "
            f"{tuple(scales.shape)} and {tuple(col_seg.shape)}"
        )
    if block_map is not None and block_map.numel() != nb:
        raise ValueError(f"block_map needs {nb} entries, got {tuple(block_map.shape)}")
    maps = {"col_seg": col_seg} if block_map is None else {"col_seg": col_seg, "block_map": block_map}
    for key, t in dict(A=A, scales=scales, **maps).items():
        if t.device != q_slab.device:
            raise ValueError(f"slab_dequant_combine: {key} on {t.device}, q_slab on {q_slab.device}")
    _check_ids(col_seg, scales.shape[1], "col_seg holds segments", "scales has")
    if block_map is not None:
        _check_ids(block_map, A.shape[0], "block_map holds matrices", "A has")
    if q_slab.device.type == "cpu":
        return slab_dequant_combine_ref(A, scales, col_seg, q_slab, block_map)
    if q_slab.device.type != "cuda":
        raise ValueError(f"slab_dequant_combine runs on CPU or CUDA tensors, got {q_slab.device}")
    dtypes = (A.dtype, scales.dtype, q_slab.dtype, *(t.dtype for t in maps.values()))
    if dtypes != (torch.float32, torch.float32, torch.int8) + (torch.int32,) * len(maps):
        raise TypeError(
            "the slab_dequant_combine kernel takes f32 A and scales, int8 q and int32 col_seg and block_map, "
            f"got {dtypes}"
        )
    if not all(t.is_contiguous() for t in (A, scales, q_slab, *maps.values())):
        raise ValueError("the slab_dequant_combine kernel needs contiguous operands")
    layer_chunks.check_aligned("slab_dequant_combine", q_slab=q_slab, col_seg=col_seg)
    if not 1 <= K <= MAX_AGENTS:
        raise ValueError(f"the slab_dequant_combine kernel takes 1..{MAX_AGENTS} agents, got K={K}")
    fn = _kernel("slab_dequant_combine_f32")
    out = torch.empty((K, D), dtype=torch.float32, device=q_slab.device)
    with torch.cuda.device(q_slab.device):
        stream = torch.cuda.current_stream(q_slab.device).cuda_stream
        err = fn(A.data_ptr(), None if block_map is None else block_map.data_ptr(), scales.data_ptr(),
                 col_seg.data_ptr(), q_slab.data_ptr(), out.data_ptr(), K, scales.shape[1], nb, stream)
    if err != 0:
        raise RuntimeError(f"slab_dequant_combine kernel launch failed: CUDA error {err}")
    bump(slab_dequant_combine)
    return out


slab_dequant_combine.launches = 0


def slab_source_combine_ref(w_blocks: torch.Tensor, srcs) -> torch.Tensor:
    """Plain PyTorch version of :func:`slab_source_combine` (either form of
    ``srcs``): the kernel's ordered loop over the sources, one rounded
    product and one rounded sum per source."""
    nb = w_blocks.shape[0]
    w = w_blocks.float()
    out = torch.zeros(nb, LANES, dtype=torch.float32, device=w_blocks.device)
    for n in range(len(srcs)):
        out = out + w[:, n, None] * srcs[n].float().reshape(nb, LANES)
    return out.view(nb * LANES)


def _source_rows(srcs) -> list:
    """The N sources as a list of rows, from either form."""
    if torch.is_tensor(srcs):
        if srcs.dim() != 2:
            raise ValueError(f"slab_source_combine needs srcs (N, D), got {tuple(srcs.shape)}")
        return list(srcs.unbind(0))
    rows = list(srcs)
    if not all(torch.is_tensor(t) and t.dim() == 1 for t in rows):
        raise ValueError("slab_source_combine needs a sequence of (D,) tensors")
    return rows


def slab_source_combine(w_blocks: torch.Tensor, srcs) -> torch.Tensor:
    """Per-layer weighted combine over N source slabs in ONE kernel launch
    (CUDA tensors) or through :func:`slab_source_combine_ref` (CPU
    tensors).  ``srcs``: a stacked (N, D) tensor, or a sequence of N (D,)
    tensors read where they lie.  Returns a new (D,) f32 tensor."""
    rows = _source_rows(srcs)
    if w_blocks.dim() != 2:
        raise ValueError(f"slab_source_combine needs w_blocks (nb, N), got {tuple(w_blocks.shape)}")
    N, nb = len(rows), w_blocks.shape[0]
    D = nb * LANES
    if w_blocks.shape[1] != N:
        raise ValueError(f"w_blocks must be ({nb}, {N}), got {tuple(w_blocks.shape)}")
    for n, t in enumerate(rows):
        if t.shape[0] != D:
            raise ValueError(f"source {n} has {t.shape[0]} columns, not {nb} blocks x {LANES} lanes")
        if t.device != w_blocks.device:
            raise ValueError(f"source {n} on {t.device}, w_blocks on {w_blocks.device}")
    device = w_blocks.device
    if device.type == "cpu":
        return slab_source_combine_ref(w_blocks, rows)
    if device.type != "cuda":
        raise ValueError(f"slab_source_combine runs on CPU or CUDA tensors, got {device}")
    if w_blocks.dtype != torch.float32 or any(t.dtype != torch.float32 for t in rows):
        raise TypeError(
            f"the slab_source_combine kernel takes float32 operands, got w_blocks {w_blocks.dtype} and "
            f"sources {sorted({str(t.dtype) for t in rows})}"
        )
    if not (w_blocks.is_contiguous() and all(t.is_contiguous() for t in rows)):
        raise ValueError("the slab_source_combine kernel needs contiguous operands")
    layer_chunks.check_aligned("slab_source_combine", **{f"source {n}": t for n, t in enumerate(rows)})
    if not 1 <= N <= MAX_SOURCES:
        raise ValueError(f"the slab_source_combine kernel takes 1..{MAX_SOURCES} sources, got N={N}")
    fn = _kernel("slab_source_combine_f32")
    out = torch.empty(D, dtype=torch.float32, device=device)
    ptrs = (ctypes.c_void_p * N)(*(t.data_ptr() for t in rows))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(w_blocks.data_ptr(), ptrs, out.data_ptr(), N, nb, stream)
    if err != 0:
        raise RuntimeError(f"slab_source_combine kernel launch failed: CUDA error {err}")
    bump(slab_source_combine)
    return out


slab_source_combine.launches = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_WORDS = ctypes.POINTER(ctypes.c_int64)  # packed tensor-map words (kernels/tma.py)
_SIGNATURES = {  # pointers, ints, then the stream
    "slab_combine_f32": [_P, _P, _P, _I, _I, _WORDS, _WORDS, _WORDS, _P],
    "slab_source_combine_f32": [_P, ctypes.POINTER(ctypes.c_void_p), _P, _I, _I, _P],
    "slab_dequant_combine_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def _kernel(name: str = "slab_combine_f32"):
    """One C entry point of the slab_combine library, its signature set."""
    from repro_torch.kernels import build

    fn = getattr(build.load("slab_combine"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn
