"""The sparse (edge-list) consensus round on the packed slab.

``slab_edge_encode_combine(block_layer, self_slab, wire_operands, src, dst,
w, nbr, pos, valid, dst_base, mode=..., algorithm=...)`` runs ONE round of
``path="edge"`` reading the compact wire of all K agents:

* the decoded view ``dec`` of the wire, by ``mode``: ``exact`` / ``sent``
  -- an f32 slab as it is; ``bf16`` / ``f16`` -- the upcast cast wire;
  ``int8`` -- ``q * scales[agent, col_seg[c]]`` (one rounded multiply, as
  ``consensus.slab_decode``);
* ``algorithm="drt"``: per-layer squared norms ``n2 (L, K)`` and per-edge
  distances ``d2e (L, E)`` of ``dec``, then the edge factorization of eqs.
  12-14 (``core.drt.drt_edge_mixing``); ``"classical"``: the Metropolis
  edge weights (``core.dynamic.metropolis_edge_weights``);
* the gather-only CSR combine of the local destinations ``k = 0 ..
  K_local - 1`` (global agent ``dst_base + k``), slot by slot:
  ``out[k] = A_self[p, dst_base + k] self[k] + sum_j valid[k, j]
  A_e[p, pos[k, j]] dec[nbr[k, j]]``.

``slab_edge_combine(block_layer, self_slab, dec_slab, src, dst, w, ...)``
is the same round over an already decoded f32 slab without CSR tables: the
scatter combine ``out[k] = A_self[p, k] self[k] + sum_{e: dst[e] = k}
A_e[p, e] dec[src[e]]``, in edge-list order.

Both return ``(out, A_self (L, K), A_e (L, E))``.  Two options sit
between the factors and the combine, and neither adds a launch:
``reweight`` (a function of ``(A_self, A_e)`` returning new factors: the
trust reweighting ``faults.reweight_edge``) runs in torch between launch 1
and launch 2, so the combine applies the reweighted factors, which the
call returns; ``return_d2e=True`` appends a DRT round's per-edge distances
``d2e (L, E)``, which launch 1 writes to device memory anyway (telemetry;
``None`` for a classical round).  They replace the Pallas
TPU kernels ``repro/kernels/slab_segment.py`` ``slab_edge_encode_combine``
and ``slab_edge_combine``.  On CUDA tensors the wrappers launch the
hand-written Hopper kernels of ``csrc/slab_segment.cu`` or raise; on CPU
tensors they run the plain PyTorch versions
:func:`slab_edge_encode_combine_ref` and :func:`slab_edge_combine_ref`.
There is no fallback from one to the other.

Launches per call (:data:`LAUNCHES_PER_CALL`, asserted by the wrappers'
counters): a DRT round is two kernel launches, a classical round two, for
either kernel and every mode.  The TPU kernel is one launch because its grid
runs in order and carries the stats in VMEM.  Here launch 1 of a DRT round
sums each layer's stats over chunks of its columns (the plan of
:mod:`repro_torch.kernels.layer_chunks`), the layer's last block adds the
chunks' partials in order, and the block that finishes the last layer
computes every layer's edge factors: a split reduction with a fixed order
(no float atomics: two runs give the same bits); it streams the wire (and
the int8 column map) with 16-byte copies, so their data must start 16-byte
aligned, or the wrapper raises ``ValueError`` (it never copies).  A
classical round's launch 1 computes the Metropolis factors.  Launch 2 is the
combine.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from repro_torch.core.drt import DRTConfig, drt_edge_mixing, edge_log_constants
from repro_torch.core.dynamic import metropolis_edge_weights
from repro_torch.kernels import layer_chunks
from repro_torch.kernels.counters import bump

LANES = 128  # column-block width; SlabLayout pads every layer segment to it
MAX_AGENTS = 64  # largest K the kernels take (their shared-memory budget)
MAX_EDGES = MAX_AGENTS * MAX_AGENTS  # a full graph at K = 64, with room for padding
MODES = ("exact", "int8", "bf16", "f16", "sent")
LAUNCHES_PER_CALL = {"drt": 2, "classical": 2}

_WIRE_DTYPE = {"exact": torch.float32, "sent": torch.float32, "bf16": torch.bfloat16,
               "f16": torch.float16, "int8": torch.int8}
_KERNEL_MODE = {"exact": 0, "sent": 0, "int8": 1, "bf16": 2, "f16": 3}  # slab_segment.cu WireMode
_I32, _F32 = torch.int32, torch.float32


# -- plain PyTorch versions ----------------------------------------------------


def decode_wire_ref(mode: str, wire_operands: tuple) -> torch.Tensor:
    """The (K, D) f32 view of a compact wire."""
    if mode == "int8":
        q, scales, col_seg = wire_operands
        return q.float() * scales.float()[:, col_seg.long()]
    return wire_operands[0].float()


def edge_factors_ref(block_layer, dec, src, dst, w, *, algorithm, num_layers,
                     kappa, N_clip, weight_mode):
    """``(A_self (L, K), A_e (L, E), d2e (L, E) or None)`` of one round from
    the decoded view (``d2e``: DRT's per-edge distances)."""
    K = dec.shape[0]
    if algorithm == "classical":
        m_self, m_e = metropolis_edge_weights(src, dst, w, K)
        return m_self.expand(num_layers, K), m_e.expand(num_layers, src.shape[0]), None
    n2 = packing.layer_sq_norms(dec, block_layer, num_layers)
    d2e = packing.edge_sq_dists(dec, src, dst, block_layer, num_layers)
    cfg = DRTConfig(N=N_clip, kappa=kappa, weight_mode=weight_mode)
    return (*drt_edge_mixing(d2e, n2, src, dst, w, cfg, K), d2e)


def _finish_ref(combine, A_self, A_e, d2e, reweight, return_d2e):
    """The plain versions' tail: the reweighting, the combine over the
    final factors, the return."""
    if reweight is not None:
        A_self, A_e = reweight(A_self, A_e)
    out = (combine(A_self, A_e), A_self, A_e)
    return out + (d2e,) if return_d2e else out


def csr_combine_ref(block_layer, self_slab, dec, nbr, pos, valid, A_self, A_e, dst_base=0):
    """The CSR combine of :func:`slab_edge_encode_combine` for given
    factors."""
    Kl = self_slab.shape[0]
    a_csr = torch.where(valid.bool()[None], A_e[:, pos.long()], 0.0)  # (L, Kl, Dmax)
    rows = packing.csr_neighbor_rows(dec, nbr)
    return packing.csr_combine(A_self[:, dst_base : dst_base + Kl], a_csr, self_slab, rows, block_layer)


def slab_edge_encode_combine_ref(
    block_layer, self_slab, wire_operands, src, dst, w, nbr, pos, valid, dst_base=0, *,
    mode, algorithm="drt", num_layers, kappa=1e-6, N_clip=32.0, weight_mode="paper",
    reweight=None, return_d2e=False,
):
    """Plain PyTorch version of :func:`slab_edge_encode_combine`."""
    dec = decode_wire_ref(mode, wire_operands)
    factors = edge_factors_ref(
        block_layer, dec, src, dst, w, algorithm=algorithm, num_layers=num_layers,
        kappa=kappa, N_clip=N_clip, weight_mode=weight_mode,
    )
    return _finish_ref(
        lambda a_self, a_e: csr_combine_ref(block_layer, self_slab, dec, nbr, pos, valid, a_self, a_e, dst_base),
        *factors, reweight, return_d2e,
    )


def slab_edge_combine_ref(
    block_layer, self_slab, dec_slab, src, dst, w, *, algorithm="drt", num_layers,
    kappa=1e-6, N_clip=32.0, weight_mode="paper", reweight=None, return_d2e=False,
):
    """Plain PyTorch version of :func:`slab_edge_combine`."""
    factors = edge_factors_ref(
        block_layer, dec_slab, src, dst, w, algorithm=algorithm, num_layers=num_layers,
        kappa=kappa, N_clip=N_clip, weight_mode=weight_mode,
    )
    return _finish_ref(
        lambda a_self, a_e: packing.edge_combine(a_self, a_e, src, dst, self_slab, dec_slab, block_layer),
        *factors, reweight, return_d2e,
    )


# -- checks ---------------------------------------------------------------------


def _check_round(block_layer, self_slab, K, src, dst, w, algorithm, weight_mode):
    if algorithm not in LAUNCHES_PER_CALL:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if weight_mode not in ("paper", "exact_grad"):
        raise ValueError(f"unknown weight_mode {weight_mode!r}")
    if block_layer.dim() != 1:
        raise ValueError(f"block_layer must be (n_blocks,), got {tuple(block_layer.shape)}")
    nb = block_layer.shape[0]
    if self_slab.dim() != 2 or self_slab.shape[1] != nb * LANES:
        raise ValueError(
            f"self slab must be (K_local, {nb} blocks x {LANES} lanes), got {tuple(self_slab.shape)}"
        )
    if src.dim() != 1 or src.shape != dst.shape or src.shape != w.shape:
        raise ValueError(
            f"src/dst/w must be one (E,) edge list, got {tuple(src.shape)}, "
            f"{tuple(dst.shape)}, {tuple(w.shape)}"
        )
    if not 1 <= K <= MAX_AGENTS or not 1 <= src.shape[0] <= MAX_EDGES:
        raise ValueError(
            f"the edge kernels take 1..{MAX_AGENTS} agents and 1..{MAX_EDGES} edges, "
            f"got K={K}, E={src.shape[0]}"
        )


def _check_card(name: str, ref: torch.Tensor, tensors: dict, dtypes: dict):
    """What the CUDA kernels take: one CUDA device, the stated dtypes,
    contiguous operands."""
    if ref.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {ref.device}")
    for key, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name}: {key} on {t.device}, self slab on {ref.device}")
        if t.dtype != dtypes[key]:
            raise TypeError(f"the {name} kernel takes {key} as {dtypes[key]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the {name} kernel needs contiguous operands ({key} is not)")


def _kernel_scalars(num_layers, kappa, N_clip, weight_mode):
    """kappa, log N, (L + 1) log 2 (f32, as ``drt_edge_mixing`` rounds
    them) and the weight-mode flag."""
    log_n, log_2_l1 = edge_log_constants(num_layers, N_clip)
    return float(kappa), log_n, log_2_l1, int(weight_mode == "exact_grad")


# -- wrappers -------------------------------------------------------------------


def slab_edge_encode_combine(
    block_layer, self_slab, wire_operands, src, dst, w, nbr, pos, valid, dst_base: int = 0, *,
    mode, algorithm="drt", num_layers, kappa=1e-6, N_clip=32.0, weight_mode="paper",
    reweight=None, return_d2e=False,
):
    """ONE wire-resident sparse round (module docstring): kernel launches
    on CUDA tensors (``LAUNCHES_PER_CALL[algorithm]`` of them), the plain
    version on CPU tensors.

    ``block_layer`` (n_blocks,) int32; ``self_slab`` (K_local, D) f32, the
    local destinations' own iterates; ``wire_operands`` the wire of ALL K
    agents: ``(q (K, D) int8, scales (K, n_segs) f32, col_seg (D,) int32)``
    for ``int8``, ``(wire (K, D),)`` f32 for ``exact`` / ``sent``, bf16 /
    f16 for the casts; ``src`` / ``dst`` (E,) int32, ``w`` (E,) f32;
    ``nbr`` / ``pos`` (K_local, Dmax) int32 and ``valid`` (K_local, Dmax)
    bool or int32 (``core.dynamic.csr_from_edges`` rows ``dst_base ..
    dst_base + K_local - 1``).  Returns ``(out (K_local, D) f32, A_self (L,
    K), A_e (L, E))``, then ``d2e`` with ``return_d2e``; ``reweight`` as in
    the module docstring."""
    if mode not in MODES:
        raise ValueError(f"unknown wire mode {mode!r}; modes: {MODES}")
    n_ops = 3 if mode == "int8" else 1
    if len(wire_operands) != n_ops:
        raise ValueError(f"mode {mode!r} takes {n_ops} wire operands, got {len(wire_operands)}")
    wire = wire_operands[0]
    K = wire.shape[0]
    _check_round(block_layer, self_slab, K, src, dst, w, algorithm, weight_mode)
    Kl, D = self_slab.shape
    if tuple(wire.shape) != (K, D):
        raise ValueError(f"the wire must be (K, {D}), got {tuple(wire.shape)}")
    if mode == "int8":
        scales, col_seg = wire_operands[1:]
        if scales.dim() != 2 or scales.shape[0] != K or tuple(col_seg.shape) != (D,):
            raise ValueError(
                f"int8 needs scales ({K}, n_segs) and col_seg ({D},), got "
                f"{tuple(scales.shape)} and {tuple(col_seg.shape)}"
            )
    if nbr.dim() != 2 or nbr.shape[0] != Kl or nbr.shape != pos.shape or nbr.shape != valid.shape:
        raise ValueError(
            f"nbr/pos/valid must be ({Kl}, Dmax), got {tuple(nbr.shape)}, "
            f"{tuple(pos.shape)}, {tuple(valid.shape)}"
        )
    dst_base = int(dst_base)
    if not 0 <= dst_base <= K - Kl:
        raise ValueError(f"dst_base {dst_base} + K_local {Kl} exceeds K={K}")
    kw = dict(mode=mode, algorithm=algorithm, num_layers=num_layers, kappa=kappa,
              N_clip=N_clip, weight_mode=weight_mode, reweight=reweight, return_d2e=return_d2e)
    if self_slab.device.type == "cpu":
        return slab_edge_encode_combine_ref(
            block_layer, self_slab, wire_operands, src, dst, w, nbr, pos, valid, dst_base, **kw
        )

    ops = dict(block_layer=block_layer, self_slab=self_slab, wire=wire, src=src, dst=dst, w=w,
               nbr=nbr, pos=pos, valid=valid)
    dtypes = dict(block_layer=_I32, self_slab=_F32, wire=_WIRE_DTYPE[mode],
                  src=_I32, dst=_I32, w=_F32, nbr=_I32, pos=_I32,
                  valid=torch.bool if valid.dtype == torch.bool else _I32, scales=_F32, col_seg=_I32)
    scales_p = col_seg_p = None
    n_segs = 0
    if mode == "int8":
        ops.update(scales=wire_operands[1], col_seg=wire_operands[2])
        scales_p, col_seg_p = ops["scales"].data_ptr(), ops["col_seg"].data_ptr()
        n_segs = ops["scales"].shape[1]
    _check_card("slab_edge_encode_combine", self_slab, ops, dtypes)
    lib = _lib()
    valid = valid.to(torch.bool)  # the kernel reads bool bytes (a no-op for a bool table)
    wire_args = (_KERNEL_MODE[mode], wire.data_ptr(), scales_p, col_seg_p, n_segs)
    out = torch.empty_like(self_slab)
    streamed = dict(wire=wire, col_seg=ops["col_seg"]) if mode == "int8" else dict(wire=wire)
    A_self, A_e, d2e = _factors(
        lib, slab_edge_encode_combine, "slab_edge_encode_combine", wire_args, streamed, block_layer,
        src, dst, w, K, D, algorithm=algorithm, num_layers=num_layers, kappa=kappa,
        N_clip=N_clip, weight_mode=weight_mode, reweight=reweight,
    )
    with torch.cuda.device(self_slab.device):
        _raise_on(lib.seg_csr_combine(
            *wire_args, self_slab.data_ptr(), block_layer.data_ptr(), A_self.data_ptr(),
            A_e.data_ptr(), nbr.data_ptr(), pos.data_ptr(), valid.data_ptr(), dst_base,
            out.data_ptr(), K, Kl, src.shape[0], nbr.shape[1], block_layer.shape[0],
            _stream(self_slab),
        ), "slab_edge_encode_combine (csr_combine)")
    bump(slab_edge_encode_combine)
    bump(slab_edge_encode_combine, "calls")
    return (out, A_self, A_e, d2e) if return_d2e else (out, A_self, A_e)


slab_edge_encode_combine.launches = 0
slab_edge_encode_combine.calls = 0


def slab_edge_combine(
    block_layer, self_slab, dec_slab, src, dst, w, *, algorithm="drt", num_layers,
    kappa=1e-6, N_clip=32.0, weight_mode="paper", reweight=None, return_d2e=False,
):
    """ONE sparse round over a decoded (K, D) f32 slab, scatter combine in
    edge-list order (module docstring): kernel launches on CUDA tensors,
    the plain version on CPU tensors.  ``self_slab`` and ``dec_slab`` (K,
    D) f32 (the same tensor on an exact round).  Returns ``(out (K, D),
    A_self (L, K), A_e (L, E))``, then ``d2e`` with ``return_d2e``;
    ``reweight`` as in the module docstring."""
    K = dec_slab.shape[0]
    _check_round(block_layer, self_slab, K, src, dst, w, algorithm, weight_mode)
    if dec_slab.shape != self_slab.shape:
        raise ValueError(
            f"self and decoded slabs differ in shape: {tuple(self_slab.shape)} vs {tuple(dec_slab.shape)}"
        )
    kw = dict(algorithm=algorithm, num_layers=num_layers, kappa=kappa, N_clip=N_clip,
              weight_mode=weight_mode, reweight=reweight)
    if self_slab.device.type == "cpu":
        return slab_edge_combine_ref(block_layer, self_slab, dec_slab, src, dst, w, return_d2e=return_d2e, **kw)

    ops = dict(block_layer=block_layer, self_slab=self_slab, dec_slab=dec_slab, src=src, dst=dst, w=w)
    dtypes = dict(block_layer=_I32, self_slab=_F32, dec_slab=_F32, src=_I32, dst=_I32, w=_F32)
    _check_card("slab_edge_combine", self_slab, ops, dtypes)
    lib = _lib()
    D = self_slab.shape[1]
    wire_args = (_KERNEL_MODE["exact"], dec_slab.data_ptr(), None, None, 0)
    out = torch.empty_like(self_slab)
    A_self, A_e, d2e = _factors(lib, slab_edge_combine, "slab_edge_combine", wire_args, dict(dec_slab=dec_slab),
                                block_layer, src, dst, w, K, D, **kw)
    with torch.cuda.device(self_slab.device):
        _raise_on(lib.seg_scatter_combine(
            self_slab.data_ptr(), dec_slab.data_ptr(), block_layer.data_ptr(), A_self.data_ptr(),
            A_e.data_ptr(), src.data_ptr(), dst.data_ptr(), out.data_ptr(), K, src.shape[0],
            block_layer.shape[0], _stream(self_slab),
        ), "slab_edge_combine (scatter_combine)")
    bump(slab_edge_combine)
    bump(slab_edge_combine, "calls")
    return (out, A_self, A_e, d2e) if return_d2e else (out, A_self, A_e)


slab_edge_combine.launches = 0
slab_edge_combine.calls = 0


def _factors(lib, counter, name, wire_args, streamed, block_layer, src, dst, w, K, D, *, algorithm,
             num_layers, kappa, N_clip, weight_mode, reweight):
    """Launch 1 of a round: for DRT the stats launch (chunk stats, their
    per-layer sums in order, the edge factors) over the ``streamed``
    tensors; for classical the Metropolis factors.  Then ``reweight`` (in
    torch, before the combine launch).  Returns ``(A_self, A_e, d2e)``,
    ``d2e`` the stats' per-edge distances (DRT) or ``None``."""
    dev = block_layer.device
    E, nb = src.shape[0], block_layer.shape[0]
    d2e = None
    A_self = torch.empty(num_layers, K, dtype=_F32, device=dev)
    A_e = torch.empty(num_layers, E, dtype=_F32, device=dev)
    stream = _stream(block_layer)
    with torch.cuda.device(dev):
        if algorithm == "drt":
            layer_chunks.check_aligned(name, **streamed)
            plan = layer_chunks.chunk_plan(block_layer, num_layers)
            tickets = layer_chunks.tickets(dev, stream, num_layers + 1)
            partial = torch.empty(plan.n_chunks, K + E, dtype=_F32, device=dev)
            stats = torch.empty(num_layers, K + E, dtype=_F32, device=dev)
            scratch = torch.empty(num_layers, E, dtype=_F32, device=dev)
            _raise_on(lib.seg_stats(
                *wire_args, src.data_ptr(), dst.data_ptr(), w.data_ptr(), plan.chunks.data_ptr(),
                plan.layers.data_ptr(), plan.n_chunks, plan.n_busy, partial.data_ptr(), stats.data_ptr(),
                tickets.data_ptr(), A_self.data_ptr(), A_e.data_ptr(), scratch.data_ptr(), K, E, num_layers,
                *_kernel_scalars(num_layers, kappa, N_clip, weight_mode), nb, stream,
            ), f"{name} (stats)")
            d2e = layer_chunks.zero_idle_layers(stats[:, K:], plan)  # stats rows: n2 (K), then d2e (E)
        else:
            _raise_on(lib.seg_metropolis(src.data_ptr(), dst.data_ptr(), w.data_ptr(), A_self.data_ptr(),
                                         A_e.data_ptr(), K, E, num_layers, stream),
                      f"{name} (metropolis)")
        bump(counter)
    if reweight is not None:
        A_self, A_e = (a.contiguous() for a in reweight(A_self, A_e))
    return A_self, A_e, d2e


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_WIRE_ARGS = [_I, _P, _P, _P, _I]  # mode, wire, scales, col_seg, n_segs
_SIGNATURES = {
    "seg_stats": _WIRE_ARGS + [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                               _I, _I, _P],
    "seg_metropolis": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "seg_csr_combine": _WIRE_ARGS + [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    "seg_scatter_combine": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}


_typed_lib = None


def _lib():
    """The built library with every entry point's C signature set."""
    global _typed_lib
    if _typed_lib is None:
        from repro_torch.kernels import build

        lib = build.load("slab_segment")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _typed_lib = lib
    return _typed_lib
