"""The coded consensus round on the packed slab: wire view, Gram, mixing,
combine; and the int8 encode.

``slab_encode_combine(block_layer, slab, wire_operands, mix, mode=...,
algorithm=...)`` runs ONE coded round of the gather engine on the (K, D)
f32 slab (``D = n_blocks * 128``; ``block_layer`` maps each 128-column block
to its DRT layer):

* the wire view ``dec`` of every agent's slab, by ``mode``:
  ``int8`` -- ``q * s`` with ``q = clip(floor(x / s + u), -qmax, qmax)``,
  ``s`` the column's segment scale and ``u`` the counter-hash uniform of
  (the agent's leaf key words, the column's reference element index);
  ``bf16`` / ``f16`` -- the f32 round trip of the cast; ``sent`` -- a given
  f32 wire (top-k's sent values);
* ``algorithm="drt"``: the per-layer Gram of ``dec`` and DRT eqs. 12-14 on
  it (``mix`` is the support matrix C); ``"classical"``: ``mix`` is the
  Metropolis matrix for every layer;
* ``out[k] = sum_{l != k} A[layer, l, k] dec[l] + A[layer, k, k] x[k]``:
  the neighbours' wire views and the agent's own full-precision iterate.

It returns ``(out, A)``, or with ``return_gram=True`` ``(out, A, G)``:
a DRT round's per-layer Gram ``G (L, K, K)`` of the wire view, which its
stats launch writes to device memory anyway (telemetry's distances; no
extra launch), ``None`` for a classical round.  ``slab_quant_encode(scales,
col_seg, col_leaf, col_idx, w0, w1, slab)`` returns the (K, D) int8 wire
``q`` alone.

They replace the Pallas TPU kernels ``repro/kernels/slab_codec.py``
``slab_encode_combine`` and ``slab_quant_encode``.  On CUDA tensors the
wrappers launch the hand-written Hopper kernels of ``csrc/slab_codec.cu``
(shared wire view in ``csrc/wire_view.cuh``), or raise; on CPU tensors they
run the plain PyTorch versions :func:`slab_encode_combine_ref` and
:func:`slab_quant_encode_ref`.  There is no fallback from one to the other.

Launches per call (:data:`LAUNCHES_PER_CALL`, asserted by the wrappers'
counters): a DRT round is two kernel launches, a classical round one,
whatever the mode.  Launch 1 (stats) sums each layer's Gram over chunks of
its columns (the plan of :mod:`repro_torch.kernels.layer_chunks`), the
layer's last block adds the chunks' partials in order, and the block that
finishes the last layer runs eqs. 12-14 for every layer; launch 2 combines.
The int8 wire is hashed in-kernel, once a round: a DRT round's launch 1
stores it as a (K, D) int8 buffer that launch 2 reads back (the same bits as
hashing again, and faster: PERF.md); a classical round's one launch hashes
it.  Launch 1 streams the slab (the sent wire
for ``sent``) and the int8 column maps with 16-byte copies: their data must
start 16-byte aligned, or the wrapper raises ``ValueError`` (it never
copies).  ``slab_quant_encode`` (one launch, four columns a thread) runs
the same int8 arithmetic and writes the int8 wire out; the permute engine
and the edge path launch it for their ranks' and rounds' wires.  It reads
the slab and the column maps in 16-byte pieces, so they too must start
16-byte aligned.

Key words and column maps travel as int32 tensors holding uint32 bit
patterns (``repro_torch.comm.prng.words_to_tensor``), which the kernels
read as ``uint32_t``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.comm import rng
from repro_torch.core import drt as drt_mod
from repro_torch.kernels import layer_chunks
from repro_torch.kernels.counters import bump

LANES = 128  # column-block width; SlabLayout pads every layer segment to it
MAX_AGENTS = 64  # largest K the kernels take (their shared-memory budget)
MODES = ("int8", "bf16", "f16", "sent")
LAUNCHES_PER_CALL = {"drt": 2, "classical": 1}

_CAST = {"bf16": torch.bfloat16, "f16": torch.float16}
_KERNEL_MODE = {"int8": 0, "bf16": 1, "f16": 2, "sent": 3, "int8q": 4}  # wire_view.cuh Mode
_N_WIRE = {"int8": 6, "bf16": 0, "f16": 0, "sent": 1}


# -- plain PyTorch versions ----------------------------------------------------


def int8_quant_ref(scales, col_seg, col_leaf, col_idx, w0, w1, slab, qmax=127.0):
    """The int8 wire values ``q`` (in f32) and per-element scales of a
    (K, D) slab: gathers of the per-column maps, the counter hash, then
    ``clip(floor(x / s + u), -qmax, qmax)``."""
    K, D = slab.shape
    seg = col_seg.long().expand(K, D)
    leaf = col_leaf.long().expand(K, D)
    s = torch.gather(scales.float(), 1, seg)
    u = rng.uniform_from_words(
        torch.gather(w0.long(), 1, leaf), torch.gather(w1.long(), 1, leaf), col_idx
    )
    q = torch.clamp(torch.floor(slab.float() / s + u), -qmax, qmax)
    return q, s


def slab_quant_encode_ref(scales, col_seg, col_leaf, col_idx, w0, w1, slab, *, qmax=127.0):
    """Plain PyTorch version of :func:`slab_quant_encode`."""
    q, _ = int8_quant_ref(scales, col_seg, col_leaf, col_idx, w0, w1, slab, qmax)
    return q.to(torch.int8)


def wire_view_ref(mode: str, slab: torch.Tensor, wire_operands: tuple, qmax=127.0):
    """The receiver's f32 view of every agent's slab under ``mode``."""
    x = slab.float()
    if mode == "int8":
        q, s = int8_quant_ref(*wire_operands, x, qmax)
        return q * s
    if mode in _CAST:
        return x.to(_CAST[mode]).float()
    if mode == "sent":
        return wire_operands[0].float()
    raise ValueError(f"unknown wire mode {mode!r}")


def drt_from_gram(G, C, kappa, N_clip, weight_mode="paper"):
    """DRT eqs. 12-14 on per-layer Gram matrices (L, K, K) -> A (L, K, K)."""
    n2 = torch.diagonal(G, dim1=1, dim2=2)
    d2 = torch.clamp(n2[:, :, None] + n2[:, None, :] - 2.0 * G, min=0.0)
    C = C.float()
    log_a = drt_mod.drt_log_unnormalized(d2, n2, C, kappa, weight_mode)
    return drt_mod.drt_normalize(drt_mod.drt_clip_and_self(log_a, C, N_clip), C)


def slab_encode_combine_ref(
    block_layer, slab, wire_operands, mix, *, mode, algorithm="drt", num_layers,
    kappa=1e-6, N_clip=32.0, weight_mode="paper", qmax=127.0, return_gram=False,
):
    """Plain PyTorch version of :func:`slab_encode_combine`: per-block
    batched matmuls for the Gram partials and the combine."""
    K, D = slab.shape
    nb = D // LANES
    x = slab.float().view(K, nb, LANES).transpose(0, 1)  # (nb, K, 128)
    dec = wire_view_ref(mode, slab, wire_operands, qmax).view(K, nb, LANES).transpose(0, 1)
    bl = block_layer.long()
    G = None
    if algorithm == "drt":
        partial = torch.bmm(dec, dec.transpose(1, 2))  # (nb, K, K)
        G = torch.zeros(num_layers, K, K, dtype=torch.float32, device=slab.device)
        G.index_add_(0, bl, partial)
        A = drt_from_gram(G, mix, kappa, N_clip, weight_mode)
    else:
        A = mix.float().expand(num_layers, K, K)
    A_b = A[bl]  # (nb, K, K)
    eye = torch.eye(K, dtype=torch.float32, device=slab.device)
    off = torch.bmm((A_b * (1.0 - eye)).transpose(1, 2), dec)
    out = off + torch.diagonal(A_b, dim1=1, dim2=2)[:, :, None] * x
    out = out.transpose(0, 1).reshape(K, D)
    return (out, A, G) if return_gram else (out, A)


# -- checks ---------------------------------------------------------------------


def _check_int8_operands(scales, col_seg, col_leaf, col_idx, w0, w1, slab):
    K, D = slab.shape
    if scales.dim() != 2 or scales.shape[0] != K:
        raise ValueError(f"scales must be ({K}, n_segs), got {tuple(scales.shape)}")
    for name, m in (("col_seg", col_seg), ("col_leaf", col_leaf), ("col_idx", col_idx)):
        if tuple(m.shape) != (D,):
            raise ValueError(f"{name} must be ({D},), got {tuple(m.shape)}")
    for name, w in (("w0", w0), ("w1", w1)):
        if w.dim() != 2 or w.shape[0] != K or w.shape != w0.shape:
            raise ValueError(f"{name} must be ({K}, n_leaves), got {tuple(w.shape)}")


def _check_slab(slab, n_blocks: "int | None" = None):
    """A (K, D) slab of whole 128-column blocks (``n_blocks`` of them if
    given)."""
    if slab.dim() != 2:
        raise ValueError(f"slab must be (K, D), got {tuple(slab.shape)}")
    nb = slab.shape[1] // LANES if n_blocks is None else n_blocks
    if nb * LANES != slab.shape[1]:
        raise ValueError(f"slab width {slab.shape[1]} != {nb} blocks x {LANES} lanes")


def _check_card(name: str, slab: torch.Tensor, tensors: dict, dtypes: dict):
    """What the CUDA kernels take: one device, the stated dtypes,
    contiguous operands, 1..MAX_AGENTS agents."""
    if slab.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {slab.device}")
    for key, t in tensors.items():
        if t.device != slab.device:
            raise ValueError(f"{name}: {key} on {t.device}, slab on {slab.device}")
        if t.dtype != dtypes[key]:
            raise TypeError(f"the {name} kernel takes {key} as {dtypes[key]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the {name} kernel needs contiguous operands ({key} is not)")
    K = slab.shape[0]
    if not 1 <= K <= MAX_AGENTS:
        raise ValueError(f"the {name} kernel takes 1..{MAX_AGENTS} agents, got K={K}")


_I32, _F32 = torch.int32, torch.float32
_INT8_KEYS = ("scales", "col_seg", "col_leaf", "col_idx", "w0", "w1")
_INT8_DTYPES = dict(zip(_INT8_KEYS, (_F32, _I32, _I32, _I32, _I32, _I32)))


# -- wrappers -------------------------------------------------------------------


def slab_quant_encode(scales, col_seg, col_leaf, col_idx, w0, w1, slab, *, qmax=127.0):
    """The int8 stochastic-rounding encode of a (K, D) f32 slab in ONE
    kernel launch (CUDA tensors) or through :func:`slab_quant_encode_ref`
    (CPU tensors).  ``scales`` (K, n_segs) f32 (``slab_quant_scales``);
    ``col_seg`` / ``col_leaf`` / ``col_idx`` (D,) int32 (the layout's
    column maps); ``w0`` / ``w1`` (K, n_leaves) int32 bit patterns of the
    leaf key words.  Returns the (K, D) int8 wire."""
    _check_slab(slab)
    K, D = slab.shape
    _check_int8_operands(scales, col_seg, col_leaf, col_idx, w0, w1, slab)
    if slab.device.type == "cpu":
        return slab_quant_encode_ref(scales, col_seg, col_leaf, col_idx, w0, w1, slab, qmax=qmax)
    ops = dict(slab=slab, scales=scales, col_seg=col_seg, col_leaf=col_leaf,
               col_idx=col_idx, w0=w0, w1=w1)
    _check_card("slab_quant_encode", slab, ops, dict(_INT8_DTYPES, slab=_F32))
    layer_chunks.check_aligned("slab_quant_encode", slab=slab, col_seg=col_seg, col_leaf=col_leaf, col_idx=col_idx)
    lib = _lib()
    q = torch.empty(K, D, dtype=torch.int8, device=slab.device)
    with torch.cuda.device(slab.device):
        err = lib.slab_quant_encode_i8(
            slab.data_ptr(), scales.data_ptr(), col_seg.data_ptr(), col_leaf.data_ptr(),
            col_idx.data_ptr(), w0.data_ptr(), w1.data_ptr(), scales.shape[1], w0.shape[1],
            float(qmax), q.data_ptr(), K, D // LANES, _stream(slab),
        )
    _raise_on(err, "slab_quant_encode")
    bump(slab_quant_encode)
    return q


slab_quant_encode.launches = 0


def slab_encode_combine(
    block_layer, slab, wire_operands, mix, *, mode, algorithm="drt", num_layers,
    kappa=1e-6, N_clip=32.0, weight_mode="paper", qmax=127.0, return_gram=False,
):
    """ONE coded consensus round (see the module docstring): kernel
    launches on CUDA tensors (``LAUNCHES_PER_CALL[algorithm]`` of them), the
    plain version on CPU tensors.  ``wire_operands``: ``(scales, col_seg, col_leaf, col_idx,
    w0, w1)`` for ``int8``, ``()`` for ``bf16`` / ``f16``, ``(sent,)`` for
    ``sent``.  ``mix``: C (K, K) for DRT, the Metropolis matrix for
    classical.  Returns ``(out (K, D) f32, A (L, K, K) f32)``, and with
    ``return_gram`` the wire view's per-layer Gram ``G (L, K, K)`` f32 (DRT;
    ``None`` for classical) after them."""
    if mode not in MODES:
        raise ValueError(f"unknown wire mode {mode!r}; modes: {MODES}")
    if algorithm not in LAUNCHES_PER_CALL:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if weight_mode not in ("paper", "exact_grad"):
        raise ValueError(f"unknown weight_mode {weight_mode!r}")
    if len(wire_operands) != _N_WIRE[mode]:
        raise ValueError(f"mode {mode!r} takes {_N_WIRE[mode]} wire operands, got {len(wire_operands)}")
    if block_layer.dim() != 1:
        raise ValueError(f"block_layer must be (n_blocks,), got {tuple(block_layer.shape)}")
    nb = block_layer.shape[0]
    _check_slab(slab, nb)
    K, D = slab.shape
    if tuple(mix.shape) != (K, K):
        raise ValueError(f"mix must be ({K}, {K}), got {tuple(mix.shape)}")
    if mode == "int8":
        _check_int8_operands(*wire_operands, slab)
    if mode == "sent" and tuple(wire_operands[0].shape) != (K, D):
        raise ValueError(f"the sent wire must be ({K}, {D}), got {tuple(wire_operands[0].shape)}")
    kw = dict(mode=mode, algorithm=algorithm, num_layers=num_layers, kappa=kappa,
              N_clip=N_clip, weight_mode=weight_mode, qmax=qmax, return_gram=return_gram)
    if slab.device.type == "cpu":
        return slab_encode_combine_ref(block_layer, slab, wire_operands, mix, **kw)

    ops = dict(slab=slab, block_layer=block_layer, mix=mix)
    dtypes = dict(slab=_F32, block_layer=_I32, mix=_F32, sent=_F32, **_INT8_DTYPES)
    if mode == "int8":
        ops.update(zip(_INT8_KEYS, wire_operands))
    elif mode == "sent":
        ops["sent"] = wire_operands[0]
    _check_card("slab_encode_combine", slab, ops, dtypes)

    lib = _lib()
    stream = _stream(slab)
    # the wire arguments of the C entry points (wire_view.cuh Wire); null
    # where the mode does not read them
    n_segs, n_leaves = 0, 0
    ptrs = dict.fromkeys((*_INT8_KEYS, "sent", "q"))
    ptrs.update((k, t.data_ptr()) for k, t in ops.items() if k in ptrs)
    if mode == "int8":
        n_segs, n_leaves = ops["scales"].shape[1], ops["w0"].shape[1]
    tail = (n_segs, n_leaves, float(qmax))
    out = torch.empty_like(slab)
    G = None
    with torch.cuda.device(slab.device):
        if algorithm == "classical":
            A = mix.expand(num_layers, K, K)
            _raise_on(lib.sec_combine(_KERNEL_MODE[mode], slab.data_ptr(), *ptrs.values(), *tail,
                                      mix.data_ptr(), None, out.data_ptr(), K, nb, stream),
                      "slab_encode_combine (combine)")
            bump(slab_encode_combine)
        else:
            streamed = {"sent": ops.get("sent")} if mode == "sent" else {"slab": slab}
            if mode == "int8":
                streamed.update((k, ops[k]) for k in ("col_seg", "col_leaf", "col_idx"))
            layer_chunks.check_aligned("slab_encode_combine", **streamed)
            plan = layer_chunks.chunk_plan(block_layer, num_layers)
            tickets = layer_chunks.tickets(slab.device, stream, num_layers + 1)
            partial = torch.empty(plan.n_chunks, K * (K + 1) // 2, dtype=_F32, device=slab.device)
            G = torch.empty(num_layers, K, K, dtype=_F32, device=slab.device)
            A = torch.empty(num_layers, K, K, dtype=_F32, device=slab.device)
            q = torch.empty(K, D, dtype=torch.int8, device=slab.device) if mode == "int8" else None
            _raise_on(lib.sec_stats(
                _KERNEL_MODE[mode], slab.data_ptr(), *ptrs.values(), *tail, plan.chunks.data_ptr(),
                plan.layers.data_ptr(), plan.n_chunks, plan.n_busy, partial.data_ptr(), G.data_ptr(),
                tickets.data_ptr(), None if q is None else q.data_ptr(), mix.data_ptr(), A.data_ptr(),
                K, num_layers, float(kappa), math.log(float(N_clip)), (num_layers + 1) * math.log(2.0),
                int(weight_mode == "exact_grad"), nb, stream,
            ), "slab_encode_combine (stats)")
            bump(slab_encode_combine)
            if q is not None:
                ptrs["q"] = q.data_ptr()
            _raise_on(lib.sec_combine(_KERNEL_MODE["int8q" if q is not None else mode], slab.data_ptr(),
                                      *ptrs.values(), *tail, A.data_ptr(), block_layer.data_ptr(),
                                      out.data_ptr(), K, nb, stream),
                      "slab_encode_combine (combine)")
            bump(slab_encode_combine)
            if return_gram:
                G = layer_chunks.zero_idle_layers(G, plan)
    bump(slab_encode_combine, "calls")
    return (out, A, G) if return_gram else (out, A)


slab_encode_combine.launches = 0
slab_encode_combine.calls = 0


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_WIRE_ARGS = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F]  # mode, slab, scales .. sent, q, n_segs, n_leaves, qmax
_SIGNATURES = {
    "slab_quant_encode_i8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _I, _I, _P],
    "sec_stats": _WIRE_ARGS + [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _I, _I, _P],
    "sec_combine": _WIRE_ARGS + [_P, _P, _P, _I, _I, _P],
}


_typed_lib = None


def _lib():
    """The built library with every entry point's C signature set."""
    global _typed_lib
    if _typed_lib is None:
        from repro_torch.kernels import build

        lib = build.load("slab_codec")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _typed_lib = lib
    return _typed_lib
