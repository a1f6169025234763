"""Causal flash attention (forward): the dense LM prefill's attention.

``flash_attention(q, k, v, causal=True)`` takes q (B, H, Sq, hd) and k, v
(B, Hkv, Skv, hd) with H a multiple of Hkv; query head h attends with
key/value head ``h // (H // Hkv)`` (the reference's GQA expansion repeats
each KV head H/Hkv times in a row, so this equals the Pallas kernel on the
expanded k and v).  It returns (B, H, Sq, hd) in q's dtype: scores of q
scaled by 1/sqrt(hd) in f32, masked with -1e30 where the key lies after the
query or past Skv, online softmax statistics in f32, the sum divided by
max(l, 1e-30).  Any Sq and Skv: the ragged edge is masked by bounds, nothing
is padded.  Only causal attention is ported (the decoder prefill's); the
non-causal form waits for the encoder-decoder slice (ROADMAP.md).

It replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
``flash_attention``.  On CUDA tensors the wrapper launches the hand-written
Hopper kernel ``csrc/flash_attention.cu`` (nvcc, sm_90a, bound with ctypes;
f32 or bf16, hd 32, 64 or 128) or raises; on CPU tensors it runs
:func:`flash_attention_ref`, the plain PyTorch version, which walks the key
tiles with the same online softmax.  There is no fallback from one to the
other.  The kernel reads strided views (unit stride along hd only), so the
model hands it its (B, S, H, hd) projections transposed without a copy, and
it writes its output as a (B, Sq, H, hd) buffer seen as (B, H, Sq, hd).

``flash_attention.launches`` counts kernel launches (one per call; CPU calls
do not count).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.counters import bump

BLOCK_Q = 64  # query rows per block (csrc kBQ)
BLOCK_K = 32  # keys per tile (csrc kBK)
HEAD_DIMS = (32, 64, 128)  # head dims the kernel is built for
MASKED = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes (B, H, S, hd) q and (B, Hkv, S, hd) k, v")
    B, H, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if H % k.shape[1] != 0:
        raise ValueError(f"{H} query heads are not a multiple of {k.shape[1]} KV heads")
    if k.shape[2] < 1 or q.shape[2] < 1:
        raise ValueError("flash_attention needs at least one query and one key")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`: the same causal
    online softmax over key tiles of :data:`BLOCK_K`, in f32."""
    _check(q, k, v)
    B, H, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    n_rep = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    # rows of one KV head's group: n_rep query heads of Sq rows each
    qf = (q.float() * scale).reshape(B, Hkv, n_rep * Sq, hd)
    q_pos = torch.arange(Sq, device=q.device).repeat(n_rep)
    m = torch.full((B, Hkv, n_rep * Sq), MASKED, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, Skv, BLOCK_K):
        kb, vb = k[:, :, k0 : k0 + BLOCK_K].float(), v[:, :, k0 : k0 + BLOCK_K].float()
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        s = torch.where(k_pos[None, :] <= q_pos[:, None], qf @ kb.transpose(-1, -2), MASKED)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ vb
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, H, Sq, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """Attention of q (B, H, Sq, hd) over k, v (B, Hkv, Skv, hd): the kernel
    on CUDA tensors, :func:`flash_attention_ref` on CPU tensors."""
    if not causal:
        raise NotImplementedError("non-causal flash_attention is not ported yet (ROADMAP.md, Queue 1 #12: enc_dec)")
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    B, H, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel is built for head dims {HEAD_DIMS}, got {hd}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the flash_attention kernel needs unit stride along the head dim")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the kernel's grid (65535)")
    fn = _kernel()
    out = torch.empty(B, Sq, H, hd, dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], B, H, Hkv, Sq, Skv,
                 hd, strides, 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    bump(flash_attention)
    return out


flash_attention.launches = 0


def _kernel():
    from repro_torch.kernels import build

    fn = build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn
