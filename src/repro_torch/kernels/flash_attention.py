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
``flash_attention``.  On CUDA tensors the wrapper launches one of two
hand-written Hopper kernels of ``csrc/flash_attention.cu`` (nvcc, sm_90a,
bound with ctypes; hd 32, 64 or 128), chosen by dtype, or raises; on CPU
tensors it runs :func:`flash_attention_ref`, the plain PyTorch version,
which walks the key tiles with the same online softmax.  There is no
fallback from one to another.

* bf16 (the LM's serving path): the tensor-core kernel, ``wgmma`` products
  on tiles that TMA loads (:func:`attention_tensor_maps`).  TMA refuses a
  base address that is not 16-byte aligned and a byte stride that is not a
  multiple of 16 (``kernels/tma.py``): the wrapper raises on such a view and
  never copies it.  It rounds the softmax weights P to bf16 before P V, so it
  stays within ``rtol 2^-7`` plus ``atol 2^-8 max|v|`` of the plain version
  (|delta o| <= 2^-9 sum_j softmax_j |v_j|), not within f32 rounding.
* f32: the CUDA-core kernel, which reads strided views directly and agrees
  with the plain version to f32 rounding (1e-5).

Either kernel reads strided views (unit stride along hd only), so the model
hands it its (B, S, H, hd) projections transposed without a copy, and it
writes its output as a (B, Sq, H, hd) buffer seen as (B, H, Sq, hd).

``flash_attention.launches`` counts kernel launches (one per call, either
kernel; CPU calls do not count); ``flash_attention.tc_launches`` counts the
tensor-core kernel's alone.

Training (:class:`FlashAttention`, the model's route): a
``torch.autograd.Function`` whose forward is :func:`flash_attention` with
``return_lse=True`` (either kernel also writes each row's log-sum-exp of
the scaled scores, (B, H, Sq) f32; serving passes no buffer and its launch
is unchanged) and whose backward is :func:`flash_attention_bwd`: on CUDA
tensors the hand-written kernel of ``csrc/flash_attention_bwd.cu``
(:data:`BWD_LAUNCHES_PER_CALL` launches a call, counted in
``flash_attention_bwd.launches``, calls in ``flash_attention_bwd.calls``),
on CPU tensors :func:`flash_attention_bwd_ref`.  The reference has no
backward kernel: it differentiates its jnp attention with XLA.  The
forward wrapper writes into a fresh buffer that autograd cannot see
through, so on a CUDA input that requires a gradient it raises and names
:class:`FlashAttention` instead of returning an output without one.

The backward kernel computes in f32 and rounds dq, dk and dv once to the
inputs' dtype.  Tolerances against the plain version on the same inputs,
with ``m`` the output's largest magnitude and never under 1 (the
gradients are sums of O(1) terms; dq at S = 1 cancels to 0 on that
scale): f32, ``1e-5 m`` (sums over up to Skv keys in another order);
bf16, ``rtol 2^-7`` (both round an f32 result to bf16, at most one bf16
step apart) plus ``2^-10 m`` (the f32 sums' order, before that rounding,
on entries that cancel to near zero).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import tma
from repro_torch.kernels.counters import bump

BLOCK_K = 32  # keys per tile of the plain version and the f32 kernel (csrc kBK)
TC_BLOCK_Q = 128  # query rows per block of the bf16 tensor-core kernel (csrc kTcBQ)
TC_BLOCK_K = 128  # keys per tile of the bf16 tensor-core kernel (csrc kTcBN)
HEAD_DIMS = (32, 64, 128)  # head dims the kernels are built for
MASKED = -1e30


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, return_lse: bool = False):
    """Plain PyTorch version of :func:`flash_attention`: the same causal
    online softmax over key tiles of :data:`BLOCK_K`, in f32.  With
    ``return_lse`` it returns ``(out, lse)``, ``lse = m + log(l)`` of each
    row's scaled scores, (B, H, Sq) f32."""
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
    out = (acc / torch.clamp_min(l, 1e-30)[..., None]).reshape(B, H, Sq, hd).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(B, H, Sq)
    return out


def _check_cuda(tensors, q):
    """What both kernels' wrappers require of CUDA operands."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the flash_attention kernels take float32 or bfloat16, got {q.dtype}")
    B, H, _, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernels are built for head dims {HEAD_DIMS}, got {hd}")
    if any(t.stride(3) != 1 for t in tensors):
        raise ValueError("the flash_attention kernels need unit stride along the head dim")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the kernels' grid (65535)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    return_lse: bool = False):
    """Attention of q (B, H, Sq, hd) over k, v (B, Hkv, Skv, hd): the kernel
    on CUDA tensors, :func:`flash_attention_ref` on CPU tensors.  With
    ``return_lse`` it returns ``(out, lse)`` (module docstring).  A CUDA
    input that requires a gradient raises: :class:`FlashAttention` carries
    one."""
    if not causal:
        raise NotImplementedError(
            "non-causal flash_attention is not ported yet (ROADMAP.md, Queue 1: the model zoo, enc_dec)"
        )
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, return_lse=return_lse)
    _check_cuda((q, k, v), q)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention's kernel output carries no gradient; call FlashAttention.apply(q, k, v) "
            "(repro_torch.kernels.flash_attention), whose backward is the flash_attention_bwd kernel"
        )
    B, H, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    tensor_cores = q.dtype == torch.bfloat16
    fn = _kernel("flash_attention_bf16" if tensor_cores else "flash_attention_f32")
    out = torch.empty(B, Sq, H, hd, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device) if return_lse else None
    lse_ptr = None if lse is None else lse.data_ptr()
    scale = 1.0 / math.sqrt(hd)
    if tensor_cores:
        maps = [tma.pack(m) for m in attention_tensor_maps(q, k, v)]
        o_strides = (ctypes.c_int64 * 3)(*out.stride()[:3])
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv, Sq, Skv, hd, *maps,
                     o_strides, scale, lse_ptr, stream)
    else:
        strides = (ctypes.c_int64 * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv, Sq, Skv, hd, strides,
                     scale, lse_ptr, stream)
    if err < 0:
        raise RuntimeError(f"flash_attention: the driver refused a tensor map (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    bump(flash_attention)
    if tensor_cores:
        bump(flash_attention, "tc_launches")
    return out if lse is None else (out, lse)


def attention_tensor_maps(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The bf16 kernel's TMA maps (``kernels/tma.py``) of q, k and v, each
    over (hd, S, heads, B) with the view's own strides, in boxes of
    ``min(hd, 64)`` (one 128-byte swizzle row, 64 bytes for hd 32) by
    :data:`TC_BLOCK_Q` query rows or :data:`TC_BLOCK_K` keys.  Raises
    ``ValueError`` on a view that TMA refuses."""
    hd = q.shape[3]
    box_d = min(hd, 64)
    return tuple(
        tma.tensor_map_args(t, (3, 2, 1, 0), (box_d, rows, 1, 1), name=name)
        for name, t, rows in (("q", q, TC_BLOCK_Q), ("k", k, TC_BLOCK_K), ("v", v, TC_BLOCK_K))
    )


flash_attention.launches = 0
flash_attention.tc_launches = 0


BWD_LAUNCHES_PER_CALL = 3  # delta, dK/dV, dQ (csrc/flash_attention_bwd.cu)


def _check_bwd(q, k, v, o, do, lse):
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must have q's shape {tuple(q.shape)}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be (B, H, Sq) float32, got {tuple(lse.shape)} {lse.dtype}")
    if not all(t.device == q.device for t in (o, do, lse)):
        raise ValueError("o, do and lse must lie on q's device")
    if not (o.dtype == do.dtype == q.dtype):
        raise TypeError(f"o and do must have q's dtype {q.dtype}, got {o.dtype}, {do.dtype}")


def flash_attention_bwd_ref(q, k, v, o, do, lse):
    """Plain PyTorch version of :func:`flash_attention_bwd`: over key tiles
    of :data:`BLOCK_K`, in f32, ``P = exp(s - lse)`` recomputed from q and
    k with the forward's scale and mask, ``D = rowsum(do o)``, ``dS = P
    (dO V^T - D)``; the query heads of a KV head's group are its rows, so
    dk and dv sum over the group.  Returns ``(dq, dk, dv)`` in the inputs'
    dtype, dq shaped like q and dk, dv like k."""
    _check_bwd(q, k, v, o, do, lse)
    B, H, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rows = (H // Hkv) * Sq
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, Hkv, rows, hd)
    dof = do.float().reshape(B, Hkv, rows, hd)
    delta = (dof * o.float().reshape(B, Hkv, rows, hd)).sum(-1, keepdim=True)
    lse_r = lse.reshape(B, Hkv, rows, 1)
    q_pos = torch.arange(Sq, device=q.device).repeat(H // Hkv)
    dq = torch.zeros_like(qf)
    dk = torch.zeros(B, Hkv, Skv, hd, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, Skv, BLOCK_K):
        kb, vb = k[:, :, k0 : k0 + BLOCK_K].float(), v[:, :, k0 : k0 + BLOCK_K].float()
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        p = torch.where(k_pos[None, :] <= q_pos[:, None], torch.exp(qf @ kb.transpose(-1, -2) * scale - lse_r), 0.0)
        ds = p * (dof @ vb.transpose(-1, -2) - delta)
        dv[:, :, k0 : k0 + kb.shape[2]] = p.transpose(-1, -2) @ dof
        dk[:, :, k0 : k0 + kb.shape[2]] = ds.transpose(-1, -2) @ qf
        dq += ds @ kb
    return ((dq * scale).reshape(B, H, Sq, hd).to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype))


def flash_attention_bwd(q, k, v, o, do, lse):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention`'s output
    ``o`` given its gradient ``do`` and the forward's ``lse``: the kernel on
    CUDA tensors (:data:`BWD_LAUNCHES_PER_CALL` launches; dq laid out as
    (B, Sq, H, hd), dk and dv as (B, Skv, Hkv, hd), each seen as (B, heads,
    S, hd)), :func:`flash_attention_bwd_ref` on CPU tensors; any other
    device raises."""
    _check_bwd(q, k, v, o, do, lse)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, lse)
    _check_cuda((q, k, v, o, do), q)
    if not lse.is_contiguous():
        raise ValueError("the flash_attention_bwd kernel needs a contiguous lse")
    B, H, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    dq = torch.empty(B, Sq, H, hd, dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty(B, Skv, Hkv, hd, dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    fn = _kernel("flash_attention_bwd", lib="flash_attention_bwd")
    strides = (ctypes.c_int64 * 24)(*(st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 B, H, Hkv, Sq, Skv, hd, strides, 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    bump(flash_attention_bwd, n=BWD_LAUNCHES_PER_CALL)
    bump(flash_attention_bwd, "calls")
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.calls = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable causal attention, ``FlashAttention.apply(q, k, v)``
    with :func:`flash_attention`'s shapes: the forward kernel (with the
    log-sum-exp, only when an input needs a gradient) and, in the
    backward, :func:`flash_attention_bwd`, each dispatched by device."""

    @staticmethod
    def forward(ctx, q, k, v):
        if not any(ctx.needs_input_grad):
            return flash_attention(q, k, v)
        o, lse = flash_attention(q, k, v, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(3) != 1:
            do = do.contiguous()
        return flash_attention_bwd(q, k, v, o, do, lse)


_P, _I = ctypes.c_void_p, ctypes.c_int
_WORDS = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {  # q, k, v, o pointers; B, H, Hkv, Sq, Skv, hd; strides or maps; scale; lse; stream
    "flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _WORDS, ctypes.c_float, _P, _P],
    "flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _WORDS, _WORDS, _WORDS, _WORDS,
                             ctypes.c_float, _P, _P],
    # bf16 flag; q, k, v, o, do, lse, delta, dq, dk, dv; B, H, Hkv, Sq, Skv, hd; strides; scale; stream
    "flash_attention_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _WORDS,
                            ctypes.c_float, _P],
}


def _kernel(name: str, lib: str = "flash_attention"):
    """One C entry point of a flash_attention library, its signature set."""
    from repro_torch.kernels import build

    fn = getattr(build.load(lib), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn
