"""The int8 wire kernels: quantize, dequantize, and the fused dequantize +
weighted combine.

* ``int8_quantize(x, u)`` -> ``(q, scale)``: ``scale = absmax(x) / 127`` (1
  for an all-zero ``x``) and ``q = clip(floor(x * (1 / scale) + u), -127,
  127)`` as int8, ``x``-shaped.  ``u`` is the f32 uniform field in [0, 1):
  the reference draws it with ``jax.random.uniform(key, x.shape)`` inside
  its jitted wrapper; torch cannot reproduce those bits, so here it is an
  operand (the parity tests carry the reference's draw over through
  numpy).  The scale is a torch reduction outside the kernel, as the
  reference computes it outside its Pallas body; under ``jax.jit`` the
  division by 127 compiles to ``absmax * f32(1/127)``, which the port
  copies.
* ``int8_dequantize(q, scale)`` -> ``q * scale`` in f32.
* ``dequant_combine(a, scales, qs)`` -> ``sum_n (a[n] * scales[n]) * qs[n]``
  in f32 (``a``, ``scales`` (N,), ``qs`` (N, ...) int8).  Batched like
  ``weighted_combine``: ``a`` (M, N) gives (M, ...) in ONE launch.

They replace the Pallas TPU kernels ``repro/kernels/quantize.py``
``int8_quantize``, ``int8_dequantize`` and ``dequant_combine``.  On CUDA
tensors the wrappers launch the hand-written Hopper kernels of
``csrc/quantize.cu`` or raise; on CPU tensors they run the plain PyTorch
versions :func:`int8_quantize_plain`, :func:`int8_dequantize_plain` and
:func:`dequant_combine_plain`.  There is no fallback from one to the other.

The plain versions repeat the kernels' arithmetic and agree with them bit
for bit: ``int8_quantize`` multiplies by the f32 reciprocal of the scale,
as the TPU kernel's body does, with product and sum rounded apart; the
reference's own oracle ``int8_quantize_ref`` divides instead
(``repro_torch.kernels.ref``), which can land on the other integer where
``x / scale + u`` sits within a rounding of one.  ``dequant_combine`` sums in the Pallas body's order.

``<wrapper>.launches`` counts kernel launches (CPU calls do not count).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.combine import MAX_SOURCES
from repro_torch.kernels.counters import bump

QMAX = 127.0
_INV_QMAX = float(np.float32(1.0) / np.float32(QMAX))  # f32(1/127): absmax / 127 under jax.jit
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# -- plain PyTorch versions ----------------------------------------------------


def int8_scale(x: torch.Tensor) -> torch.Tensor:
    """The () f32 scale of :func:`int8_quantize`: ``absmax * f32(1/127)``,
    or 1 where ``x`` is all zero."""
    absmax = x.float().abs().amax()
    return torch.where(absmax > 0, absmax * _INV_QMAX, torch.ones_like(absmax))


def int8_quantize_plain(x: torch.Tensor, u: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's rounding: ``clip(floor(x * (1 / scale) + u), -127,
    127)`` as int8, the reciprocal in f32, product and sum rounded apart."""
    inv = 1.0 / scale.float()
    y = x.float() * inv + u.float()
    return torch.clamp(torch.floor(y), -QMAX, QMAX).to(torch.int8)


def int8_dequantize_plain(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q * scale`` in f32."""
    return q.float() * scale.float()


def dequant_combine_plain(a: torch.Tensor, scales: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`dequant_combine`: the weights ``a *
    scales`` rounded to f32, then the kernel's ordered loop over the
    sources, one rounded product and one rounded sum per source."""
    w, shape = _weights(a, scales, qs)
    q = qs.float().reshape(qs.shape[0], -1)
    acc = w[:, :1] * q[0]
    for n in range(1, q.shape[0]):
        acc = acc + w[:, n : n + 1] * q[n]
    return acc.reshape(shape)


# -- wrappers -------------------------------------------------------------------


def int8_quantize(x: torch.Tensor, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-rounding int8 quantization of ``x`` (f32, bf16 or f16)
    given the uniform field ``u`` (f32, ``x``-shaped): ``(q int8
    x-shaped, scale () f32)`` with ``E[scale * q] = x``.  The scale is a
    torch reduction (:func:`int8_scale`); the rounding is ONE kernel launch
    on CUDA tensors (:func:`int8_round`), :func:`int8_quantize_plain` on
    CPU tensors."""
    if tuple(u.shape) != tuple(x.shape) or x.numel() < 1:
        raise ValueError(f"int8_quantize needs x and u of one non-empty shape, got "
                         f"{tuple(x.shape)} and {tuple(u.shape)}")
    if u.device != x.device:
        raise ValueError(f"x on {x.device}, u on {u.device}")
    scale = int8_scale(x)
    if x.device.type == "cpu":
        return int8_quantize_plain(x, u, scale), scale
    return int8_round(x, u, scale), scale


def int8_round(x: torch.Tensor, u: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel launch of :func:`int8_quantize` on CUDA tensors, given
    the () f32 ``scale`` on the card: ``clip(floor(x * (1 / scale) + u))``
    as int8.  Counted as one ``int8_quantize`` launch."""
    _check_card("int8_quantize", x, dict(x=x, u=u, scale=scale), contiguous=("x", "u"))
    if x.dtype not in _X_DTYPES or u.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError(f"the int8_quantize kernel takes f32, bf16 or f16 x and f32 u and scale, got "
                        f"{x.dtype}, {u.dtype} and {scale.dtype}")
    if tuple(u.shape) != tuple(x.shape) or scale.numel() != 1:
        raise ValueError(f"int8_round needs x and u of one shape and one scale, got {tuple(x.shape)}, "
                         f"{tuple(u.shape)} and {tuple(scale.shape)}")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().int8_quantize_i8(x.data_ptr(), _X_DTYPES[x.dtype], u.data_ptr(),
                                      scale.data_ptr(), q.data_ptr(), x.numel(), _stream(x))
    _raise_on(err, "int8_quantize")
    bump(int8_quantize)
    return q


int8_quantize.launches = 0


def int8_dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    """``q * scale`` in f32 (``q`` int8, ``scale`` a () f32 tensor or a
    number): ONE kernel launch on CUDA tensors, :func:`int8_dequantize_plain`
    on CPU tensors."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    if scale.numel() != 1 or q.numel() < 1:
        raise ValueError(f"int8_dequantize needs a non-empty q and one scale, got "
                         f"{tuple(q.shape)} and {tuple(scale.shape)}")
    if q.device.type == "cpu":
        return int8_dequantize_plain(q, scale)
    _check_card("int8_dequantize", q, dict(q=q), contiguous=("q",))
    if q.dtype != torch.int8:
        raise TypeError(f"the int8_dequantize kernel takes int8 q, got {q.dtype}")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().int8_dequantize_f32(q.data_ptr(), scale.contiguous().data_ptr(),
                                         out.data_ptr(), q.numel(), _stream(q))
    _raise_on(err, "int8_dequantize")
    bump(int8_dequantize)
    return out


int8_dequantize.launches = 0


def dequant_combine(a: torch.Tensor, scales: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``sum_n a[n] * scales[n] * qs[n]`` (``a`` (N,)) or, batched,
    ``out[m] = sum_n a[m, n] * scales[n] * qs[n]`` (``a`` (M, N)), in f32:
    ONE kernel launch on CUDA tensors, :func:`dequant_combine_plain` on CPU
    tensors.  ``qs`` rows may sit any stride apart (``qs[0]`` contiguous)."""
    w, shape = _weights(a, scales, qs)
    if qs.device.type == "cpu":
        return dequant_combine_plain(a, scales, qs)
    _check_card("dequant_combine", qs, dict(a=a, scales=scales, qs=qs))
    if qs.dtype != torch.int8 or a.dtype != torch.float32 or scales.dtype != torch.float32:
        raise TypeError(f"the dequant_combine kernel takes f32 a and scales and int8 qs, got "
                        f"{a.dtype}, {scales.dtype} and {qs.dtype}")
    M, N = w.shape
    if N > MAX_SOURCES:
        raise ValueError(f"the dequant_combine kernel takes 1..{MAX_SOURCES} sources, got N={N}")
    n = qs[0].numel()
    ldq = qs.stride(0) if N > 1 else n
    if not qs[0].is_contiguous() or ldq < n:
        raise ValueError("the dequant_combine kernel needs disjoint contiguous source rows")
    w = w.contiguous()
    out = torch.empty((M, n), dtype=torch.float32, device=qs.device)
    with torch.cuda.device(qs.device):
        err = _lib().dequant_combine_rows(w.data_ptr(), qs.data_ptr(), out.data_ptr(), M, N, n,
                                          ldq, _stream(qs))
    _raise_on(err, "dequant_combine")
    bump(dequant_combine)
    return out.reshape(shape)


dequant_combine.launches = 0


# -- helpers --------------------------------------------------------------------


def _weights(a, scales, qs):
    """``(w (M, N) = a * scales in f32, output shape)`` of a
    dequant_combine, its operands checked."""
    if qs.dim() < 1 or a.dim() not in (1, 2) or a.shape[-1] != qs.shape[0]:
        raise ValueError(f"dequant_combine needs a (N,) or (M, N) and qs (N, ...), got "
                         f"{tuple(a.shape)} and {tuple(qs.shape)}")
    N = qs.shape[0]
    if tuple(scales.shape) != (N,) or N < 1 or qs[0].numel() < 1:
        raise ValueError(f"dequant_combine needs scales ({N},) and a non-empty qs, got "
                         f"{tuple(scales.shape)} and {tuple(qs.shape)}")
    if not (a.device == scales.device == qs.device):
        raise ValueError(f"a on {a.device}, scales on {scales.device}, qs on {qs.device}")
    return a.float().reshape(-1, N) * scales.float(), (*a.shape[:-1], *qs.shape[1:])


def _check_card(name: str, ref: torch.Tensor, tensors: dict, contiguous: tuple = ()) -> None:
    if ref.device.type != "cuda":
        raise ValueError(f"the {name} kernel runs on CUDA tensors, got {ref.device}")
    for key, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name}: {key} on {t.device}, expected {ref.device}")
        if key in contiguous and not t.is_contiguous():
            raise ValueError(f"the {name} kernel needs a contiguous {key}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "int8_quantize_i8": [_P, _I, _P, _P, _P, _I64, _P],
    "int8_dequantize_f32": [_P, _P, _P, _I64, _P],
    "dequant_combine_rows": [_P, _P, _P, _I, _I, _I64, _I64, _P],
}
_typed_lib = None


def _lib():
    """The built library with every entry point's C signature set."""
    global _typed_lib
    if _typed_lib is None:
        from repro_torch.kernels import build

        lib = build.load("quantize")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _typed_lib = lib
    return _typed_lib
