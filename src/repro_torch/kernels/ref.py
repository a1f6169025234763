"""Plain PyTorch oracles of every kernel: the port's counterpart of
``repro/kernels/ref.py``.

``combine_ref``, ``int8_quantize_ref``, ``int8_dequantize_ref`` and
``dequant_combine_ref`` are the reference's oracles as it writes them: a
tensordot for the combines, and a DIVISION by the scale for the
quantization (the TPU kernel, and the port's kernel with its plain version
``repro_torch.kernels.quantize.int8_quantize_plain``, multiply by the f32
reciprocal instead, which can land on the other integer where ``x / scale
+ u`` sits within a rounding of one).
The rest are the plain versions that sit beside each kernel of the port.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.combine import weighted_combine_ref
from repro_torch.kernels.drt_dist import drt_dist_ref
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.quantize import dequant_combine_plain, int8_dequantize_plain, int8_quantize_plain
from repro_torch.kernels.selective_scan import selective_scan_ref
from repro_torch.kernels.slab_codec import slab_encode_combine_ref, slab_quant_encode_ref
from repro_torch.kernels.slab_combine import (
    slab_combine_ref,
    slab_dequant_combine_ref,
    slab_source_combine_ref,
)
from repro_torch.kernels.slab_segment import slab_edge_combine_ref, slab_edge_encode_combine_ref

F32 = torch.float32


def combine_ref(a: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Weighted neighbour combine ``out = sum_n a[n] * xs[n]``: ``a`` (N,)
    f32, ``xs`` (N, ...) any float dtype; ``xs[0]``-shaped, in xs's dtype."""
    return torch.tensordot(a.float(), xs.float(), dims=([0], [0])).to(xs.dtype)


def int8_quantize_ref(x: torch.Tensor, u: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Stochastic-rounding int8 quantization given the uniform field ``u``:
    ``q = clip(floor(x / scale + u), -127, 127)`` as int8, x-shaped."""
    y = x.float() / scale.float() + u.float()
    return torch.clamp(torch.floor(y), -127.0, 127.0).to(torch.int8)


def int8_dequantize_ref(q: torch.Tensor, scale) -> torch.Tensor:
    """f32 reconstruction ``q * scale``."""
    return q.float() * torch.as_tensor(scale, dtype=F32)


def dequant_combine_ref(a: torch.Tensor, scales: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Fused dequantize + weighted neighbour combine ``out = sum_n a[n] *
    scales[n] * qs[n]``: ``a``, ``scales`` (N,) f32, ``qs`` (N, ...) int8;
    f32, ``qs[0]``-shaped."""
    w = a.float() * scales.float()
    return torch.tensordot(w, qs.float(), dims=([0], [0]))


__all__ = [
    "combine_ref",
    "dequant_combine_plain",
    "dequant_combine_ref",
    "drt_dist_ref",
    "flash_attention_ref",
    "int8_dequantize_plain",
    "int8_dequantize_ref",
    "int8_quantize_plain",
    "int8_quantize_ref",
    "selective_scan_ref",
    "slab_combine_ref",
    "slab_dequant_combine_ref",
    "slab_edge_combine_ref",
    "slab_edge_encode_combine_ref",
    "slab_encode_combine_ref",
    "slab_quant_encode_ref",
    "slab_source_combine_ref",
    "weighted_combine_ref",
]
