"""The kernel API: one module with every kernel wrapper of the port, under
the names of ``repro/kernels/ops.py``.

Each wrapper dispatches on the device of its tensors: a CPU tensor runs the
plain PyTorch version beside the kernel, a CUDA tensor launches the
hand-written Hopper kernel (``csrc/*.cu``, built with nvcc for sm_90a at
first use) or raises.  There is no fallback from one to the other and no
switch.  The reference's ``interpret`` flag, ``default_interpret`` and
``selective_scan``'s ``chunk`` are knobs of the TPU build with no
counterpart here.

Differences from the reference's signatures, each for a stated reason:

* ``int8_quantize(x, u)`` takes the uniform field ``u`` (f32, x-shaped)
  where the reference takes a ``jax.random`` key: torch cannot draw JAX's
  bits, so the caller supplies them;
* ``weighted_combine`` and ``dequant_combine`` also take an (M, N) weight
  matrix and return (M, ...) in one launch: the batched form of the
  reference's ``jax.vmap`` over output agents;
* ``selective_scan`` returns ``(y, h_last)``: the serving path's decode
  reads the last state (``repro_torch.kernels.selective_scan``);
* ``slab_edge_encode_combine`` and ``slab_edge_combine`` return ``(out,
  A_self, A_e)`` and ``slab_encode_combine`` ``(out, A)``, as the port's
  consensus engine reads them.

``ref`` holds the plain oracles (``combine_ref``, ``int8_quantize_ref``,
``int8_dequantize_ref``, ``dequant_combine_ref`` and the plain versions of
the other kernels).
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.combine import weighted_combine
from repro_torch.kernels.drt_dist import drt_dist
from repro_torch.kernels.quantize import dequant_combine, int8_dequantize, int8_quantize
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.kernels.slab_codec import slab_encode_combine, slab_quant_encode
from repro_torch.kernels.slab_combine import slab_combine, slab_dequant_combine, slab_source_combine
from repro_torch.kernels.slab_segment import slab_edge_combine, slab_edge_encode_combine

CAST_MODES = ("bf16", "f16")


def slab_cast_combine(block_layer, slab, mix, *, dtype: str = "bf16", **kw):
    """ONE bf16 / f16 coded round on the (K, D) slab: ``slab_encode_combine``
    with the cast wire view (the reference's ``slab_cast_combine`` wraps the
    same kernel).  Returns ``(out, A)``."""
    if dtype not in CAST_MODES:
        raise ValueError(f"slab_cast_combine takes dtype in {CAST_MODES}, got {dtype!r}")
    return slab_encode_combine(block_layer, slab, (), mix, mode=dtype, **kw)


__all__ = [
    "dequant_combine",
    "drt_dist",
    "int8_dequantize",
    "int8_quantize",
    "ref",
    "selective_scan",
    "slab_cast_combine",
    "slab_combine",
    "slab_dequant_combine",
    "slab_edge_combine",
    "slab_edge_encode_combine",
    "slab_encode_combine",
    "slab_quant_encode",
    "slab_source_combine",
    "weighted_combine",
]
