"""Analytic wire volume of the consensus exchange (counterpart of
``repro.comm.accounting``'s ``wire_bytes`` and ``compression_ratio``)."""
from __future__ import annotations

from repro_torch.comm.codec import IdentityCodec, WireCodec, make_codec
from repro_torch.utils.pytree import Tree


def wire_bytes(template: Tree, codec: "WireCodec | str | None" = None) -> int:
    """Bytes ONE agent puts on the wire per exchange round under ``codec``;
    ``template`` is a single-agent parameter tree (tensors, meta included)."""
    return make_codec(codec).wire_bytes(template)


def compression_ratio(template: Tree, codec: "WireCodec | str | None") -> float:
    """f32-equivalent bytes over the codec's wire bytes (>= 1 when the
    codec compresses)."""
    return IdentityCodec().wire_bytes(template) / max(wire_bytes(template, codec), 1)
