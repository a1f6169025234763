"""Analytic wire volume of the consensus exchange (counterpart of
``repro.comm.accounting``: ``wire_bytes``, ``collective_bytes_per_step``
and ``compression_ratio``)."""
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


def collective_bytes_per_step(topology, template: "Tree | int", engine: str,
                              codec: "WireCodec | str | None" = None) -> dict[str, int]:
    """Analytic collective volume of ONE consensus round, per agent.

    ``template``: a single-agent parameter tree, or a raw parameter byte
    count (the identity codec only).  The gather engine all-gathers the
    wire: ``(K - 1) x`` wire bytes received.  The permute engine exchanges
    once per permutation or matching (``consensus.exchange_decomposition``,
    what it runs): ``n_exchanges x`` wire bytes."""
    from repro_torch.core.consensus import exchange_decomposition  # no import cycle

    resolved = make_codec(codec)
    if isinstance(template, int):
        if not isinstance(resolved, IdentityCodec):
            raise TypeError("codec-aware accounting needs a parameter tree template, not raw param_bytes")
        per_round = template
    else:
        per_round = resolved.wire_bytes(template)
    if engine == "gather":
        return {"recv_bytes": (topology.num_agents - 1) * per_round, "rounds": 1}
    n = len(exchange_decomposition(topology))
    return {"recv_bytes": n * per_round, "rounds": n}
