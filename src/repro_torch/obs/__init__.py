"""Consensus telemetry, structured sinks and profiler hooks (counterpart of
``repro.obs``).  :mod:`repro_torch.obs.metrics` holds the
``ConsensusMetrics`` record; ``obs=None`` (every engine's default) calls
none of its producers."""
from repro_torch.obs.metrics import (
    ConsensusMetrics,
    ObsConfig,
    column_entropy,
    d2_summaries,
    edge_count,
    empty_metrics,
    mixing_entropy,
    neighbour_d2_summaries,
    slab_identity_bytes,
    slab_static_wire_bytes,
    slab_wire_send_bytes,
    stack_metrics,
    tree_disagreement,
    tree_mean_sq_norm,
    tree_wire_send_bytes,
)
from repro_torch.obs.profiling import annotation, scope, trace
from repro_torch.obs.sink import (
    JsonlSink,
    consensus_records,
    format_summary,
    read_jsonl,
    summarize,
    write_csv,
)
from repro_torch.obs.throughput import Rate, Throughput

__all__ = [
    "ConsensusMetrics",
    "ObsConfig",
    "JsonlSink",
    "Rate",
    "Throughput",
    "annotation",
    "column_entropy",
    "consensus_records",
    "d2_summaries",
    "edge_count",
    "empty_metrics",
    "format_summary",
    "mixing_entropy",
    "neighbour_d2_summaries",
    "read_jsonl",
    "scope",
    "slab_identity_bytes",
    "slab_static_wire_bytes",
    "slab_wire_send_bytes",
    "stack_metrics",
    "summarize",
    "trace",
    "tree_disagreement",
    "tree_mean_sq_norm",
    "tree_wire_send_bytes",
    "write_csv",
]
