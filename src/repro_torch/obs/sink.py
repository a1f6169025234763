"""Host-side metric sinks: a JSONL writer, CSV and console summaries.

Counterpart of ``repro.obs.sink``.  Records are flat dicts with a ``kind``
key plus ``step`` / ``round`` (and optionally ``agent``), one JSON object a
line.  A producer loop::

    with JsonlSink(path) as sink:
        for step in range(steps):
            state, _, metrics = trainer.consensus(state, obs=ObsConfig())
            for rec in consensus_records(metrics, step=step):
                sink.write(rec)

and the consumer::

    records = read_jsonl(path)
    print(format_summary(summarize(records)))
    write_csv(records, "metrics.csv")

Values may be torch tensors (on any device, bf16 and f16 included), numpy
arrays or Python numbers.
"""
from __future__ import annotations

import csv
import json
from typing import Any, Iterable

import numpy as np
import torch


class JsonlSink:
    """Append-only line-delimited JSON sink (a context manager), line
    buffered so records survive a crashed run."""

    def __init__(self, path):
        self.path = str(path)
        self._f = open(self.path, "a", buffering=1)

    def write(self, record: dict) -> None:
        self._f.write(json.dumps(record, default=_jsonable) + "\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _host(x) -> np.ndarray:
    """A tensor or array as a numpy array of a builtin dtype: bf16 and f16
    (torch) and non-builtin numpy dtypes widen to float64 or int64."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.double() if x.is_floating_point() else x.long()).numpy()
    arr = np.asarray(x)
    if not (arr.dtype.isbuiltin and arr.dtype.kind in "biufc"):
        arr = arr.astype(np.int64 if arr.dtype.kind in "iu" else np.float64)
    return arr


def _jsonable(x):
    arr = _host(x)
    return arr.item() if arr.ndim == 0 else arr.tolist()


def consensus_records(metrics, *, step: int, agent: "int | None" = None) -> list[dict]:
    """One record per round of a ``(rounds,)``-leading
    :class:`~repro_torch.obs.metrics.ConsensusMetrics`, keyed by ``step`` /
    ``round`` (and ``agent`` for a per-agent stack): scalar fields as
    floats, per-layer and per-agent fields as lists."""
    fields = {k: _host(v) for k, v in metrics._asdict().items()}
    rounds = next(iter(fields.values())).shape[0]
    records = []
    for r in range(rounds):
        rec: dict[str, Any] = {"kind": "consensus", "step": int(step), "round": r}
        if agent is not None:
            rec["agent"] = int(agent)
        for key, val in fields.items():
            v = val[r]
            rec[key] = float(v) if v.ndim == 0 else v.tolist()
        records.append(rec)
    return records


def read_jsonl(path) -> list[dict]:
    """Every record of a JSONL metric file."""
    with open(str(path)) as f:
        return [json.loads(line) for line in (ln.strip() for ln in f) if line]


def summarize(records: Iterable[dict], kind: str = "consensus") -> dict:
    """Per scalar key: ``{"mean", "last", "n"}`` over every record of
    ``kind`` (rounds, steps and agents pooled)."""
    rows = [r for r in records if r.get("kind") == kind]
    keys: list[str] = []
    for r in rows:
        for k, v in r.items():
            if k not in ("kind", "step", "round", "agent") and isinstance(v, (int, float)) and k not in keys:
                keys.append(k)
    out = {}
    for k in keys:
        vals = [r[k] for r in rows if isinstance(r.get(k), (int, float))]
        out[k] = {"mean": float(np.mean(vals)), "last": float(vals[-1]), "n": len(vals)}
    return out


def format_summary(summary: dict) -> str:
    """A console table of :func:`summarize`'s result."""
    if not summary:
        return "(no records)"
    width = max(len(k) for k in summary)
    lines = [f"{'metric':<{width}}  {'mean':>14}  {'last':>14}  {'n':>6}"]
    for k, s in summary.items():
        lines.append(f"{k:<{width}}  {s['mean']:>14.6g}  {s['last']:>14.6g}  {s['n']:>6d}")
    return "\n".join(lines)


def write_csv(records: Iterable[dict], path) -> None:
    """Records as CSV: the union of their keys, list-valued fields as JSON
    in their cell."""
    rows = list(records)
    if not rows:
        return
    keys: list[str] = []
    for r in rows:
        keys.extend(k for k in r if k not in keys)
    with open(str(path), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=keys)
        writer.writeheader()
        for r in rows:
            writer.writerow({k: json.dumps(v) if isinstance(v, (list, dict)) else v for k, v in r.items()})
