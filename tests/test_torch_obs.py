"""Consensus telemetry (``repro_torch.obs``) against the reference's.

* Every producer of ``obs/metrics.py`` on the same numpy inputs as
  ``repro.obs.metrics``'s (1e-6 relative; wire bytes exactly).
* Every field of the record on every gather path against the reference's
  ``gather_consensus_rounds(..., obs=ObsConfig())`` (K=4 ring, 3 rounds,
  the reference's cases in one jitted program): the slab path exact (Gram
  recurrence; with momentum and an adaptive gate that turns the last round
  off), every codec (int8, bf16, f16, topk), the edge path with and
  without CSR tables, the tree path.  Wire bytes, ``edges`` and
  ``effective_rounds`` exactly; the other fields 1e-5 of each field's
  largest magnitude (plus 1e-6) on the exact paths and the casts, 1e-3 on
  int8 and top-k, whose rounding or threshold may flip one wire value after
  round 0.
* ``PermuteConsensus`` on its slab and tree paths (``ThreadExchange`` ranks,
  2 rounds, momentum) against the reference's engine vmapped over a named
  axis (its ``ppermute`` and ``psum`` run under ``jax.vmap(axis_name=...)``),
  rank by rank, with the same tolerances.
* The reference's ``tests/test_obs.py`` properties: ``obs=None`` calls no
  producer; ``obs`` leaves the output bit for bit; wire bytes equal
  ``comm/accounting.py``'s; ``edges`` equals the schedule's edge counts;
  ``mix_entropy`` is ``log K`` on the full graph; ``ef_residual`` is
  nonzero for top-k and zero on the exact path; the JSONL round trip with
  bf16 and f16 scalars; ``Throughput`` over a zero-length window; ``scope``
  and ``trace`` are no-ops without a directory, and a trace names the five
  slab phases.
"""
import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as ref_consensus
from repro.core import dynamic as ref_dynamic
from repro.core import topology as ref_topology
from repro.core.drt import DRTConfig as RefDRTConfig
from repro.core import packing as ref_packing
from repro.comm.codec import make_codec as ref_make_codec
from repro.obs import ObsConfig as RefObsConfig
from repro.obs import metrics as ref_metrics
from repro.obs import sink as ref_sink
from repro.utils.pytree import LayerPartition as RefLayerPartition
from repro_torch import PermuteConsensus, obs, spmd_run
from repro_torch.comm import accounting, prng
from repro_torch.comm.codec import make_codec
from repro_torch.core import consensus, dynamic, packing, topology
from repro_torch.core.drt import DRTConfig
from repro_torch.obs import metrics
from repro_torch.utils.pytree import LayerPartition, agent_template, tree_items, tree_map

torch.set_num_threads(1)
K, ROUNDS, BETA = 4, 3, 0.4
FIELDS = metrics.ConsensusMetrics._fields
EXACT_FIELDS = ("wire_send_bytes", "wire_recv_bytes", "compression_ratio", "edges", "effective_rounds")


def _tree(seed=0, k=K):
    """Two groups, 4 DRT layers: a stacked group of 3 slots and a plain one."""
    rng = np.random.default_rng(seed)
    return {"blocks": {"w": rng.normal(size=(k, 3, 8, 8)).astype(np.float32)},
            "embed": {"w": rng.normal(size=(k, 4, 8)).astype(np.float32)}}


def _port(tree):
    return tree_map(torch.from_numpy, tree)


def _run_reference(fn, tree):
    """``fn(tree)`` as one jitted program, compiled at XLA's lowest backend
    optimization level (it compiles in two thirds of the time; the
    tolerances below hold at any level), results as numpy."""
    x = jax.tree.map(jnp.asarray, tree)
    compiled = jax.jit(fn).lower(x).compile({"xla_backend_optimization_level": 0})
    return jax.tree.map(np.asarray, compiled(x))


def _check(got: metrics.ConsensusMetrics, want, rtol, label):
    """Field by field: the exact fields equal, the others within ``rtol``
    of the field's largest magnitude plus 1e-6 (weights and entropies are
    O(1): a few f32 roundings of a weight where the field is ~0)."""
    assert got._fields == FIELDS == tuple(want._fields)
    for name in FIELDS:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.shape == b.shape, (label, name, a.shape, b.shape)
        if name in EXACT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f"{label} {name}")
        else:
            scale = max(float(np.abs(b).max()), 1e-6)
            np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale + 1e-6, err_msg=f"{label} {name}")


# -- the producers ------------------------------------------------------------------


def test_producers_match_reference():
    rng = np.random.default_rng(3)
    d2 = rng.uniform(0.0, 5.0, size=(4, K, K)).astype(np.float32)
    A = rng.uniform(0.0, 1.0, size=(4, K, K)).astype(np.float32)
    A[:, 1, 2] = 0.0  # a zero weight contributes nothing
    A /= A.sum(1, keepdims=True)
    C = (rng.uniform(size=(K, K)) > 0.4).astype(np.float32)
    C = np.maximum(np.maximum(C, C.T), np.eye(K, dtype=np.float32))
    d2s = rng.uniform(0.0, 5.0, size=(3, 4)).astype(np.float32)
    mask = np.array([True, False, True])
    byz = np.array([True, False, False, True])
    w_all = np.concatenate([A[:, 0, :1].T, A[:, 1:, 0].T])  # (1 + 3, L): agent 0's column, self first
    tree_K = _tree(1)
    one = jax.tree.map(lambda x: x[0], tree_K)
    ref_part = RefLayerPartition.build(one)
    ref_layout = ref_packing.build_slab_layout(ref_part, one)
    ref_topk = ref_make_codec("topk:0.25")

    @jax.jit
    def reference(d2, A, C, d2s, w_all, tree_K):
        sent, _ = ref_packing.slab_encode_batched(ref_topk, ref_layout, ref_layout.pack_regions(tree_K), None, None)
        tree_wire, _ = ref_topk.encode(jax.tree.map(lambda x: x[0], tree_K), ref_topk.init_state(one))
        return [ref_metrics.d2_summaries(d2), ref_metrics.neighbour_d2_summaries(d2s, mask),
                ref_metrics.mixing_entropy(A), ref_metrics.column_entropy(w_all), ref_metrics.edge_count(C),
                ref_metrics.tree_disagreement(tree_K), ref_metrics.tree_mean_sq_norm(tree_K),
                ref_metrics.suspicion_from_A(A, C), ref_metrics.byzantine_weight_mass(A, byz),
                ref_metrics.slab_wire_send_bytes(ref_topk, ref_layout, sent),
                ref_metrics.tree_wire_send_bytes(ref_topk, tree_wire, one)]

    want = reference(d2, A, C, d2s, w_all, tree_K)
    pK = _port(tree_K)
    template = agent_template(pK)
    layout = packing.build_slab_layout(LayerPartition.build(template), template)
    topk = make_codec("topk:0.25")
    sent, _ = consensus.slab_encode_batched(topk, layout, layout.pack(pK), None, None)
    tree_wire, _ = topk.encode(tree_map(lambda x: x[0], pK), topk.init_state(tree_map(lambda x: x[0], pK)))
    t = torch.from_numpy
    got = [metrics.d2_summaries(t(d2)), metrics.neighbour_d2_summaries(t(d2s), t(mask)),
           metrics.mixing_entropy(t(A)), metrics.column_entropy(t(w_all)), metrics.edge_count(t(C)),
           metrics.tree_disagreement(pK), metrics.tree_mean_sq_norm(pK), metrics.suspicion_from_A(t(A), t(C)),
           metrics.byzantine_weight_mass(t(A), t(byz)), metrics.slab_wire_send_bytes(topk, layout, sent),
           metrics.tree_wire_send_bytes(topk, tree_wire, template)]
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = (g, w) if isinstance(g, tuple) else ((g,), (w,))
        for a, b in zip(g, w):
            tol = 0.0 if i >= 9 else 1e-6  # wire bytes exactly
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol, err_msg=str(i))
    # the static wire volumes, from the two layouts
    assert metrics.slab_identity_bytes(layout) == ref_metrics.slab_identity_bytes(ref_layout)
    for name in (None, "identity", "bf16", "f16", "int8"):
        codec = None if name is None else make_codec(name)
        ref_codec = None if name is None else ref_make_codec(name)
        assert metrics.slab_static_wire_bytes(codec, layout) == ref_metrics.slab_static_wire_bytes(
            ref_codec, ref_layout), name
        assert float(metrics.tree_wire_send_bytes(codec, tree_map(lambda x: x[0], pK), template)) == float(
            ref_codec.wire_bytes(one) if ref_codec else ref_make_codec("identity").wire_bytes(one)), name
    with pytest.raises(ValueError, match="top-k"):
        metrics.slab_static_wire_bytes(topk, layout)
    int8 = make_codec("int8")
    wire, _ = consensus.slab_encode_batched(int8, layout, layout.pack(pK), None,
                                            prng.fold_in(prng.key(1), np.arange(K)))
    np.testing.assert_array_equal(metrics.slab_wire_send_bytes(int8, layout, wire).numpy(),
                                  np.full(K, metrics.slab_static_wire_bytes(int8, layout), np.float32))
    empty, ref_empty = metrics.empty_metrics(4, K), ref_metrics.empty_metrics(4, K)
    assert [tuple(f.shape) for f in empty] == [tuple(f.shape) for f in ref_empty]
    assert set(obs.__all__) == set(__import__("repro.obs", fromlist=["x"]).__all__)


# -- the gather engine's paths ------------------------------------------------------

# (name, path, codec, algorithm, extra keywords); "tol" marks the adaptive case
CASES = [
    ("slab-exact-drt", "slab", None, "drt", {}),
    ("slab-exact-classical", "slab", None, "classical", {}),
    ("slab-exact-momentum-tol", "slab", None, "drt", dict(momentum=BETA, round_tol="tol")),
    ("slab-int8-drt", "slab", "int8", "drt", {}),
    ("slab-bf16-drt", "slab", "bf16", "drt", {}),
    ("slab-f16-classical", "slab", "f16", "classical", {}),
    ("slab-topk-drt-momentum", "slab", "topk:0.25", "drt", dict(momentum=BETA)),
    ("edge-exact-drt-csr", "edge", None, "drt", dict(max_in_degree=2)),
    ("edge-int8-drt-scatter", "edge", "int8", "drt", {}),
    ("edge-topk-classical-csr-tol", "edge", "topk:0.25", "classical", dict(max_in_degree=2, round_tol="tol")),
    ("tree-int8-drt-momentum", "tree", "int8", "drt", dict(momentum=BETA)),
]
IDS = [c[0] for c in CASES]


def _gate_tol(case):
    """A tol between the disagreements after rounds 1 and 2 of the same
    configuration's fixed round-set (their geometric mean), so the gate
    turns round 3 off with a margin no last-bit difference crosses."""
    kw = {k: v for k, v in case[4].items() if k != "round_tol"}
    m = _port_case((case[0], case[1], case[2], case[3], kw))[-1].disagreement
    return float(np.sqrt(float(m[0]) * float(m[1])))


def _case_kw(case, pkg_topology, pkg_dynamic, key):
    _, path, codec, algo, extra = case
    t = pkg_topology.ring(K)
    kw = dict(rounds=ROUNDS, algorithm=algo, metropolis=t.metropolis(), path=path, **extra)
    if path == "edge":
        kw["edges"] = pkg_dynamic.edge_stacks_from_topology(t, ROUNDS)
    if codec:
        kw.update(codec=codec, rng=key)
    return t.c_matrix(), kw


def _port_case(case, **over):
    pK = _port(_tree())
    C, kw = _case_kw(case, topology, dynamic, prng.key(5))
    kw.update(over)
    part = LayerPartition.build(agent_template(pK))
    return consensus.gather_consensus_rounds(part, pK, C, DRTConfig(), obs=metrics.ObsConfig(), **kw)


@pytest.fixture(scope="module")
def gather_reference():
    """Every case's reference metrics and tree, one jitted program."""
    tree = _tree()
    tols = {c[0]: _gate_tol(c) for c in CASES if c[4].get("round_tol") == "tol"}
    part = RefLayerPartition.build(jax.tree.map(lambda x: x[0], tree))

    def run(psi):
        out = {}
        for case in CASES:
            C, kw = _case_kw(case, ref_topology, ref_dynamic, jax.random.key(5))
            if case[0] in tols:
                kw["round_tol"] = tols[case[0]]
            res = ref_consensus.gather_consensus_rounds(part, psi, C, RefDRTConfig(), obs=RefObsConfig(), **kw)
            out[case[0]] = (res[0], res[-1])
        return out

    return tols, _run_reference(run, tree)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gather_paths_match_reference(gather_reference, case):
    tols, ref = gather_reference
    out = _port_case(case, **({"round_tol": tols[case[0]]} if case[0] in tols else {}))
    new_r, m_r = ref[case[0]]
    coarse = case[2] in ("int8", "topk:0.25")
    _check(out[-1], m_r, 1e-3 if coarse else 1e-5, case[0])
    x_max = max(float(np.abs(x).max()) for _, x in tree_items(new_r))
    for (_, a), (_, b) in zip(tree_items(out[0]), tree_items(new_r)):
        assert float(np.abs(a.numpy() - b).max()) <= (ROUNDS * x_max / 127.0 if coarse else 1e-5), case[0]
    m = out[-1]
    assert m.layer_d2_mean.shape == (ROUNDS, 4) and m.suspicion.shape == (ROUNDS, K)
    if case[4].get("round_tol"):  # the gate turned round 3 off: no bytes, no momentum
        assert m.effective_rounds.tolist() == [1.0, 2.0, 2.0]
        assert float(m.wire_send_bytes[-1]) == 0.0 and float(m.momentum_norm[-1]) == 0.0
    if case[4].get("momentum"):
        assert float(m.momentum_norm[1]) > 0.0


# -- the permute engine ---------------------------------------------------------------

PERMUTE_CASES = [("slab", None, "drt"), ("slab", "int8", "classical"), ("slab", "topk:0.25", "drt"),
                 ("tree", "topk:0.25", "classical")]
PERMUTE_ROUNDS = 2
PERMUTE_IDS = ["-".join(str(x) for x in c) for c in PERMUTE_CASES]


@pytest.fixture(scope="module")
def permute_reference():
    """The reference's engine per case, its agents as a vmapped named axis
    (one jitted program): every rank's metrics."""
    tree = _tree(2)
    part = RefLayerPartition.build(jax.tree.map(lambda x: x[0], tree))
    t = ref_topology.ring(K)

    def run(psi):
        out = {}
        for path, codec, algo in PERMUTE_CASES:
            eng = ref_consensus.PermuteConsensus(part, t, RefDRTConfig(), algorithm=algo, codec=codec, path=path,
                                                 momentum=BETA)
            fn = jax.vmap(lambda x: eng(x, None, jax.random.key(5), rounds=PERMUTE_ROUNDS, obs=RefObsConfig()),
                          axis_name="data")
            out[f"{path}-{codec}-{algo}"] = fn(psi)[-1]
        return out

    return _run_reference(run, tree)


@pytest.mark.parametrize("case", PERMUTE_CASES, ids=PERMUTE_IDS)
def test_permute_paths_match_reference(permute_reference, case):
    path, codec, algo = case
    pK = _port(_tree(2))
    part = LayerPartition.build(agent_template(pK))
    eng = PermuteConsensus(part, topology.ring(K), DRTConfig(), algorithm=algo, codec=codec, path=path,
                           momentum=BETA)
    outs = spmd_run(lambda r, ex: eng(tree_map(lambda x: x[r], pK), ex, None, prng.key(5), rounds=PERMUTE_ROUNDS,
                                      obs=metrics.ObsConfig()), K, device="cpu")
    want = permute_reference["-".join(str(x) for x in case)]
    coarse = codec is not None and codec != "bf16"
    for rank, out in enumerate(outs):
        _check(out[-1], jax.tree.map(lambda x: x[rank], want), 1e-3 if coarse else 1e-5, f"{case} rank {rank}")
        assert not out[-1].suspicion.any() and float(out[-1].momentum_norm[1]) > 0.0


# -- the reference's test_obs properties ----------------------------------------------


def _all_paths(obs_cfg):
    """Every gather path (slab exact, coded, faulted; edge; tree) and both
    permute paths, with ``obs_cfg``; returns their outputs."""
    pK = _port(_tree())
    part = LayerPartition.build(agent_template(pK))
    t = topology.ring(K)
    C = t.c_matrix()
    edges = dynamic.edge_stacks_from_topology(t, 2)
    base = dict(rounds=2, obs=obs_cfg, rng=prng.key(3))
    outs = [consensus.gather_consensus_rounds(part, pK, C, DRTConfig(), **base, **kw) for kw in (
        {}, dict(codec="int8"), dict(codec="topk:0.25", trust_clip=0.4), dict(path="edge", edges=edges),
        dict(path="edge", edges=edges, max_in_degree=2, codec="bf16", trust_temp=0.5), dict(path="tree"))]
    for path in ("slab", "tree"):
        eng = PermuteConsensus(part, t, DRTConfig(), codec="int8", path=path)
        outs += spmd_run(lambda r, ex: eng(tree_map(lambda x: x[r], pK), ex, None, prng.key(3), rounds=2,
                                           obs=obs_cfg), K, device="cpu")
    return outs


def test_obs_none_calls_no_producer_and_obs_keeps_the_output(monkeypatch):
    on = _all_paths(metrics.ObsConfig(annotate=True))

    def boom(*a, **k):
        raise AssertionError("a telemetry producer ran with obs=None")

    for name in ("d2_summaries", "neighbour_d2_summaries", "mixing_entropy", "column_entropy", "edge_count",
                 "tree_disagreement", "tree_mean_sq_norm", "suspicion_from_A", "byzantine_weight_mass",
                 "slab_static_wire_bytes", "slab_identity_bytes", "slab_wire_send_bytes", "tree_wire_send_bytes",
                 "stack_metrics", "empty_metrics"):
        monkeypatch.setattr(metrics, name, boom)
    off = _all_paths(None)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert isinstance(a[-1], metrics.ConsensusMetrics) and len(a) == len(b) + 1
        for (_, x), (_, y) in zip(tree_items(a[0]), tree_items(b[0])):
            assert torch.equal(x, y)  # bit for bit


def test_wire_bytes_match_accounting_and_edges_match_the_schedule():
    pK = _port(_tree())
    template = agent_template(pK)
    part = LayerPartition.build(template)
    t = topology.ring(K)
    for name in (None, "bf16", "f16", "int8"):
        m = consensus.gather_consensus_rounds(part, pK, t.c_matrix(), DRTConfig(), rounds=2, codec=name,
                                              rng=prng.key(1), obs=metrics.ObsConfig())[-1]
        want = accounting.wire_bytes(template, name)
        assert m.wire_send_bytes.tolist() == [float(want)] * 2, name
        assert m.wire_recv_bytes.tolist() == [float(accounting.collective_bytes_per_step(t, template, "gather", name)
                                                    ["recv_bytes"])] * 2
        np.testing.assert_allclose(m.compression_ratio.numpy(), accounting.compression_ratio(template, name),
                                   rtol=1e-6)
        eng = PermuteConsensus(part, t, DRTConfig(), codec=name)
        outs = spmd_run(lambda r, ex: eng(tree_map(lambda x: x[r], pK), ex, None, prng.key(1),
                                          obs=metrics.ObsConfig()), K, device="cpu")
        recv = accounting.collective_bytes_per_step(t, template, "permute", name)["recv_bytes"]
        assert all(o[-1].wire_recv_bytes.tolist() == [float(recv)] for o in outs), name
    sched = dynamic.ChurnSchedule(dynamic.PeriodicSchedule((topology.ring(K), topology.make_topology("full", K))),
                                  agent_drop=0.25, seed=4)
    C, M = sched.mixing_stacks(3, 4)
    want = sched.edge_counts(3, 4).tolist()
    for kw in (dict(), dict(path="edge", edges=sched.edge_stacks(3, 4), max_in_degree=sched.max_in_degree)):
        m = consensus.gather_consensus_rounds(part, pK, C, DRTConfig(), rounds=4, metropolis=M,
                                              obs=metrics.ObsConfig(), **kw)[-1]
        assert m.edges.tolist() == want, (kw.get("path"), m.edges.tolist(), want)


def test_entropy_on_the_full_graph_and_the_residual_of_each_codec():
    pK = _port(_tree())
    part = LayerPartition.build(agent_template(pK))
    full = topology.make_topology("full", K)
    m = consensus.gather_consensus_rounds(part, pK, full.c_matrix(), DRTConfig(), rounds=2, algorithm="classical",
                                          metropolis=full.metropolis(), obs=metrics.ObsConfig())[-1]
    np.testing.assert_allclose(m.mix_entropy.numpy(), np.log(K), rtol=1e-6)  # Metropolis on the full graph: 1/K
    t = topology.ring(K)
    for codec, path in ((None, "slab"), ("topk:0.25", "slab"), ("topk:0.25", "tree")):
        m = consensus.gather_consensus_rounds(part, pK, t.c_matrix(), DRTConfig(), rounds=2, codec=codec,
                                              path=path, obs=metrics.ObsConfig())[-1]
        assert (m.ef_residual > 0).all() if codec else not m.ef_residual.any(), (codec, path)


def test_jsonl_round_trip_with_low_precision_scalars(tmp_path):
    m = consensus.gather_consensus_rounds(
        LayerPartition.build(agent_template(_port(_tree()))), _port(_tree()), topology.ring(K).c_matrix(),
        DRTConfig(), rounds=2, obs=metrics.ObsConfig())[-1]
    half = metrics.ConsensusMetrics(*(f.to(torch.bfloat16) for f in m))
    path = tmp_path / "m.jsonl"
    with obs.JsonlSink(path) as sink:
        for step, stack in enumerate((m, half)):
            for rec in obs.consensus_records(stack, step=step, agent=1):
                sink.write(rec)
        sink.write({"kind": "train", "step": 0, "loss": torch.tensor(1.5, dtype=torch.bfloat16),
                    "lr": np.float16(0.25), "ids": np.arange(3, dtype=np.int16)})
    recs = obs.read_jsonl(path)
    assert len(recs) == 5 and recs[-1] == {"kind": "train", "step": 0, "loss": 1.5, "lr": 0.25, "ids": [0, 1, 2]}
    assert recs[0]["round"] == 0 and recs[1]["agent"] == 1 and len(recs[0]["layer_d2_mean"]) == 4
    assert recs[2]["disagreement"] == float(m.disagreement[0].to(torch.bfloat16).float())
    # the reference's reader and summary take the port's file as they take their own
    assert ref_sink.read_jsonl(path) == recs
    summ = obs.summarize(recs)
    assert summ == ref_sink.summarize(recs) and summ["edges"] == {"mean": 4.0, "last": 4.0, "n": 4}
    assert "disagreement" in obs.format_summary(summ) and obs.format_summary({}) == "(no records)"
    csv_path = tmp_path / "m.csv"
    obs.write_csv(recs, csv_path)
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 5 and list(rows[0])[:5] == ["kind", "step", "round", "agent", "disagreement"]
    assert json.loads(rows[0]["layer_d2_mean"]) == recs[0]["layer_d2_mean"] and rows[4]["loss"] == "1.5"


def test_throughput_over_a_zero_length_window():
    ticks = iter([10.0, 10.0, 12.0, 12.0])
    tp = obs.Throughput(clock=lambda: next(ticks))
    assert tp.update(3, 30) == obs.Rate(0.0, 0.0, 3, 30, 0.0)  # no time passed: no rate
    assert tp.update(4, 40) == obs.Rate(2.0, 20.0, 4, 40, 2.0)
    assert tp.lifetime() == obs.Rate(3.5, 35.0, 7, 70, 2.0)


def test_scope_and_trace(tmp_path):
    import contextlib

    assert isinstance(obs.scope(None, "x"), contextlib.nullcontext)
    assert isinstance(obs.scope(metrics.ObsConfig(), "x"), contextlib.nullcontext)
    with obs.trace(None) as prof:
        assert prof is None
    assert not list(tmp_path.iterdir())
    pK = _port(_tree())
    part = LayerPartition.build(agent_template(pK))
    t = topology.ring(K)
    ann = metrics.ObsConfig(annotate=True)
    with obs.trace(tmp_path / "prof"), obs.annotation("chunk"):
        consensus.gather_consensus_rounds(part, pK, t.c_matrix(), DRTConfig(), rounds=2, obs=ann)
        consensus.gather_consensus_rounds(part, pK, t.c_matrix(), DRTConfig(), rounds=2, codec="int8",
                                          rng=prng.key(1), path="edge", edges=dynamic.edge_stacks_from_topology(t, 2),
                                          obs=ann)
    names = {e["name"] for e in json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
             if "name" in e}
    for span in ("chunk", "consensus.pack", "consensus.encode", "consensus.decode", "consensus.combine",
                 "consensus.unpack"):
        assert span in names, span


def test_thread_exchange_psum_is_one_sum_every_rank_copies():
    """The permute engine's global disagreement costs one ``psum`` of the
    D-sized iterate a round: rank 0 adds the ranks' tensors in rank order
    and every rank reads a copy of that one sum (the same bits); tensors
    that differ between ranks raise on every rank, none waits forever."""
    xs = [torch.from_numpy(np.random.default_rng(r).normal(size=1001).astype(np.float32)) for r in range(K)]
    outs = spmd_run(lambda r, ex: ex.psum(xs[r]), K, device="cpu")
    want = xs[0].clone()
    for x in xs[1:]:
        want.add_(x)
    assert all(torch.equal(o, want) for o in outs)
    assert len({o.data_ptr() for o in outs}) == K  # a copy each: a rank may write to its own
    with pytest.raises(ValueError, match="different tensors"):
        spmd_run(lambda r, ex: ex.psum(torch.zeros(r + 1)), K, device="cpu")
