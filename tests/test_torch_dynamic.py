"""Time-varying graphs (``repro_torch.core.dynamic``) against the reference.

Every schedule kind (static, periodic, gossip, one-peer, churn over
periodic) holds its host tables bit for bit: the realized adjacency of
every round of a period, the edge stacks, ``max_in_degree``,
``max_edges``, the period, the edge counts and ``schedule_graph_stats``.
The dense stacks: C exactly; the Metropolis matrices exactly where both
sides cast the topology's float64 matrices (static, periodic), and within
1 f32 ulp where both compute them from the adjacency in f32 (gossip,
churn: the column sums may run in another order than XLA's).  The
reference runs jitted, as a training step runs it.  Then the spec parsers
and their refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dynamic as ref_dynamic
from repro.core import topology as ref_topology
from repro_torch.core import dynamic, topology

torch.set_num_threads(1)
K = 8


def _pair(kind):
    """(port schedule, reference schedule) of one kind."""
    def build(d, t):
        if kind == "static":
            return d.StaticSchedule(t.ring(K))
        if kind == "periodic":
            return d.PeriodicSchedule((t.ring(K), t.hypercube(K), t.make_topology("chain", K)),
                                      rounds_per_topology=2)
        if kind == "gossip":
            return d.RandomGossipSchedule(K, p=0.3, seed=3, cycle=16)
        if kind == "onepeer":
            return d.one_peer_exponential(K)
        return d.ChurnSchedule(d.PeriodicSchedule((t.ring(K), t.hypercube(K))), agent_drop=0.25,
                               edge_drop=0.1, seed=5, cycle=24)
    return build(dynamic, topology), build(ref_dynamic, ref_topology)


KINDS = ["static", "periodic", "gossip", "onepeer", "churn"]


@pytest.mark.parametrize("kind", KINDS)
def test_schedule_tables_match_reference(kind):
    sched, ref = _pair(kind)
    assert sched.static == ref.static and sched.num_agents == ref.num_agents == K
    P = sched._host_edge_period()
    assert P == ref._host_edge_period()
    for t in range(P + 2):
        a, b = sched.topology_at(t), ref.topology_at(t)
        assert a.name == b.name
        np.testing.assert_array_equal(a.adjacency, b.adjacency)
    for a, b in zip(sched._edge_table, ref._edge_table):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert sched.max_in_degree == ref.max_in_degree and sched.max_edges == ref.max_edges
    assert dynamic.schedule_graph_stats(sched) == ref_dynamic.schedule_graph_stats(ref)
    assert dynamic.schedule_graph_stats(sched, rounds=3, wire_itemsize=2) == \
        ref_dynamic.schedule_graph_stats(ref, rounds=3, wire_itemsize=2)
    rounds = 3
    ref_views = jax.jit(lambda s: (ref.mixing_stacks(s, rounds), ref.edge_stacks(s, rounds)))
    for start in (0, 5, P - 1):
        got = sched.mixing_stacks(start, rounds, "cpu")
        want, want_edges = ref_views(jnp.asarray(start, jnp.int32))
        assert all(g.dtype == torch.float32 and g.shape == (rounds, K, K) for g in got)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        if kind in ("static", "periodic"):
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        else:
            np.testing.assert_array_max_ulp(got[1].numpy(), np.asarray(want[1]), maxulp=1)
        for a, b in zip(sched.edge_stacks(start, rounds, "cpu"), want_edges):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(sched.edge_counts(start, rounds).numpy(),
                                      np.asarray(ref.edge_counts(start, rounds)))
        np.testing.assert_array_equal(sched.adjacency_at(start).numpy(), np.asarray(ref.adjacency_at(start)))


def test_churn_isolates_agents_with_identity_columns():
    """The churn cases isolate agents: their Metropolis column is e_k and
    their C column keeps only c_kk; every column stays stochastic."""
    sched, _ = _pair("churn")
    C, M = sched.mixing_stacks(0, sched._host_edge_period())
    iso = [(t, k) for t in range(C.shape[0]) for k in range(K) if C[t, :, k].sum() == 1.0]
    assert iso, "the churn schedule isolates no agent"
    for t, k in iso:
        assert M[t, k, k] == 1.0 and M[t, :, k].sum() == 1.0
    assert float((M.sum(1) - 1.0).abs().max()) <= 1e-6


def test_adjacency_builders_match_reference():
    """c_from_adjacency / metropolis_from_adjacency on random stacks with
    isolated agents: C exact, Metropolis within 1 f32 ulp."""
    rng = np.random.default_rng(0)
    upper = np.triu(rng.random((6, K, K)) < 0.35, k=1)
    adj = (upper | upper.transpose(0, 2, 1)).astype(np.float32)
    adj[0, 3, :] = adj[0, :, 3] = 0.0
    got_c, got_m = dynamic.c_from_adjacency(adj), dynamic.metropolis_from_adjacency(adj)
    want_c, want_m = jax.jit(lambda a: (ref_dynamic.c_from_adjacency(a),
                                        ref_dynamic.metropolis_from_adjacency(a)))(adj)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_max_ulp(got_m.numpy(), np.asarray(want_m), maxulp=1)
    assert got_m[0, 3, 3] == 1.0


@pytest.mark.parametrize("spec,kw", [("ring", {}), ("static:hypercube", {}), ("periodic:ring,hypercube@2", {}),
                                     ("gossip", dict(seed=4)), ("gossip:0.3", {}), ("onepeer", {}),
                                     ("periodic:ring,hypercube", dict(agent_drop=0.1, seed=1)),
                                     ("ring", dict(edge_drop=0.2))])
def test_make_schedule_matches_reference(spec, kw):
    got, want = dynamic.make_schedule(spec, K, **kw), ref_dynamic.make_schedule(spec, K, **kw)
    assert type(got).__name__ == type(want).__name__ and got.static == want.static
    for a, b in zip(got._edge_table, want._edge_table):
        np.testing.assert_array_equal(a, b)


def test_make_schedule_passthrough_and_refusals():
    ring = topology.ring(K)
    assert dynamic.make_schedule(None, K) is None
    assert dynamic.make_schedule(ring, K) == dynamic.StaticSchedule(ring)
    churn = dynamic.make_schedule(ring, K, agent_drop=0.1, seed=2)
    assert isinstance(churn, dynamic.ChurnSchedule) and churn.base == dynamic.StaticSchedule(ring)
    periodic = dynamic.PeriodicSchedule((ring, topology.hypercube(K)))
    assert dynamic.make_schedule(periodic, K) is periodic
    for spec, kw, err in (("nope", {}, ValueError), (None, dict(agent_drop=0.1), ValueError),
                          (topology.ring(4), {}, ValueError), (3.0, {}, TypeError),
                          ("periodic:ring,moebius", {}, KeyError)):
        with pytest.raises(err):
            dynamic.make_schedule(spec, K, **kw)
    for build in (lambda: dynamic.RandomGossipSchedule(1), lambda: dynamic.RandomGossipSchedule(K, p=0.0),
                  lambda: dynamic.RandomGossipSchedule(K, cycle=0), lambda: dynamic.one_peer_exponential(6),
                  lambda: dynamic.ChurnSchedule(periodic, agent_drop=1.0),
                  lambda: dynamic.ChurnSchedule(periodic, cycle=0), lambda: dynamic.PeriodicSchedule(()),
                  lambda: dynamic.PeriodicSchedule((ring, topology.ring(4))),
                  lambda: dynamic.PeriodicSchedule((ring,), rounds_per_topology=0)):
        with pytest.raises(ValueError):
            build()


def test_make_round_policy_matches_reference():
    for spec in ("fixed:3", "adaptive:0.001:4", "adaptive:1e-6:2", "5", 2):
        got, want = dynamic.make_round_policy(spec), ref_dynamic.make_round_policy(spec)
        assert (got.max_rounds, got.tol, got.adaptive) == (want.max_rounds, want.tol, want.adaptive)
    pol = dynamic.RoundPolicy(3, 0.5)
    assert dynamic.make_round_policy(pol) is pol and dynamic.make_round_policy(None) is None
    for spec, err in (("adaptive:0.1", ValueError), ("sometimes", ValueError), ("fixed:0", ValueError),
                      ("adaptive:0:3", ValueError), (1.5, TypeError)):
        with pytest.raises(err):
            dynamic.make_round_policy(spec)
