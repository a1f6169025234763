"""Byzantine fault injection and trust-robust consensus, against the reference.

* The host tables (``ByzantineMask``, ``StaleMask``, ``DropSchedule``'s
  dense and edge views) and the threefry draws (``random_bits``,
  ``uniform``): bit for bit; ``normal`` within ``prng.NORMAL_ULPS`` f32
  ulps of ``jax.random.normal``.
* The attacks on the slab (each group the reference's region, lane
  padding included, columns mapped through ``layout.region_maps_on``) and
  on the tree: sign flip, scale and constant bit for bit; gauss and cgauss
  within ``NORMAL_ULPS`` ulps of the noise plus one rounding of the sum.
* ``reweight_dense`` / ``reweight_local`` (1e-6; ``p ** (1/temp)`` and the
  column sums are libm and summation-order apart), ``support_uniform``,
  the median combine (bit for bit: a sort and rank weights of 0 or 1/2),
  the trimmed mean (XLA's dot chains fused multiply-adds: within n_k
  roundings of max|x|), ``suspicion_from_A`` and
  ``byzantine_weight_mass`` (1e-6).
* ``gather_consensus_rounds`` under a 25% sign-flip mask and the trust
  knobs: exact and int8, DRT and classical, median, trust-only (the exact
  Gram path and the coded per-round body), stale delivery with top-k and a
  gauss attack, one case over a churn schedule with momentum, and the tree
  path exact and int8; K=8, 3 rounds, the reference's cases in one jitted
  program.  Tolerances as the existing round-set tests: parameters 1e-5
  (exact slab 5e-6) plus one f32 rounding of |x| a round under momentum
  (XLA's fused multiply-add), int8 in quantization steps (a flipped
  rounding moves one wire value by one step), A 1e-6, the disagreement
  1e-6 of mean_k ||x_k||^2, suspicion and the Byzantine mass 1e-5.
* ``PermuteConsensus`` with ``trust_clip`` (slab and tree paths, K=4)
  against the gather engine with the same knob (1e-5).
* The edge path under faults, stale delivery and the trust knobs against
  the dense slab path, the reference's ``ValueError`` s, and a trainer epoch
  with ``byzantine=0.25, fault_model="sign_flip", trust_clip=0.15`` and
  message drop against the reference trainer's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as ref_faults
from repro.core import consensus as ref_consensus
from repro.core import decentralized as ref_dec
from repro.core import dynamic as ref_dynamic
from repro.core import packing as ref_packing
from repro.core import topology as ref_topology
from repro.core.drt import DRTConfig as RefDRTConfig
from repro.obs import ObsConfig as RefObsConfig
from repro.obs import metrics as ref_metrics
from repro.optim import optimizers as ref_optim
from repro.utils.pytree import LayerPartition as RefLayerPartition
from repro_torch import PermuteConsensus, bridge, faults, spmd_run
from repro_torch.comm import prng
from repro_torch.core import consensus, dynamic, packing, topology
from repro_torch.core.decentralized import DecentralizedTrainer, TrainerConfig
from repro_torch.core.drt import DRTConfig
from repro_torch.obs import metrics
from repro_torch.obs.metrics import ObsConfig
from repro_torch.optim import optimizers
from repro_torch.utils.pytree import LayerPartition, agent_template, conv_to_reference_order, tree_items, tree_map

torch.set_num_threads(1)
K, ROUNDS, BETA, CLIP = 8, 3, 0.4, 0.15
F32_EPS = 2.0**-23


def _tiny_agents(seed, k=K):
    """A tiny tree (reference layout): a stacked group with a conv leaf and
    a per-slot scale leaf, a plain group, and a plain conv group."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.normal(size=(k, *shape)).astype(np.float32)

    return {"blocks": {"conv1": 0.3 * n(2, 3, 3, 4, 4), "gn_w": 1.0 + 0.3 * n(2, 4)},
            "head": {"b": 0.3 * n(5), "w": 0.3 * n(4, 5)}, "stem": {"conv": 0.3 * n(3, 3, 3, 4)}}


def _ref_part(ref_K):
    return RefLayerPartition.build(jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), ref_K))


def _churn(d=dynamic, t=topology):
    return d.ChurnSchedule(d.PeriodicSchedule((t.ring(K), t.hypercube(K))), agent_drop=0.25, edge_drop=0.1, seed=5)


def _pairs(port_tree, ref_tree):
    """Leaf pairs (port -> reference layout, reference) as numpy arrays."""
    got = [(p, conv_to_reference_order(p, x.numpy())) for p, x in tree_items(port_tree)]
    want = list(tree_items(jax.tree.map(np.asarray, ref_tree)))
    assert [p for p, _ in got] == [p for p, _ in want]
    return [(a, b) for (_, a), (_, b) in zip(got, want)]


# -- host tables and draws -----------------------------------------------------------


def test_fault_tables_match_reference_bit_for_bit():
    for cyc in (1, 5):
        port, ref = faults.ByzantineMask(K, 0.25, seed=3, cycle=cyc), ref_faults.ByzantineMask(K, 0.25, seed=3, cycle=cyc)
        assert port.n_byzantine == ref.n_byzantine == 2
        for t in range(7):
            np.testing.assert_array_equal(port.mask_at(t), ref.mask_at(t))
        np.testing.assert_array_equal(port.mask_stacks(3, 4).numpy(), np.asarray(ref.mask_stacks(3, 4)))
    port, ref = faults.StaleMask(K, 0.3, seed=2, cycle=6), ref_faults.StaleMask(K, 0.3, seed=2, cycle=6)
    np.testing.assert_array_equal(port.mask_stacks(4, 5).numpy(), np.asarray(ref.mask_stacks(4, 5)))
    periodic = [(d.PeriodicSchedule((t.ring(K), t.hypercube(K)))) for d, t in ((dynamic, topology),
                                                                                (ref_dynamic, ref_topology))]
    for base, ref_base in ((dynamic.StaticSchedule(topology.ring(K)), ref_dynamic.StaticSchedule(ref_topology.ring(K))),
                           periodic):
        port, ref = faults.DropSchedule(base, 0.3, seed=4, cycle=8), ref_faults.DropSchedule(ref_base, 0.3, seed=4,
                                                                                                   cycle=8)
        for t in range(10):
            np.testing.assert_array_equal(port.topology_at(t).adjacency, ref.topology_at(t).adjacency)
        for a, b in zip(port.mixing_stacks(6, 4), ref.mixing_stacks(6, 4)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(port.edge_stacks(6, 4), ref.edge_stacks(6, 4)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert port.max_in_degree == ref.max_in_degree and port._host_edge_period() == ref._host_edge_period()


def test_threefry_draws_match_jax():
    """Bits and uniforms bit for bit; normals within NORMAL_ULPS ulps (and
    mostly equal)."""
    k, jk = prng.fold_in(prng.key(11), 5), jax.random.fold_in(jax.random.key(11), 5)
    shape = (3, 7, 130)
    np.testing.assert_array_equal(prng.random_bits(k, shape).numpy(),
                                  np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))
    np.testing.assert_array_equal(prng.uniform(k, shape).numpy(), np.asarray(jax.jit(
        lambda key: jax.random.uniform(key, shape))(jk)))
    got = prng.normal(k, (40_000,)).numpy()
    want = np.asarray(jax.jit(lambda key: jax.random.normal(key, (40_000,)))(jk))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= prng.NORMAL_ULPS and (ulps == 0).mean() > 0.9, (ulps.max(), (ulps == 0).mean())
    idx = torch.tensor([[5, 9000], [39_999, 0]])  # a draw is a function of its flat index
    np.testing.assert_array_equal(prng.normal_at(k, idx).numpy(), got[idx.numpy()])


# -- attacks ---------------------------------------------------------------------------

ATTACKS = ["sign_flip", "scale:-3", "constant:0.5", "gauss:0.5", "cgauss:0.5"]


def _check_publish(got, want, x, spec):
    """Deterministic attacks bit for bit; Gauss within NORMAL_ULPS ulps of
    the noise plus one rounding of the sum."""
    if spec.startswith(("gauss", "cgauss")):
        noise = np.abs(want - x)
        tol = F32_EPS * (prng.NORMAL_ULPS * noise + np.abs(want)) + 1e-30
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
        assert (got != x).any()
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec", ATTACKS)
def test_attacks_on_slab_and_tree_match_reference(spec):
    ref_K = _tiny_agents(seed=1)
    port_K = bridge.params_from_jax(ref_K, device="cpu")
    host = np.zeros(K, bool)
    host[[1, 6]] = True
    mask, ref_mask = torch.from_numpy(host), jnp.asarray(host)
    key, ref_key = prng.fold_in(prng.key(3), 2), jax.random.fold_in(jax.random.key(3), 2)
    model, ref_model = faults.make_fault_model(spec), ref_faults.make_fault_model(spec)
    assert model.name == ref_model.name
    # the slab: each group against the reference's region of the same index
    layout = packing.build_slab_layout(LayerPartition.build(agent_template(port_K)), agent_template(port_K))
    ref_layout = ref_packing.build_slab_layout(_ref_part(ref_K), jax.tree.map(lambda x: x[0], ref_K))
    slab = layout.pack(port_K)
    regions = list(ref_layout.pack_regions(ref_K))
    pad = int(layout.pad_cols_on(torch.device("cpu"))[-1])  # a value on the lane padding is attacked too
    slab[host, pad] = 0.25
    g = max(i for i, grp in enumerate(layout.groups) if grp.col0 <= pad)
    j, c = divmod(pad - layout.groups[g].col0, layout.groups[g].s_pad)
    regions[g] = regions[g].at[j, :, c].set(jnp.where(ref_mask, 0.25, 0.0))
    got = faults.apply_fault_regions(model, layout, slab, mask, key, rows=host)
    want = jax.jit(lambda rs: ref_faults.apply_fault_regions(ref_model, rs, ref_mask, ref_key))(tuple(regions))
    maps = layout.region_maps_on(torch.device("cpu"))
    for grp, reg, x in zip(layout.groups, want, regions):
        cols = slice(grp.col0, grp.col0 + grp.width)
        perm = (maps["slot"][cols] * grp.s_pad + maps["col"][cols]).numpy()  # place in the region's slot rows
        ref_view = np.asarray(reg).transpose(1, 0, 2).reshape(K, -1)[:, perm]
        x_view = np.asarray(x).transpose(1, 0, 2).reshape(K, -1)[:, perm]
        _check_publish(got[:, cols].numpy(), ref_view, x_view, spec)
    # the tree: each leaf in the reference's layout (a stacked conv leaf and
    # a plain one: the reference's noise program compiles leaf by leaf)
    tree = {"blocks": {"conv1": ref_K["blocks"]["conv1"]}, "head": {"w": ref_K["head"]["w"]}}
    got = faults.apply_fault_tree(model, bridge.params_from_jax(tree, device="cpu"), mask, key)
    want = jax.jit(lambda t: ref_faults.apply_fault_tree(ref_model, t, ref_mask, ref_key))(tree)
    for (a, b), (_, x) in zip(_pairs(got, want), tree_items(tree)):
        _check_publish(a, b, x, spec)


# -- reweighting, robust combines, metrics ------------------------------------------


def _stochastic(rng, L, k):
    A = rng.uniform(0.01, 1.0, size=(L, k, k)).astype(np.float32) * (rng.uniform(size=(1, k, k)) < 0.6)
    A = A + np.eye(k, dtype=np.float32)
    return (A / A.sum(1, keepdims=True)).astype(np.float32)


def test_reweighting_and_robust_combines_match_reference():
    rng = np.random.default_rng(4)
    A = _stochastic(rng, 3, K)
    for kw in (dict(clip=0.2), dict(temp=0.5), dict(clip=0.1, temp=2.0)):
        got = faults.reweight_dense(torch.from_numpy(A), **kw).numpy()
        np.testing.assert_allclose(got, np.asarray(jax.jit(lambda a: ref_faults.reweight_dense(a, **kw))(A)),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)
        w_self, w_nbrs = A[:, 0, 0], A[:, 1:5, 0].T.copy()
        w_nbrs[1] = 0.0  # a phantom pair stays 0
        got = faults.reweight_local(torch.from_numpy(w_self), torch.from_numpy(w_nbrs), **kw)
        want = jax.jit(lambda s, n: ref_faults.reweight_local(s, n, **kw))(w_self, w_nbrs)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
        assert not got[1][1].any()
    C = topology.ring(K).c_matrix().astype(np.float32)
    C[2, 3] = C[3, 2] = 1.0  # agent 2 and 3 with three neighbours
    np.testing.assert_array_equal(faults.support_uniform(torch.from_numpy(C), 3).numpy(),
                                  np.asarray(ref_faults.support_uniform(C, 3)))
    x = rng.normal(size=(K, 256)).astype(np.float32)
    x[1, :7] = x[2, :7]  # ties
    for spec in ("median", "trimmed:0.25"):
        kind, frac = faults.parse_combine(spec)
        assert (kind, frac) == ref_faults.parse_combine(spec)
        got = faults.robust_combine(torch.from_numpy(C), torch.from_numpy(x), kind, frac).numpy()
        want = np.asarray(jax.jit(lambda r: ref_faults.robust_combine(C, r, kind, frac))((x[None],))[0][0])
        if kind == "median":
            np.testing.assert_array_equal(got, want)
        else:  # XLA's dot chains fused multiply-adds: n_k <= 4 roundings of max|x| apart
            np.testing.assert_allclose(got, want, rtol=0, atol=4 * F32_EPS * float(np.abs(x).max()))
    byz = np.zeros(K, bool)
    byz[[0, 5]] = True
    got = metrics.suspicion_from_A(torch.from_numpy(A), torch.from_numpy(C))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_metrics.suspicion_from_A(A, C)), rtol=0, atol=1e-6)
    got = metrics.byzantine_weight_mass(torch.from_numpy(A), torch.from_numpy(byz))
    np.testing.assert_allclose(float(got), float(ref_metrics.byzantine_weight_mass(A, byz)), rtol=0, atol=1e-6)
    for bad in ("mean", "trimmed", "trimmed:0.5"):
        with pytest.raises(ValueError):
            faults.parse_combine(bad)


# -- round-sets ------------------------------------------------------------------------

# (name, path, codec, algorithm, fault spec or None, stale, gather keywords, schedule)
CASES = [
    ("exact-drt-clip", "slab", None, "drt", "sign_flip", 0.0, dict(trust_clip=CLIP), False),
    ("exact-classical", "slab", None, "classical", "sign_flip", 0.0, {}, False),
    ("int8-drt-clip", "slab", "int8", "drt", "sign_flip", 0.0, dict(trust_clip=CLIP), False),
    ("int8-classical-temp", "slab", "int8", "classical", "sign_flip", 0.0, dict(trust_temp=0.5), False),
    ("exact-median", "slab", None, "drt", "sign_flip", 0.0, dict(combine="median"), False),
    ("exact-clip-only", "slab", None, "drt", None, 0.0, dict(trust_clip=CLIP), False),
    ("int8-clip-only", "slab", "int8", "drt", None, 0.0, dict(trust_clip=CLIP), False),
    ("topk-stale-gauss", "slab", "topk:0.25", "drt", "gauss:0.3", 0.4, dict(trust_clip=CLIP), False),
    ("exact-churn-momentum", "slab", None, "drt", "sign_flip", 0.0, dict(trust_clip=CLIP, momentum=BETA), True),
    ("tree-exact-clip", "tree", None, "drt", "sign_flip", 0.0, dict(trust_clip=CLIP), False),
    ("tree-int8-clip", "tree", "int8", "drt", "sign_flip", 0.0, dict(trust_clip=CLIP), False),
]
IDS = [c[0] for c in CASES]


def _plan(pkg, fault, stale):
    return pkg.make_fault_plan(K, byzantine=0.25 if fault else 0.0, fault_model=fault, stale=stale, seed=1)


def _case_args(case, pkg, dyn, topo, key):
    """``(C, metropolis, keyword arguments)`` of a case for either package,
    without its faults."""
    _, path, codec, algo, _, _, extra, sched = case
    if sched:
        C, M = _churn(dyn, topo).mixing_stacks(4, ROUNDS)
    else:
        t = topo.ring(K)
        C, M = t.c_matrix(), t.metropolis()
    kw = dict(rounds=ROUNDS, algorithm=algo, metropolis=M, path=path, **extra)
    if codec:
        kw.update(codec=codec, rng=key)
    return C, kw


@pytest.fixture(scope="module")
def fault_cases():
    """The agents and the reference's round-sets, one jitted program."""
    ref_K = _tiny_agents(seed=2)
    port_K = bridge.params_from_jax(ref_K, device="cpu")
    part = _ref_part(ref_K)

    def run(psi):
        out = {}
        for case in CASES:
            C, kw = _case_args(case, None, ref_dynamic, ref_topology, jax.random.key(7))
            plan = _plan(ref_faults, case[4], case[5])
            res = ref_consensus.gather_consensus_rounds(
                part, psi, C, RefDRTConfig(), obs=RefObsConfig(),
                faults=None if plan is None else plan.realize(4, ROUNDS), **kw)
            new, A, st, m = res
            out[case[0]] = (new, A, st, m.disagreement, m.suspicion, m.byzantine_weight_mass)
        return out

    return ref_K, port_K, jax.jit(run)(ref_K)


def _port_case(port_K, case):
    C, kw = _case_args(case, faults, dynamic, topology, prng.key(7))
    plan = _plan(faults, case[4], case[5])
    part = LayerPartition.build(agent_template(port_K))
    return consensus.gather_consensus_rounds(
        part, port_K, C, DRTConfig(), obs=ObsConfig(),
        faults=None if plan is None else plan.realize(4, ROUNDS, "cpu"), **kw)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_faulted_round_sets_match_reference(fault_cases, case):
    ref_K, port_K, ref_out = fault_cases
    new_r, A_r, st_r, dis_r, sus_r, mass_r = ref_out[case[0]]
    out = _port_case(port_K, case)
    new, A, m = out[0], out[1], out[-1]
    codec = case[2]
    x_max = max(float(np.abs(x).max()) for _, x in tree_items(jax.tree.map(np.asarray, ref_K)))
    mom = ROUNDS * 2.0**-24 * x_max if "momentum" in case[6] else 0.0
    pairs = _pairs(new, new_r)
    if codec == "int8":
        step = x_max / 127.0 * 1.01
        for a, b in pairs:
            assert np.abs(a - b).max() <= ROUNDS * step + mom
        n_bad = sum(int((np.abs(a - b) > 1e-5).sum()) for a, b in pairs)
        assert n_bad <= 0.02 * sum(a.size for a, _ in pairs), n_bad
        A_tol = 1e-3
    else:
        tol = (5e-6 if case[1] == "slab" and codec is None else 1e-5) + mom
        for a, b in pairs:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol)
        A_tol = 1e-6
    np.testing.assert_allclose(A.numpy(), np.asarray(A_r), rtol=0, atol=A_tol)
    scale = sum(float(x.double().square().sum()) for _, x in tree_items(port_K)) / K
    np.testing.assert_allclose(m.disagreement.numpy(), np.asarray(dis_r), rtol=0,
                               atol=(1e-4 if codec == "int8" else 1e-6) * scale)
    np.testing.assert_allclose(m.suspicion.numpy(), np.asarray(sus_r), rtol=0, atol=10 * A_tol)
    np.testing.assert_allclose(m.byzantine_weight_mass.numpy(), np.asarray(mass_r), rtol=0, atol=10 * A_tol)
    assert m.suspicion.shape == (ROUNDS, K)
    if case[4] is not None:
        assert float(m.byzantine_weight_mass.max()) > 0.0
    if codec == "topk:0.25":
        for a, b in _pairs(out[2], st_r):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


# -- the permute engine ---------------------------------------------------------------


@pytest.mark.parametrize("path", ["slab", "tree"])
def test_permute_trust_clip_matches_gather_engine(path):
    """K=4 ring, 3 rounds, DRT exact with trust_clip (the gather engine's
    Gram path) and int8 with trust_temp on the slab path (the gather
    engine's coded per-round body): 1e-5, int8 in quantization steps."""
    k = 4
    ref_K = _tiny_agents(seed=5, k=k)
    pK = bridge.params_from_jax(ref_K, device="cpu")
    part = LayerPartition.build(agent_template(pK))
    t = topology.ring(k)
    cases = [(None, dict(trust_clip=0.3))] + ([("int8", dict(trust_temp=0.5))] if path == "slab" else [])
    for codec, knob in cases:
        eng = PermuteConsensus(part, t, DRTConfig(), codec=codec, path=path, **knob)
        outs = spmd_run(lambda r, ex: eng(tree_map(lambda x: x[r], pK), ex, rng=prng.key(9), rounds=3), k,
                        device="cpu")
        got = tree_map(lambda *xs: torch.stack(xs), *[o if codec is None else o[0] for o in outs])
        want = consensus.gather_consensus_rounds(part, pK, t.c_matrix(), DRTConfig(), rounds=3, codec=codec,
                                                 rng=prng.key(9), **knob)[0]
        x_max = max(float(x.abs().max()) for _, x in tree_items(pK))
        tol = 3 * x_max / 127.0 * 1.01 if codec else 1e-5
        for (_, a), (_, b) in zip(tree_items(got), tree_items(want)):
            assert float((a - b).abs().max()) <= tol, (codec, float((a - b).abs().max()))
        plain = consensus.gather_consensus_rounds(part, pK, t.c_matrix(), DRTConfig(), rounds=3, codec=codec,
                                                  rng=prng.key(9))[0]
        assert any(not torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(want), tree_items(plain)))
    bad = PermuteConsensus(part, t, DRTConfig(), path=path, trust_clip=1.5)
    with pytest.raises(ValueError, match="trust_clip"):
        spmd_run(lambda r, ex: bad(tree_map(lambda x: x[r], pK), ex), k, device="cpu")


# -- refusals, validation, the trainer -----------------------------------------------


def test_edge_path_refusals_and_validation():
    port_K = bridge.params_from_jax(_tiny_agents(seed=3), device="cpu")
    part = LayerPartition.build(agent_template(port_K))
    t = topology.ring(K)
    C = t.c_matrix()
    edges = dynamic.edge_stacks_from_topology(t, 2)
    real = _plan(faults, "sign_flip", 0.0).realize(0, 2)
    stale = _plan(faults, None, 0.5).realize(0, 2)
    # faults, stale delivery and the trust knobs run on the edge path: on the
    # full ring it gives the dense slab path's round-set
    for kw in (dict(faults=real), dict(faults=stale), dict(trust_clip=0.5), dict(trust_temp=2.0)):
        got = consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), rounds=2, path="edge", edges=edges,
                                                max_in_degree=2, **kw)[0]
        want = consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), rounds=2, **kw)[0]
        for (_, a), (_, b) in zip(tree_items(got), tree_items(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    # drop is a schedule: it runs on the edge path, over the dropped graphs
    drop = faults.DropSchedule(dynamic.StaticSchedule(t), 0.3, seed=2)
    Cd, Md = drop.mixing_stacks(0, 2)
    new, A = consensus.gather_consensus_rounds(part, port_K, Cd, DRTConfig(), rounds=2, metropolis=Md,
                                               path="edge", edges=drop.edge_stacks(0, 2), max_in_degree=2)
    dense = consensus.gather_consensus_rounds(part, port_K, Cd, DRTConfig(), rounds=2, metropolis=Md)[0]
    for (_, a), (_, b) in zip(tree_items(new), tree_items(dense)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    bad = [(dict(combine="median", path="tree"), "slab path"), (dict(combine="median", path="edge", edges=edges),
                                                                 "slab path"),
           (dict(faults=stale, path="tree"), "stale"), (dict(faults=real, rounds=3), "rounds, K"),
           (dict(faults=faults.FaultRealization(None, real.mask, None, real.key)), "fault model"),
           (dict(trust_clip=0.0), "trust_clip"), (dict(trust_temp=-1.0), "trust_temp"), (dict(combine="mean"), "combine")]
    for kw, match in bad:
        kw = {"rounds": 2, **kw}
        with pytest.raises(ValueError, match=match):
            consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), **kw)
    for kw in (dict(byzantine=0.25), dict(fault_model="sign_flip"), dict(byzantine=1.0, fault_model="sign_flip")):
        with pytest.raises(ValueError):
            faults.make_fault_plan(K, **kw)
    for kw in (dict(fault_model="gauss"), dict(trust_clip=2.0), dict(combine="trimmed:0.7"), dict(drop=1.0)):
        with pytest.raises(ValueError):
            TrainerConfig(**kw)
    assert faults.make_fault_plan(K) is None and _plan(faults, None, 0.5).realize(0, 2).mask is None


D_IN, HID, N_CLS, BATCH = 12, 8, 4, 8


def _mlp_params(seed):
    rng = np.random.default_rng(seed)
    return {"dense1": {"b": 0.1 * rng.normal(size=(K, HID)).astype(np.float32),
                       "w": 0.5 * rng.normal(size=(K, D_IN, HID)).astype(np.float32)},
            "dense2": {"b": 0.1 * rng.normal(size=(K, N_CLS)).astype(np.float32),
                       "w": 0.5 * rng.normal(size=(K, HID, N_CLS)).astype(np.float32)}}


def _port_losses(p, batch):
    h = torch.relu(torch.einsum("kbi,kio->kbo", batch["x"], p["dense1"]["w"]) + p["dense1"]["b"][:, None])
    logits = torch.einsum("kbi,kio->kbo", h, p["dense2"]["w"]) + p["dense2"]["b"][:, None]
    return torch.nn.functional.cross_entropy(logits.transpose(1, 2), batch["y"].long(), reduction="none").mean(1)


def _ref_loss(p, batch, rng):
    h = jax.nn.relu(batch["x"] @ p["dense1"]["w"] + p["dense1"]["b"])
    logits = h @ p["dense2"]["w"] + p["dense2"]["b"]
    return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), batch["y"][:, None], axis=1))


def test_trainer_epoch_under_sign_flip_trust_clip_and_drop_matches_reference():
    """Two local steps, then the round-set of step 2 (rounds 6-8) with 25%
    sign-flip agents, trust_clip 0.15 and 20% message drop: loss to 1e-6,
    parameters 1e-5, the disagreement 1e-6 of mean_k ||x_k||^2."""
    rng = np.random.default_rng(1)
    params = _mlp_params(0)
    batches = {"x": rng.normal(size=(2, K, BATCH, D_IN)).astype(np.float32),
               "y": rng.integers(0, N_CLS, size=(2, K, BATCH)).astype(np.int32)}
    cfg = dict(algorithm="drt", consensus_steps=3, byzantine=0.25, fault_model="sign_flip", fault_seed=2,
               trust_clip=CLIP, drop=0.2)
    tr = DecentralizedTrainer(_port_losses, None, optimizers.momentum(0.05, 0.9), topology.ring(K),
                              TrainerConfig(**cfg), device="cpu")
    assert isinstance(tr.schedule, faults.DropSchedule)
    st, m = tr.epoch(tr.state_from_params(tree_map(torch.from_numpy, params)), batches)
    ref_tr = ref_dec.DecentralizedTrainer(_ref_loss, lambda key: None, ref_optim.momentum(0.05, 0.9),
                                          ref_topology.ring(K), ref_dec.TrainerConfig(**cfg))
    ref_p = jax.tree.map(jnp.asarray, params)
    ref_tr.build_partition(ref_p)
    ref_st = ref_dec.DecentralizedState(ref_p, ref_tr.optimizer.init(ref_p), jnp.zeros((), jnp.int32), ())
    ref_st, ref_m = jax.jit(ref_tr.epoch)(ref_st, jax.tree.map(jnp.asarray, batches), jax.random.key(0))
    assert st.step == int(ref_st.step) == 2
    assert abs(float(m["loss"]) - float(ref_m["loss"])) < 1e-6
    for (_, a), (_, b) in zip(tree_items(st.params), tree_items(jax.tree.map(np.asarray, ref_st.params))):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)
    scale = sum(float(x.double().square().sum()) for _, x in tree_items(st.params)) / K
    assert abs(float(m["disagreement"]) - float(ref_m["disagreement"])) <= 1e-6 * scale
