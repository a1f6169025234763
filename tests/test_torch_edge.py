"""The sparse edge-list consensus path (``path="edge"``) against the reference.

* the edge tables, ``max_in_degree``, the Metropolis edge weights and the
  CSR tables bit for bit, on static graphs and on the reference's churn
  edge lists (padding, isolated agents);
* ``drt_edge_mixing`` / ``edge_mixing_dense`` against the reference, and
  the edge factorization against the port's dense eqs. 12-14;
* the plain versions of ``slab_edge_encode_combine`` and
  ``slab_edge_combine`` against the Pallas kernels in interpret mode (tiny
  trees), every mode x algorithm, with ``dst_base`` halves;
* round-sets per codec x algorithm through ``gather_consensus_rounds``
  against the reference's jnp edge round, which it holds equal to its
  kernel round (out 1e-5, A 1e-6, exact and top-k bit-identical);
* a K=4 ResNet-20 DRT edge epoch against the reference's.

Distances here are direct differences (x_src - x_dst)^2, not differences of
Gram entries, so the tolerances are plain f32 ones, relative to the values
themselves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as ref_consensus
from repro.core import decentralized as ref_dec
from repro.core import drt as ref_drt
from repro.core import dynamic as ref_dynamic
from repro.core import topology as ref_topology
from repro.kernels import slab_segment as ref_slab_segment
from repro.models import resnet as ref_resnet
from repro.obs import ObsConfig as RefObsConfig
from repro.optim import optimizers as ref_optim
from repro.utils.pytree import LayerPartition as RefLayerPartition
from repro_torch import bridge, experiment
from repro_torch.comm import prng
from repro_torch.core import consensus, drt, dynamic
from repro_torch.core.decentralized import DecentralizedTrainer, TrainerConfig
from repro_torch.core.drt import DRTConfig
from repro_torch.core.topology import make_topology, ring
from repro_torch.data.cifar_like import CifarLike, CifarLikeConfig, agent_minibatches
from repro_torch.kernels import slab_segment
from repro_torch.models import resnet
from repro_torch.obs.metrics import ObsConfig
from repro_torch.optim import optimizers
from repro_torch.utils.pytree import LayerPartition, agent_template, tree_items

torch.set_num_threads(1)
K = 8
NB, L = 4, 3  # kernel-level tests: 4 column blocks over 3 layers
BLOCK_LAYER = np.array([0, 1, 1, 2], np.int32)
MODES = ["exact", "int8", "bf16", "f16", "sent"]
CODECS = [None, "int8", "bf16", "f16", "topk:0.25"]


def _churn():
    """The reference's churn schedule of tests/test_edge.py: agents and
    edges dropped at random over a ring/hypercube cycle."""
    return ref_dynamic.ChurnSchedule(
        ref_dynamic.PeriodicSchedule((ref_topology.ring(K), ref_topology.hypercube(K))),
        agent_drop=0.25, edge_drop=0.1, seed=5,
    )


def _isolated_round():
    """(src, dst, w) numpy of the first churn round that isolates an agent
    and carries padding, that agent and the round's index."""
    src, dst, w = _churn()._edge_table
    for t in range(src.shape[0]):
        deg = np.bincount(dst[t][w[t] > 0], minlength=K)
        if (deg == 0).any() and (w[t] == 0).any():
            return (src[t], dst[t], w[t]), int(np.argmax(deg == 0)), t
    raise AssertionError("the churn schedule isolates no agent")


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


# -- tables ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ring", "chain", "hypercube", "churn"])
def test_edge_tables_csr_and_metropolis_match_reference_bit_for_bit(name):
    if name == "churn":
        ref_sched = _churn()
        tables = ref_sched._edge_table
    else:
        ref_sched = ref_dynamic.StaticSchedule(ref_topology.make_topology(name, K))
        sched = dynamic.StaticSchedule(make_topology(name, K))
        tables = sched._edge_table
        for a, b in zip(tables, ref_sched._edge_table):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert sched.max_edges == ref_sched.max_edges
        assert sched.max_in_degree == ref_sched.max_in_degree
        assert dynamic.max_in_degree_from_topology(make_topology(name, K)) == ref_sched.max_in_degree
        got = dynamic.edge_stacks_from_topology(make_topology(name, K), 3, "cpu")
        want = ref_dynamic.edge_stacks_from_topology(ref_topology.make_topology(name, K), 3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dmax = ref_sched.max_in_degree
    ref_fn = jax.jit(lambda s, d, w: (
        ref_dynamic.csr_from_edges(s, d, w, K, dmax), ref_dynamic.metropolis_edge_weights(s, d, w, K)
    ))
    src, dst, w = tables
    for t in range(min(src.shape[0], 6)):
        (r_csr, r_met) = ref_fn(src[t], dst[t], w[t])
        csr = dynamic.csr_from_edges(*_t(src[t], dst[t], w[t]), K, dmax)
        for a, b in zip(csr, r_csr):
            assert a.dtype == {np.dtype(bool): torch.bool}.get(np.asarray(b).dtype, torch.int32)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(dynamic.metropolis_edge_weights(*_t(src[t], dst[t], w[t]), K), r_met):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- edge factors -----------------------------------------------------------------


@pytest.mark.parametrize("weight_mode", ["paper", "exact_grad"])
def test_drt_edge_mixing_matches_reference_and_the_dense_pipeline(weight_mode):
    """On a padded churn round with an isolated agent: the factors within
    1e-6 of the reference's (f32 log/exp in another library), the dense
    form of the reference's own factors bit for bit, and the port's edge
    factorization equal to its dense eqs. 12-14 on the realized graph
    within 1e-6 (both from the same points)."""
    (src, dst, w), iso, _ = _isolated_round()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(L, K, 16)).astype(np.float32)
    n2 = np.square(x).sum(-1)
    d2 = np.square(x[:, :, None] - x[:, None, :]).sum(-1).astype(np.float32)  # (L, K, K)
    d2e = d2[:, src, dst] * (w > 0)
    cfg = DRTConfig(weight_mode=weight_mode)
    ref_cfg = ref_drt.DRTConfig(weight_mode=weight_mode)
    r_self, r_e = jax.jit(lambda *a: ref_drt.drt_edge_mixing(*a, ref_cfg, K))(d2e, n2, src, dst, w)
    A_self, A_e = drt.drt_edge_mixing(*_t(d2e, n2, src, dst, w), cfg, K)
    np.testing.assert_allclose(A_self.numpy(), np.asarray(r_self), rtol=0, atol=1e-6)
    np.testing.assert_allclose(A_e.numpy(), np.asarray(r_e), rtol=0, atol=1e-6)
    assert torch.all(A_self[:, iso] == 1.0) and torch.all(A_e[:, torch.from_numpy(w) == 0] == 0.0)

    r_dense = ref_drt.edge_mixing_dense(r_self, r_e, src, dst, w, K)
    got = drt.edge_mixing_dense(*_t(np.asarray(r_self), np.asarray(r_e), src, dst, w), K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(r_dense))

    adj = np.zeros((K, K), np.float32)
    adj[src[w > 0], dst[w > 0]] = 1.0
    C = torch.from_numpy(np.where(np.eye(K) > 0, 1.0, adj).astype(np.float32))
    dense = drt.drt_mixing_matrices(torch.from_numpy(d2), torch.from_numpy(n2), C, cfg)
    edge = drt.edge_mixing_dense(A_self, A_e, *_t(src, dst, w), K)
    torch.testing.assert_close(edge, dense, rtol=0, atol=1e-6)


# -- kernel plain versions against the Pallas kernels ----------------------------


def _kernel_operands(seed):
    """A self slab, a neighbours' slab, an int8 wire and a top-k-like sent
    slab of K agents over NB blocks, seeded."""
    rng = np.random.default_rng(seed)
    D = NB * slab_segment.LANES
    slab = rng.normal(size=(K, D)).astype(np.float32)
    q = rng.integers(-127, 128, size=(K, D)).astype(np.int8)
    col_seg = np.sort(rng.integers(0, 3, D)).astype(np.int32)
    scales = rng.uniform(0.005, 0.02, size=(K, 3)).astype(np.float32)
    sent = np.where(np.abs(slab) > 1.0, slab, 0.0).astype(np.float32)
    return slab, q, scales, col_seg, sent


def _wires(slab, q, scales, col_seg, sent):
    """Per mode: (the reference's wire operands, the port's)."""
    hf = slab.astype(np.float16)
    return {
        "exact": ((slab,), _t(slab)),
        "int8": ((q, scales, col_seg.reshape(NB, -1)), _t(q, scales, col_seg)),
        # both casts round to nearest even: the same bits
        "bf16": ((jnp.asarray(slab).astype(jnp.bfloat16),), (torch.from_numpy(slab).to(torch.bfloat16),)),
        "f16": ((hf,), _t(hf)),
        "sent": ((sent,), _t(sent)),
    }


@pytest.fixture(scope="module")
def pallas_edge_rounds():
    """The reference's Pallas edge kernels (interpret mode, one jitted
    program) on a padded churn round with an isolated agent:
    ``{(kernel, mode, algorithm): (out, A_self, A_e)}``."""
    (src, dst, w), _, _ = _isolated_round()
    ops = _kernel_operands(seed=1)
    slab, sent = ops[0], ops[4]
    wires = _wires(*ops)
    dmax = _churn().max_in_degree
    common = dict(num_layers=L, kappa=1e-6, N_clip=2.0 * K, weight_mode="paper", interpret=True)

    def run(src, dst, w):
        nbr, pos, valid, _ = ref_dynamic.csr_from_edges(src, dst, w, K, dmax)
        out = {}
        for algo in ("drt", "classical"):
            for mode in MODES:
                out["csr", mode, algo] = ref_slab_segment.slab_edge_encode_combine(
                    BLOCK_LAYER, slab, wires[mode][0], src, dst, w, nbr, pos, valid,
                    mode=mode, algorithm=algo, **common,
                )
            out["scatter", "sent", algo] = ref_slab_segment.slab_edge_combine(
                BLOCK_LAYER, slab, sent, src, dst, w, algorithm=algo, **common
            )
        return out

    return (src, dst, w), ops, wires, dmax, jax.jit(run)(src, dst, w)


@pytest.mark.parametrize("algorithm", ["drt", "classical"])
@pytest.mark.parametrize("mode", MODES)
def test_edge_encode_combine_plain_version_matches_pallas(pallas_edge_rounds, mode, algorithm):
    """out within 1e-5 and the factors within 1e-6 of the Pallas kernel.
    For the f32 wires (exact, sent) the combine fed the kernel's own factors
    is one rounding per slot from its output: XLA contracts ``acc + a x``
    into one fused multiply-add, the port rounds the product and the sum
    (as its CUDA kernel does, bit for bit: chip_smoke.py), so 5e-7 on O(1)
    values.  Two destination halves (``dst_base``) joined are the whole,
    bit for bit."""
    (src, dst, w), ops, wires, dmax, ref = pallas_edge_rounds
    r_out, r_self, r_e = ref["csr", mode, algorithm]
    edges = _t(src, dst, w)
    csr = dynamic.csr_from_edges(*edges, K, dmax)
    bl, slab = _t(BLOCK_LAYER, ops[0])
    kw = dict(mode=mode, algorithm=algorithm, num_layers=L, N_clip=2.0 * K)
    before = slab_segment.slab_edge_encode_combine.launches
    out, A_self, A_e = slab_segment.slab_edge_encode_combine(bl, slab, wires[mode][1], *edges, *csr[:3], **kw)
    assert slab_segment.slab_edge_encode_combine.launches == before  # CPU: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(A_self.numpy(), np.asarray(r_self), rtol=0, atol=1e-6)
    np.testing.assert_allclose(A_e.numpy(), np.asarray(r_e), rtol=0, atol=1e-6)
    if mode in ("exact", "sent"):
        dec = slab_segment.decode_wire_ref(mode, wires[mode][1])
        same_A = slab_segment.csr_combine_ref(bl, slab, dec, *csr[:3], *_t(np.asarray(r_self), np.asarray(r_e)))
        np.testing.assert_allclose(same_A.numpy(), np.asarray(r_out), rtol=0, atol=5e-7)
    h = K // 2
    halves = [
        slab_segment.slab_edge_encode_combine(
            bl, slab[b : b + h], wires[mode][1], *edges, *(t[b : b + h] for t in csr[:3]), b, **kw
        )
        for b in (0, h)
    ]
    assert torch.equal(torch.cat([o for o, _, _ in halves]), out)
    assert all(torch.equal(a_s, A_self) and torch.equal(a_e, A_e) for _, a_s, a_e in halves)


@pytest.mark.parametrize("algorithm", ["drt", "classical"])
def test_edge_combine_plain_version_matches_pallas(pallas_edge_rounds, algorithm):
    """The scatter round over a decoded slab that is not the self slab:
    out 1e-5, factors 1e-6; with the kernel's factors the scatter combine
    (edge-list order) is one rounding per edge from it (XLA's fused
    multiply-add, as above): 5e-7."""
    (src, dst, w), ops, _, _, ref = pallas_edge_rounds
    r_out, r_self, r_e = ref["scatter", "sent", algorithm]
    bl, slab, dec = _t(BLOCK_LAYER, ops[0], ops[4])
    edges = _t(src, dst, w)
    out, A_self, A_e = slab_segment.slab_edge_combine(
        bl, slab, dec, *edges, algorithm=algorithm, num_layers=L, N_clip=2.0 * K
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(A_self.numpy(), np.asarray(r_self), rtol=0, atol=1e-6)
    np.testing.assert_allclose(A_e.numpy(), np.asarray(r_e), rtol=0, atol=1e-6)
    from repro_torch.core import packing

    same_A = packing.edge_combine(*_t(np.asarray(r_self), np.asarray(r_e)), *edges[:2], slab, dec, bl)
    np.testing.assert_allclose(same_A.numpy(), np.asarray(r_out), rtol=0, atol=5e-7)


# -- round-sets ---------------------------------------------------------------------


def _tiny_agents(seed, n=K):
    """A tiny tree (reference layout): a stacked group with a conv leaf and
    a per-slot scale leaf, a plain group and a plain conv group."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.normal(size=(n, *shape)).astype(np.float32)

    return {
        "blocks": {"conv1": 0.3 * r(2, 3, 3, 8, 8), "gn_w": 1.0 + 0.3 * r(2, 8)},
        "head": {"b": 0.3 * r(5), "w": 0.3 * r(8, 5)},
        "stem": {"conv": 0.3 * r(3, 3, 3, 8)},
    }


def _churn_edges(rounds):
    """The reference's churn edge stacks from the first round that isolates
    an agent, and their CSR bound."""
    sched = _churn()
    return sched.edge_stacks(_isolated_round()[2], rounds), sched.max_in_degree


def _port_edges(ref_edges):
    return dynamic.EdgeStacks(*(torch.from_numpy(np.array(a)) for a in ref_edges))


def _max_err(port_tree, ref_tree):
    got = list(tree_items(bridge.params_to_jax(port_tree)))
    want = list(tree_items(jax.tree.map(np.asarray, ref_tree)))
    assert [p for p, _ in got] == [p for p, _ in want]
    return max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(got, want))


ROUND_CASES = [(codec, algo, True) for codec in CODECS for algo in ("drt", "classical")] + [
    (None, "drt", False), ("int8", "classical", False),
]


@pytest.fixture(scope="module")
def reference_edge_rounds():
    """The reference's edge round-sets (its jnp round, one jitted program)
    from the tiny tree over 2 churn rounds: ``{(codec, algorithm, csr):
    output tuple}``; ``csr`` False runs its scatter round."""
    ref_K = _tiny_agents(seed=2)
    part = RefLayerPartition.build(jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), ref_K))
    edges, dmax = _churn_edges(2)
    C = jnp.asarray(ref_topology.ring(K).c_matrix(), jnp.float32)
    M = jnp.asarray(ref_topology.ring(K).metropolis(), jnp.float32)
    fn = jax.jit(lambda psi: {
        (str(codec), algo, csr): ref_consensus.gather_consensus_rounds(
            part, psi, C, ref_drt.DRTConfig(), metropolis=M, rounds=2, algorithm=algo, codec=codec,
            rng=jax.random.key(7) if codec else None, path="edge", edges=edges,
            max_in_degree=dmax if csr else None,
        )
        for codec, algo, csr in ROUND_CASES
    })
    return ref_K, edges, dmax, fn(ref_K)


@pytest.mark.parametrize("codec,algorithm,csr", ROUND_CASES)
def test_edge_round_set_matches_reference(reference_edge_rounds, codec, algorithm, csr):
    """Two churn rounds (the graph changes between them; padding and an
    isolated agent included).  The wire of round 1 is identical (int8 bit
    for bit: test_torch_comm); round 2 sees f32 sum-order differences in
    the iterates only, which a rounding codec (int8, bf16, f16) can turn
    into the neighbouring wire value for a few elements: one wire step
    (int8 <= 1.5 max|x| / 127, bf16 max|x| 2^-7, f16 max|x| 2^-10) times a
    weight <= 1.  So: out 1e-5, A 1e-6, the top-k residual 1e-6; for the
    rounding codecs out within one step and beyond 1e-5 in < 1% of the
    elements, A 1e-4.  Exact rounds carry no codec state."""
    ref_K, edges, dmax, ref = reference_edge_rounds
    r = ref[str(codec), algorithm, csr]
    port_K = bridge.params_from_jax(ref_K, device="cpu")
    part = LayerPartition.build(agent_template(port_K))
    C = ring(K).c_matrix()
    out = consensus.gather_consensus_rounds(
        part, port_K, C, DRTConfig(), rounds=2, algorithm=algorithm, codec=codec,
        rng=prng.key(7) if codec else None, path="edge", edges=_port_edges(edges),
        max_in_degree=dmax if csr else None,
    )
    assert len(out) == (3 if codec else 2)
    x_max = max(float(np.abs(x).max()) for _, x in tree_items(ref_K))
    step = {"int8": 1.5 * x_max / 127.0, "bf16": x_max * 2.0**-7, "f16": x_max * 2.0**-10}.get(codec)
    if step is not None:
        got = np.concatenate([a.ravel() for _, a in tree_items(bridge.params_to_jax(out[0]))])
        want = np.concatenate([np.asarray(b).ravel() for _, b in tree_items(r[0])])
        d = np.abs(got - want)
        assert d.max() <= step and (d > 1e-5).mean() < 0.01, (d.max(), (d > 1e-5).mean())
        np.testing.assert_allclose(out[1].numpy(), np.asarray(r[1]), rtol=0, atol=1e-4)
    else:
        assert _max_err(out[0], r[0]) <= 1e-5
        np.testing.assert_allclose(out[1].numpy(), np.asarray(r[1]), rtol=0, atol=1e-6)
    if codec == "topk:0.25":
        assert _max_err(out[2], r[2]) <= 1e-6
    elif codec is not None:
        assert out[2] == () and r[2] == ()


def _resnet_agents(seed, spread, n=4):
    p0 = bridge.params_to_jax(resnet.init_resnet20(torch.Generator().manual_seed(seed), width=4))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: x[None] + spread * rng.normal(size=(n, *x.shape)).astype(np.float32), p0)


def test_three_int8_edge_rounds_within_quantization_steps():
    """3 int8 DRT rounds on a K=8 hypercube of the tiny tree: after round 1
    the sides differ by f32 sum order, which can flip a stochastic
    rounding; a flip moves one wire value by one step s <= s_max and mixing
    is convex, so every difference is <= 3 s_max, in under 2% of the
    columns."""
    ref_K = _tiny_agents(seed=3)
    topo, ref_topo = make_topology("hypercube", K), ref_topology.hypercube(K)
    part = RefLayerPartition.build(jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), ref_K))
    new_r, A_r, _ = jax.jit(lambda psi: ref_consensus.gather_consensus_rounds(
        part, psi, jnp.asarray(ref_topo.c_matrix(), jnp.float32), ref_drt.DRTConfig(), rounds=3,
        codec="int8", rng=jax.random.key(11), path="edge",
        edges=ref_dynamic.edge_stacks_from_topology(ref_topo, 3),
        max_in_degree=ref_dynamic.max_in_degree_from_topology(ref_topo),
    ))(ref_K)
    port_K = bridge.params_from_jax(ref_K, device="cpu")
    new, A, _ = consensus.gather_consensus_rounds(
        LayerPartition.build(agent_template(port_K)), port_K, topo.c_matrix(), DRTConfig(), rounds=3,
        codec="int8", rng=prng.key(11), path="edge", edges=dynamic.edge_stacks_from_topology(topo, 3),
        max_in_degree=dynamic.max_in_degree_from_topology(topo),
    )
    s_max = 1.1 * max(float(np.abs(x).max()) for _, x in tree_items(ref_K)) / 127.0
    cols = n_cols = 0
    for (_, a), (_, b) in zip(tree_items(bridge.params_to_jax(new)), tree_items(jax.tree.map(np.asarray, new_r))):
        d = np.abs(a - b).reshape(K, -1)
        assert d.max() <= 3 * s_max, (d.max(), s_max)
        cols += int((d > 1e-5).any(axis=0).sum())
        n_cols += d.shape[1]
    assert cols <= 0.02 * n_cols, (cols, n_cols)
    np.testing.assert_allclose(A.numpy(), np.asarray(A_r), rtol=0, atol=1e-4)


def test_edge_rounds_equal_dense_rounds_on_the_same_graph():
    """The reference's own property: the edge path equals the dense slab
    path on the realized graph.  Three exact DRT rounds, and three bf16
    classical rounds, on a K=4 ring of width-4 ResNet-20s: the dense
    exact path's distances are differences of Gram entries (error ~ eps
    mean_k ||x_k||^2), so the weights agree to 1e-4 relative, the
    parameters to 5e-6."""
    ref_K = _resnet_agents(seed=6, spread=0.3)
    port_K = bridge.params_from_jax(ref_K, device="cpu")
    part = LayerPartition.build(agent_template(port_K))
    topo = ring(4)
    edge_kw = dict(path="edge", edges=dynamic.edge_stacks_from_topology(topo, 3),
                   max_in_degree=dynamic.max_in_degree_from_topology(topo))
    for kw in (dict(algorithm="drt"), dict(algorithm="classical", codec="bf16")):
        dense = consensus.gather_consensus_rounds(
            part, port_K, topo.c_matrix(), DRTConfig(), rounds=3, metropolis=topo.metropolis(), **kw
        )
        edge = consensus.gather_consensus_rounds(
            part, port_K, topo.c_matrix(), DRTConfig(), rounds=3, **kw, **edge_kw
        )
        torch.testing.assert_close(edge[1], dense[1], rtol=1e-4, atol=1e-6)
        for (_, a), (_, b) in zip(tree_items(edge[0]), tree_items(dense[0])):
            torch.testing.assert_close(a, b, rtol=0, atol=5e-6)


def test_edge_epoch_matches_reference():
    """The slice end to end: 3 local momentum-SGD steps per agent, then 3
    exact DRT edge rounds, K=4 ring, width-4 ResNet-20, from the same
    weights.  The local steps agree to conv rounding (~1e-6); the edge
    rounds add f32 sum-order differences only: loss 1e-5, parameters 1e-5.
    Both sides read the disagreement off the output slab, so it moves with
    the parameter difference E: ``|sqrt(K dis) - sqrt(K dis_ref)| <=
    ||E||_F``."""
    ref_K = _resnet_agents(seed=5, spread=0.02)
    data = CifarLike(CifarLikeConfig(image_size=8, noise=0.1, max_shift=0))
    batches = agent_minibatches(data.paper_partition(num_agents=4, min_samples=24, max_samples=30, seed=1), 8, 0)
    ref_tr = ref_dec.DecentralizedTrainer(
        lambda p, b, rng: ref_resnet.resnet20_loss(p, b), lambda key: None,
        ref_optim.momentum(0.05, 0.9), ref_topology.ring(4),
        ref_dec.TrainerConfig(algorithm="drt", consensus_steps=3, consensus_path="edge"),
    )
    p = jax.tree.map(jnp.asarray, ref_K)
    ref_tr.build_partition(p)
    ref_st = ref_dec.DecentralizedState(p, ref_tr.optimizer.init(p), jnp.zeros((), jnp.int32), ())
    ref_st, ref_m = jax.jit(ref_tr.epoch)(ref_st, jax.tree.map(jnp.asarray, batches), jax.random.key(0))

    tr = DecentralizedTrainer(
        resnet.resnet20_agent_losses, lambda g: resnet.init_resnet20(g, width=4),
        optimizers.momentum(0.05, 0.9), ring(4),
        TrainerConfig(algorithm="drt", consensus_steps=3, consensus_path="edge"), device="cpu",
    )
    st, m = tr.epoch(tr.state_from_params(bridge.params_from_jax(ref_K, device="cpu")), batches)
    assert st.step == int(ref_st.step) == 3
    assert abs(float(m["loss"]) - float(ref_m["loss"])) < 1e-5
    assert float(m["effective_rounds"]) == float(ref_m["effective_rounds"]) == 3.0
    assert _max_err(st.params, ref_st.params) <= 1e-5
    diff = sum(
        float(np.square(a - b).sum())
        for (_, a), (_, b) in zip(tree_items(bridge.params_to_jax(st.params)),
                                  tree_items(jax.tree.map(np.asarray, ref_st.params)))
    )
    gap = abs(np.sqrt(4 * float(m["disagreement"])) - np.sqrt(4 * float(ref_m["disagreement"])))
    assert gap <= np.sqrt(diff) + 1e-6, (gap, diff)


# -- the path's wiring --------------------------------------------------------------


def test_edge_path_never_calls_the_dense_kernels(monkeypatch):
    """Exact and coded edge rounds, with and without CSR tables, go through
    the edge wrappers once per round and never through ``slab_combine`` or
    ``slab_encode_combine``; telemetry reads the output slab."""
    def refuse(*a, **k):
        raise AssertionError("the edge path called a dense kernel wrapper")

    calls = {"encode": 0, "scatter": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(consensus, "slab_combine", refuse)
    monkeypatch.setattr(consensus, "slab_encode_combine", refuse)
    monkeypatch.setattr(consensus, "slab_edge_encode_combine", spy("encode", slab_segment.slab_edge_encode_combine))
    monkeypatch.setattr(consensus, "slab_edge_combine", spy("scatter", slab_segment.slab_edge_combine))
    port_K = bridge.params_from_jax(_tiny_agents(seed=3, n=4), device="cpu")
    part = LayerPartition.build(agent_template(port_K))
    topo = ring(4)
    edges = dynamic.edge_stacks_from_topology(topo, 3)
    for codec in (None, "int8", "topk:0.1"):
        for dmax in (2, None):
            out = consensus.gather_consensus_rounds(
                part, port_K, topo.c_matrix(), DRTConfig(), rounds=3, codec=codec,
                rng=prng.key(1), path="edge", edges=edges, max_in_degree=dmax, obs=ObsConfig(),
            )
            m = out[-1]
            assert m.effective_rounds.tolist() == [1.0, 2.0, 3.0]
            if codec is None:
                assert float(m.disagreement[-1]) < float(m.disagreement[0])
    assert calls == {"encode": 9, "scatter": 9}


def test_edge_padding_is_inert_and_an_isolated_agent_keeps_its_iterate():
    """Extra padding entries change no bit; on the churn round that isolates
    an agent, that agent's parameters come back unchanged."""
    (src, dst, w), iso, _ = _isolated_round()
    port_K = bridge.params_from_jax(_tiny_agents(seed=4), device="cpu")
    part = LayerPartition.build(agent_template(port_K))
    C = ring(K).c_matrix()
    one = dynamic.EdgeStacks(*(t[None] for t in _t(src, dst, w)))
    padded = dynamic.EdgeStacks(*(torch.nn.functional.pad(t, (0, 5)) for t in one))
    dmax = _churn().max_in_degree
    outs = [
        consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), path="edge", edges=e,
                                          max_in_degree=dmax)[0]
        for e in (one, padded)
    ]
    for (_, a), (_, b), (_, x) in zip(tree_items(outs[0]), tree_items(outs[1]), tree_items(port_K)):
        assert torch.equal(a, b)
        assert torch.equal(a[iso], x[iso])


def test_edge_path_options_and_refusals():
    port_K = bridge.params_from_jax(_tiny_agents(seed=5, n=4), device="cpu")
    part = LayerPartition.build(agent_template(port_K))
    C = ring(4).c_matrix()
    edges = dynamic.edge_stacks_from_topology(ring(4), 2)
    with pytest.raises(ValueError, match="edges"):
        consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), path="edge")
    with pytest.raises(ValueError, match="rounds"):
        consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), rounds=3, path="edge", edges=edges)
    with pytest.raises(ValueError, match="C must be"):
        consensus.gather_consensus_rounds(part, port_K, C[:3], DRTConfig(), rounds=2, path="edge", edges=edges)
    # per-round C stacks are accepted (only shape-checked) on the edge path
    consensus.gather_consensus_rounds(part, port_K, np.stack([C, C]), DRTConfig(), rounds=2,
                                      path="edge", edges=edges)
    # trust reweighting runs on the edge path (reweight_edge between the two
    # launches) and gives the dense path's reweight_dense on the same graph
    got = consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), rounds=2, path="edge", edges=edges,
                                            trust_clip=0.3)[0]
    want = consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), rounds=2, trust_clip=0.3)[0]
    for (_, a), (_, b) in zip(tree_items(got), tree_items(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    assert TrainerConfig(consensus_path="tree").consensus_path == "tree"  # the per-leaf oracle
    with pytest.raises(ValueError):
        TrainerConfig(consensus_path="sparse")
    assert experiment.parse_args([]).consensus_path == "slab"
    assert experiment.parse_args(["--consensus-path", "edge"]).consensus_path == "edge"
    assert experiment.parse_args(["--consensus-path", "tree"]).consensus_path == "tree"
    with pytest.raises(SystemExit):
        experiment.parse_args(["--consensus-path", "sparse"])
