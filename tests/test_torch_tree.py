"""The per-leaf tree oracle against the reference's, and the port's slab
path against the port's tree path.

* the per-leaf codecs' ``encode`` / ``decode`` (every codec) on the same
  single-agent trees and keys: int8 values and scales, the top-k wire and
  residual, the bf16 / f16 casts, all bit for bit;
* ``LayerPartition``'s per-layer algebra (norms, Gram distances, combine,
  per-layer scale) on a ResNet-20 of width 4;
* ``gather_consensus_step`` (one round, every codec, DRT and classical) and
  ``gather_consensus_rounds(path="tree")`` (3 rounds, every codec, DRT and
  classical, ring and hypercube, the top-k residual threaded through)
  against the reference's under ``jax.jit``;
* the port's slab path against its tree path on the reference's own
  slab-vs-tree tree (``tests/test_packing.py``), at the reference's own
  tolerance, 5e-6, and for f16 one f16 step at the leaf's magnitude;
* one ``TrainerConfig(consensus_path="tree")`` epoch against the reference
  trainer's.

Trees are tiny (K = 4, widths <= 8) and made with numpy (the slab-vs-tree
tree with ``jax.random``, as the reference's test makes it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import make_codec as ref_make_codec
from repro.core import consensus as ref_consensus
from repro.core import decentralized as ref_dec
from repro.core.drt import DRTConfig as RefDRTConfig
from repro.core.topology import ring as ref_ring
from repro.models import resnet as ref_resnet
from repro.obs import ObsConfig as RefObsConfig
from repro.optim import optimizers as ref_optim
from repro.utils.pytree import LayerPartition as RefLayerPartition
from repro_torch import bridge
from repro_torch.comm import prng
from repro_torch.comm.codec import QuantLeaf, make_codec
from repro_torch.core import consensus
from repro_torch.core.decentralized import DecentralizedTrainer, TrainerConfig
from repro_torch.core.drt import DRTConfig
from repro_torch.core.topology import hypercube, make_topology, ring
from repro_torch.data.cifar_like import CifarLike, CifarLikeConfig, agent_minibatches
from repro_torch.models import resnet
from repro_torch.obs.metrics import ObsConfig
from repro_torch.optim import optimizers
from repro_torch.utils.pytree import (
    LayerPartition,
    agent_template,
    conv_to_reference_order,
    tree_items,
    tree_map,
)

torch.set_num_threads(1)
K = 4
CODECS = [None, "int8", "bf16", "f16", "topk:0.25"]
TOPOLOGIES = {"ring": ring(K), "hypercube": hypercube(K)}
ROUNDS = 3


def _tiny_agents(seed):
    """A tiny tree (reference layout): a stacked group with a conv leaf
    above the top-k sample size (a strided threshold) and a per-slot scale
    leaf, a plain group, and a plain conv group."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.normal(size=(K, *shape)).astype(np.float32)

    return {
        "blocks": {"conv1": 0.3 * n(2, 3, 3, 8, 8), "gn_w": 1.0 + 0.3 * n(2, 8)},
        "head": {"b": 0.3 * n(5), "w": 0.3 * n(8, 5)},
        "stem": {"conv": 0.3 * n(3, 3, 3, 8)},
    }


def _ref_part(ref_K):
    return RefLayerPartition.build(jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), ref_K))


def _port(ref_K):
    port_K = bridge.params_from_jax(ref_K, device="cpu")
    return port_K, LayerPartition.build(agent_template(port_K))


def _to_ref_layout(path, x):
    """A port leaf (tensor, bf16 included) as a reference-layout f32-or-int
    numpy array."""
    x = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    return np.ascontiguousarray(conv_to_reference_order(path, x.numpy()))


def _ref_np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype in (jnp.bfloat16, np.float16) else x


def _leaf_pairs(port_tree, ref_tree):
    """(path, port array in the reference layout, reference array) per leaf;
    an int8 wire leaf gives one pair for its values and one for its scales."""
    ref_leaves = jax.tree.leaves(ref_tree, is_leaf=lambda x: hasattr(x, "q") and hasattr(x, "s"))
    out = []
    for (path, a), b in zip(tree_items(port_tree), ref_leaves):
        if isinstance(a, QuantLeaf):
            out += [(path + ("q",), _to_ref_layout(path, a.q), _ref_np(b.q)),
                    (path + ("s",), _to_ref_layout(path, a.s), _ref_np(b.s))]
        else:
            out.append((path, _to_ref_layout(path, a), _ref_np(b)))
    assert len(ref_leaves) == len(list(tree_items(port_tree)))
    return out


def _max_err(port_tree, ref_tree):
    return max(float(np.abs(a.astype(np.float64) - b).max()) for _, a, b in _leaf_pairs(port_tree, ref_tree))


# -- the per-leaf codecs ------------------------------------------------------------


@pytest.mark.parametrize("codec", ["identity", "bf16", "f16", "int8", "topk:0.25"])
def test_per_leaf_codec_wire_matches_reference(codec):
    """Every agent's tree through ``encode`` under its key (``fold_in(key,
    agent)``), top-k with a non-zero incoming residual: the wire, the new
    state and the decoded tree equal the reference's (vmapped over the
    agents, jitted) bit for bit."""
    ref_K = _tiny_agents(seed=1)
    ref_codec, port_codec = ref_make_codec(codec), make_codec(codec)
    rng = np.random.default_rng(9)
    res = jax.tree.map(lambda x: (0.1 * rng.normal(size=x.shape)).astype(np.float32), ref_K)
    stateful = port_codec.stateful
    ref_state = res if stateful else ()
    keys = ref_consensus._agent_keys(jax.random.key(5), K)
    wire_r, st_r = jax.jit(jax.vmap(ref_codec.encode))(ref_K, ref_state, keys)
    dec_r = jax.jit(jax.vmap(ref_codec.decode))(wire_r)

    port_K = bridge.params_from_jax(ref_K, device="cpu")
    port_res = bridge.params_from_jax(res, device="cpu")
    words = prng.fold_in(prng.key(5), np.arange(K))
    wires, states = [], []
    for k in range(K):
        w, st = port_codec.encode(tree_map(lambda x: x[k], port_K),
                                  tree_map(lambda x: x[k], port_res) if stateful else (), words[k])
        wires.append(w)
        states.append(st)
    wire = tree_map(consensus._stack_wire, *wires)
    for path, a, b in _leaf_pairs(wire, wire_r):
        assert a.dtype == b.dtype or codec in ("bf16", "f16"), (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    for path, a, b in _leaf_pairs(port_codec.decode(wire), dec_r):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    if stateful:
        for path, a, b in _leaf_pairs(tree_map(lambda *xs: torch.stack(xs), *states), st_r):
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        assert port_codec.init_state(tree_map(lambda x: x[0], port_K))["head"]["w"].abs().sum() == 0
    else:
        assert all(st == () for st in states)
    if codec == "int8":  # the wire uses the whole int8 range, scale per slot on stacked leaves
        assert int(wire["blocks"]["conv1"].q.abs().max()) == 127
        assert tuple(wire["blocks"]["conv1"].s.shape) == (K, 2, 1, 1, 1, 1)


def test_int8_codec_needs_a_key():
    port_K, _ = _port(_tiny_agents(seed=1))
    with pytest.raises(ValueError, match="key"):
        make_codec("int8").encode(tree_map(lambda x: x[0], port_K), (), None)


# -- the per-layer algebra ----------------------------------------------------------


def _resnet_agents(seed, spread):
    p0 = bridge.params_to_jax(resnet.init_resnet20(torch.Generator().manual_seed(seed), width=4))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: x[None] + spread * rng.normal(size=(K, *x.shape)).astype(np.float32), p0)


def test_layer_partition_algebra_matches_reference():
    """Norms and Gram distances: f32 sums in another order, 1e-5 relative
    (distances: of mean_k ||x_k||^2, the size of the Gram entries they are
    differences of); the combine 1e-6; the per-layer scale exactly (one
    rounded product per element on both sides)."""
    ref_K = _resnet_agents(seed=4, spread=0.3)
    ref_part = _ref_part(ref_K)
    port_K, part = _port(ref_K)
    assert [(g.key, g.stacked, g.n_slots, g.offset) for g in part.groups] == [
        (g.key, g.stacked, g.n_slots, g.offset) for g in ref_part.groups
    ]
    one_r, one = jax.tree.map(lambda x: x[1], ref_K), tree_map(lambda x: x[1], port_K)
    np.testing.assert_allclose(part.sq_norms(one).numpy(), np.asarray(ref_part.sq_norms(one_r)), rtol=1e-5)
    n2_r = np.asarray(ref_part.agent_sq_norms(ref_K))
    np.testing.assert_allclose(part.agent_sq_norms(port_K).numpy(), n2_r, rtol=1e-5)
    d2, n2 = part.pairwise_sq_dists(port_K)
    d2_r, n2_r2 = (np.asarray(v) for v in jax.jit(ref_part.pairwise_sq_dists)(ref_K))
    scale = n2_r.max()
    np.testing.assert_allclose(d2.numpy(), d2_r, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(n2.numpy(), n2_r2, rtol=1e-5)
    assert float(torch.diagonal(d2, dim1=1, dim2=2).abs().max()) <= 1e-5 * scale
    rng = np.random.default_rng(0)
    A = np.ascontiguousarray(rng.dirichlet(np.ones(K), size=(part.num_layers, K)).swapaxes(1, 2), np.float32)
    got = part.combine(torch.from_numpy(A), port_K)
    assert _max_err(got, jax.jit(ref_part.combine)(jnp.asarray(A), ref_K)) <= 1e-6
    w = rng.uniform(size=part.num_layers).astype(np.float32)
    got = part.scale_by_layer(torch.from_numpy(w), one)
    assert _max_err(got, jax.jit(ref_part.scale_by_layer)(jnp.asarray(w), one_r)) == 0.0


# -- the tree oracle against the reference's ---------------------------------------


def _mix(topo):
    return topo.c_matrix().astype(np.float32), topo.metropolis().astype(np.float32)


@pytest.fixture(scope="module")
def reference_tree():
    """The reference's tree-path results from the tiny tree under one jitted
    program per topology (compiled once for the module): ``{topology:
    {(codec, algorithm): (one step's (new, A, state), rounds' (new, A,
    state, metrics))}}``."""
    ref_K = _tiny_agents(seed=2)
    part = _ref_part(ref_K)
    cache = {}

    def get(name):
        if name not in cache:
            C, metro = (jnp.asarray(m) for m in _mix(TOPOLOGIES[name]))
            kw = dict(cfg=RefDRTConfig(), metropolis=metro)

            def run(psi):
                out = {}
                for codec in CODECS:
                    c = codec or "identity"
                    for algorithm in ("drt", "classical"):
                        step = ref_consensus.gather_consensus_step(
                            part, psi, C, algorithm=algorithm, codec=c, rng=jax.random.key(4), **kw)
                        rounds = ref_consensus.gather_consensus_rounds(
                            part, psi, C, rounds=ROUNDS, algorithm=algorithm, codec=codec,
                            rng=jax.random.key(11), path="tree", obs=RefObsConfig(), **kw)
                        out[str(codec), algorithm] = (step, rounds)
                return out

            cache[name] = jax.jit(run)(ref_K)
        return cache[name]

    return ref_K, get


def _cast_step(codec, x_max):
    """One step of a rounding wire at magnitude ``x_max``: int8 ``x_max /
    127``, bf16 ``2^-8 x_max``, f16 ``2^-11 x_max`` (rounded up to a power
    of two)."""
    if codec == "int8":
        return x_max / 127.0
    bits = {"bf16": 8, "f16": 11}[codec]
    return 2.0 ** (np.floor(np.log2(x_max)) + 1 - bits)


@pytest.mark.parametrize("algorithm", ["drt", "classical"])
@pytest.mark.parametrize("codec", CODECS)
def test_tree_step_matches_reference(reference_tree, codec, algorithm):
    """One round from the same tree: identical wire (the codecs are bit for
    bit above), so only f32 sums in another order separate the two: out
    1e-5, A 1e-6, the top-k residual exact."""
    ref_K, get = reference_tree
    (new_r, A_r, st_r), _ = get("ring")[str(codec), algorithm]
    port_K, part = _port(ref_K)
    C, metro = _mix(TOPOLOGIES["ring"])
    new, A, st = consensus.gather_consensus_step(
        part, port_K, C, DRTConfig(), algorithm, metro, codec=codec or "identity", rng=prng.key(4),
    )
    assert _max_err(new, new_r) <= 1e-5
    np.testing.assert_allclose(A.numpy(), np.asarray(A_r), rtol=0, atol=1e-6)
    if codec and codec.startswith("topk"):
        assert _max_err(st, st_r) == 0.0
    else:
        assert st == ()
    legacy = consensus.gather_consensus_step(part, port_K, C, DRTConfig(), algorithm, metro)
    assert len(legacy) == 2


@pytest.mark.parametrize("topo", list(TOPOLOGIES))
@pytest.mark.parametrize("algorithm", ["drt", "classical"])
@pytest.mark.parametrize("codec", CODECS)
def test_tree_rounds_match_reference(reference_tree, topo, codec, algorithm):
    """Three tree rounds with telemetry.  Exact and top-k: out 5e-6, the
    residual 5e-6 (f32 sums in another order), A to 1e-4 relative: DRT's
    distances are differences of Gram entries and each round contracts
    them, so their relative error grows round by round
    (tests/test_torch_consensus.py states the same).  A rounding wire
    (int8, bf16, f16) sees the two sides' iterates differ in the last bits
    after round 1, so a value can round to its other neighbour; each such
    flip moves one wire value by one step, and later rounds mix it with
    column-stochastic weights: no element moves by more than ``rounds``
    steps, and few columns move at all (tests/test_torch_coded_consensus.py
    ``_int8_flip_bound`` states the argument)."""
    ref_K, get = reference_tree
    _, (new_r, A_r, st_r, m_r) = get(topo)[str(codec), algorithm]
    port_K, part = _port(ref_K)
    C, metro = _mix(TOPOLOGIES[topo])
    out = consensus.gather_consensus_rounds(
        part, port_K, C, DRTConfig(), rounds=ROUNDS, algorithm=algorithm, metropolis=metro,
        codec=codec, rng=prng.key(11), path="tree", obs=ObsConfig(),
    )
    new, A, m = out[0], out[1], out[-1]
    assert len(out) == (3 if codec is None else 4)
    if codec in ("int8", "bf16", "f16"):
        step = _cast_step(codec, max(float(np.abs(x).max()) for x in jax.tree.leaves(ref_K)))
        assert _max_err(new, new_r) <= ROUNDS * step
        np.testing.assert_allclose(A.numpy(), np.asarray(A_r), rtol=0, atol=1e-4)
    else:
        assert _max_err(new, new_r) <= 5e-6
        np.testing.assert_allclose(A.numpy(), np.asarray(A_r), rtol=1e-4, atol=1e-6)
    if codec == "topk:0.25":
        assert _max_err(out[2], st_r) <= 5e-6
        assert any(bool(x.any()) for _, x in tree_items(out[2]))
    elif codec is not None:
        assert out[2] == ()
    np.testing.assert_allclose(m.disagreement.numpy(), np.asarray(m_r.disagreement), rtol=1e-4)
    assert m.effective_rounds.tolist() == [1.0, 2.0, 3.0]


# -- the port's slab path against the port's tree path --------------------------------


def _reference_slab_vs_tree_tree():
    """``tests/test_packing.py``'s ``_tree_K(4)``: multi-leaf groups with
    widths that force lane padding, drawn with ``jax.random`` as there."""
    def one(k):
        ks = jax.random.split(k, 5)
        return {
            "embed": {"w": jax.random.normal(ks[0], (4, 8)), "b": jax.random.normal(ks[1], (5,))},
            "blocks": {"w": jax.random.normal(ks[2], (3, 8, 8)), "g": jax.random.normal(ks[3], (3, 7)),
                       "s": jax.random.normal(ks[4], (3,))},
        }

    return jax.tree.map(np.asarray, jax.vmap(one)(jax.random.split(jax.random.key(0), K)))


F16_STEP = 2.0**-10  # f16 keeps 11 significant bits: one step is at most 2^-10 of the value


def _one_round_each(part, x, C, kw):
    """One tree round and one slab round from the same iterate ``x``."""
    one = dict(kw, rounds=1)
    tree = consensus.gather_consensus_rounds(part, x, C, DRTConfig(), path="tree", **one)
    slab = consensus.gather_consensus_rounds(part, x, C, DRTConfig(), path="slab", **one)
    return tree, slab


@pytest.mark.parametrize("topo", ["ring", "hypercube", "torus2d"])
@pytest.mark.parametrize("algorithm", ["drt", "classical"])
@pytest.mark.parametrize("codec", CODECS)
def test_port_slab_path_matches_port_tree_path(topo, algorithm, codec):
    """The reference's own slab-vs-tree check, on the port (3 rounds, the
    same tree): parameters and the top-k residual within 5e-6, A within
    1e-4, as the reference holds its own.  f16 within one f16 step at the
    leaf's magnitude: the slab sums the Gram in another order, so an
    iterate can round to the other f16 neighbour after round 1 (the
    reference's own f16-drt-ring case misses its fixed 2e-4 by one step,
    2.40e-4 at |x| ~ 0.45).

    bf16 DRT, the same mechanism, shown on the hypercube and the 2-D torus
    (one graph at K = 4) on one CPU: after round 0 the two iterates differ
    by f32 rounding (<= 4.2e-7; A by 1.2e-7).  In round 1, agent 1's
    ``('blocks', 'w')[0, 0, 2]`` is -0.319336087 on the tree and
    -0.319335848 on the slab, 2.4e-7 apart on either side of the bf16
    midpoint -0.3193359375, so the two wires carry its two neighbours,
    -0.3203125 and -0.318359375, one step (2^-9) apart.  DRT's weights are
    made from the decoded wires, so that one flip moves A (4.8e-5 in round
    1, 2.4e-4 in round 2) and, through A, positions of every leaf (311 of
    768 of ``('blocks', 'w')`` beyond 5e-6), and round 2 flips ten more
    wire values that now differ by more than a tie.  After 3 rounds
    ``('blocks', 'w')`` differs by 1.86e-3, ``('blocks', 'g')`` by 7.1e-5.
    Whether the tie arises depends on the last bits of round 0's f32 sums,
    which differ between CPUs: the case passes at 5e-6 on one and not on
    another.  So bf16 is held in two parts:

    * every round of the slab path's own trajectory against one tree round
      from the same iterate (identical inputs, identical wires): parameters
      within 5e-6 and A within 1e-4, as every other exact-wire check;
    * the 3-round end points, each leaf within 5e-6 plus ``(ROUNDS - 1)``
      wire flips: no flip in round 0 (same input), at most one step per
      value in each later round (the bf16 step at the leaf's largest |x|,
      ``_cast_step``), entering a neighbour with at most the largest
      off-diagonal weight of any round; A within 1e-4 plus ``(ROUNDS - 1)
      * 2^-8`` of itself (one bf16 rounding of the distances per later
      round).  Read: 0.23 of the leaf's flip term, 0.17 of A's tolerance.
    Classical bf16 mixes with fixed Metropolis weights, and the ring meets
    no tie: both stay within 5e-6."""
    pK = bridge.params_from_jax(_reference_slab_vs_tree_tree(), device="cpu")
    part = LayerPartition.build(agent_template(pK))
    t = make_topology(topo, K)
    C, metro = _mix(t)
    kw = dict(rounds=ROUNDS, algorithm=algorithm, metropolis=metro, codec=codec, rng=prng.key(11))
    want = consensus.gather_consensus_rounds(part, pK, C, DRTConfig(), path="tree", **kw)
    got = consensus.gather_consensus_rounds(part, pK, C, DRTConfig(), path="slab", **kw)
    a_tol, a_rtol, flip = 1e-4, 0.0, 0.0
    if codec == "bf16":
        x, a_max = pK, 0.0
        for r in range(ROUNDS):
            tree, slab = _one_round_each(part, x, C, kw)
            for (path, a), (_, b) in zip(tree_items(slab[0]), tree_items(tree[0])):
                assert float((a - b).abs().max()) <= 5e-6, (r, path, float((a - b).abs().max()))
            np.testing.assert_allclose(slab[1].numpy(), tree[1].numpy(), rtol=0, atol=1e-4)
            a_max = max(a_max, float((slab[1] * (1.0 - torch.eye(K))).max()))
            x = slab[0]
        for (_, a), (_, b) in zip(tree_items(x), tree_items(got[0])):
            assert torch.equal(a, b)  # round by round is the 3-round call
        flip, a_rtol = (ROUNDS - 1) * a_max, (ROUNDS - 1) * 2.0**-8
    for (path, a), (_, b) in zip(tree_items(got[0]), tree_items(want[0])):
        tol = 5e-6
        x_max = float(torch.maximum(a.abs(), b.abs()).max())
        if codec == "f16":
            tol += F16_STEP * x_max
        tol += flip * _cast_step("bf16", x_max)
        assert float((a - b).abs().max()) <= tol, (path, float((a - b).abs().max()), tol)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=a_rtol, atol=a_tol)
    if codec == "topk:0.25":
        for (_, a), (_, b) in zip(tree_items(got[2]), tree_items(want[2])):
            assert float((a - b).abs().max()) <= 5e-6


def test_tree_path_refusals():
    """A robust combine needs the slab path, as in the reference; a
    per-round stack must cover the round-set; int8 still needs a key."""
    port_K, part = _port(_tiny_agents(seed=3))
    C, metro = _mix(TOPOLOGIES["ring"])
    with pytest.raises(ValueError, match="slab path"):
        consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), path="tree", combine="median")
    with pytest.raises(ValueError, match="stack has 2 rounds"):
        consensus.gather_consensus_rounds(part, port_K, np.stack([C, C]), DRTConfig(), rounds=3, path="tree")
    with pytest.raises(ValueError, match="rng"):
        consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), codec="int8", path="tree")
    with pytest.raises(ValueError, match="metropolis"):
        consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), algorithm="classical", path="tree")


# -- the trainer on the tree path ---------------------------------------------------


def test_tree_epoch_matches_reference():
    """One epoch with ``consensus_path="tree"`` on both sides: 3 local
    momentum-SGD steps per agent, then 3 exact DRT tree rounds, from the
    same weights.  Per-step conv rounding (~1e-6) carries through three
    updates and the mixing: loss and parameters to 1e-5.  The disagreement
    ``||X - Xbar||^2 / K`` is read off the tree on both sides, so a
    parameter difference dX moves it by at most ``(2 sqrt(K dis) ||dX|| +
    ||dX||^2) / K`` (centering is a projection): held to that bound, with
    ``||dX||`` measured."""
    ref_K = _resnet_agents(seed=5, spread=0.02)
    data = CifarLike(CifarLikeConfig(image_size=8, noise=0.1, max_shift=0))
    batches = agent_minibatches(data.paper_partition(num_agents=K, min_samples=24, max_samples=30, seed=1),
                                batch_size=8, epoch_seed=0)
    ref_tr = ref_dec.DecentralizedTrainer(
        lambda p, b, rng: ref_resnet.resnet20_loss(p, b), lambda key: None, ref_optim.momentum(0.05, 0.9),
        ref_ring(K), ref_dec.TrainerConfig(algorithm="drt", consensus_steps=3, consensus_path="tree"),
    )
    ref_params = jax.tree.map(jnp.asarray, ref_K)
    ref_tr.build_partition(ref_params)
    ref_st = ref_dec.DecentralizedState(ref_params, ref_tr.optimizer.init(ref_params), jnp.zeros((), jnp.int32), ())
    ref_st, ref_m = jax.jit(ref_tr.epoch)(ref_st, jax.tree.map(jnp.asarray, batches), jax.random.key(0))

    tr = DecentralizedTrainer(
        resnet.resnet20_agent_losses, lambda g: resnet.init_resnet20(g, width=4), optimizers.momentum(0.05, 0.9),
        ring(K), TrainerConfig(algorithm="drt", consensus_steps=3, consensus_path="tree"), device="cpu",
    )
    st, m = tr.epoch(tr.state_from_params(bridge.params_from_jax(ref_K, device="cpu")), batches)
    assert st.step == int(ref_st.step) == 3
    assert abs(float(m["loss"]) - float(ref_m["loss"])) < 1e-5
    assert float(m["effective_rounds"]) == 3.0
    assert _max_err(st.params, ref_st.params) <= 1e-5
    dx = np.sqrt(sum(float(np.square(a.astype(np.float64) - b).sum())
                     for _, a, b in _leaf_pairs(st.params, ref_st.params)))
    dis = float(ref_m["disagreement"])
    bound = (2 * np.sqrt(K * dis) * dx + dx * dx) / K
    assert abs(float(m["disagreement"]) - dis) <= bound, (float(m["disagreement"]), dis, bound)
