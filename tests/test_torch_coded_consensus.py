"""The coded consensus round-set and a coded training epoch against the
reference.

One coded round (int8, bf16, f16, top-k; DRT and classical) from the same
weights is held against the reference's ``gather_consensus_rounds`` with
``use_kernels=False`` (its jnp round) and ``use_kernels=True`` (its fused
Pallas ``slab_encode_combine`` in interpret mode, on a tiny tree): out
within 1e-5, A within 1e-6, the top-k residual exact -- the tolerances the
reference holds its own fused and unfused rounds to.  The port's round goes
through the ``slab_encode_combine`` wrapper, whose plain version runs on
CPU tensors.  The kernels' plain versions are also held against the Pallas
kernels directly.  Then a 3-round int8 set and an int8 trainer epoch,
where last-bit differences may flip stochastic roundings (bounded below).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as ref_consensus
from repro.core import decentralized as ref_dec
from repro.core.drt import DRTConfig as RefDRTConfig
from repro.core.topology import ring as ref_ring
from repro.kernels import slab_codec as ref_slab_codec
from repro.models import resnet as ref_resnet
from repro.optim import optimizers as ref_optim
from repro.utils.pytree import LayerPartition as RefLayerPartition
from repro_torch import bridge
from repro_torch.comm import prng
from repro_torch.core import consensus, packing
from repro_torch.core.decentralized import DecentralizedTrainer, TrainerConfig
from repro_torch.core.drt import DRTConfig
from repro_torch.core.topology import ring
from repro_torch.data.cifar_like import CifarLike, CifarLikeConfig, agent_minibatches
from repro_torch.kernels import slab_codec
from repro_torch.kernels.slab_combine import slab_combine
from repro_torch.models import resnet
from repro_torch.obs.metrics import ObsConfig
from repro_torch.optim import optimizers
from repro_torch.utils.pytree import LayerPartition, agent_template, tree_items

torch.set_num_threads(1)
K = 4
CODECS = ["int8", "bf16", "f16", "topk:0.25"]
TOPO = ring(K)
C = TOPO.c_matrix().astype(np.float32)
METRO = TOPO.metropolis().astype(np.float32)


def _resnet_agents(seed, spread):
    """K agents of a width-4 ResNet-20 in the reference layout."""
    p0 = bridge.params_to_jax(resnet.init_resnet20(torch.Generator().manual_seed(seed), width=4))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: x[None] + spread * rng.normal(size=(K, *x.shape)).astype(np.float32), p0)


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


def _ref_rounds(ref_K, **kw):
    part = RefLayerPartition.build(jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), ref_K))
    fn = jax.jit(lambda psi: ref_consensus.gather_consensus_rounds(
        part, psi, jnp.asarray(C), RefDRTConfig(), metropolis=jnp.asarray(METRO), **kw
    ))
    return fn(ref_K)


def _port_rounds(ref_K, **kw):
    port_K = bridge.params_from_jax(ref_K, device="cpu")
    part = LayerPartition.build(agent_template(port_K))
    return consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), metropolis=METRO, **kw)


def _max_err(port_tree, ref_tree):
    got = list(tree_items(bridge.params_to_jax(port_tree)))
    want = list(tree_items(jax.tree.map(np.asarray, ref_tree)))
    assert [p for p, _ in got] == [p for p, _ in want]
    return max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(got, want))


@pytest.fixture(scope="module")
def reference_rounds():
    """The reference's one coded round from the tiny tree for every codec x
    algorithm, one jitted program per ``use_kernels`` (compiled once for
    the module): ``{use_kernels: {(codec, algorithm): (new, A, state)}}``."""
    ref_K = _tiny_agents(seed=2)
    part = RefLayerPartition.build(jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), ref_K))
    cache = {}

    def get(use_kernels):
        if use_kernels not in cache:
            fn = jax.jit(lambda psi: {
                (codec, algorithm): ref_consensus.gather_consensus_rounds(
                    part, psi, jnp.asarray(C), RefDRTConfig(), metropolis=jnp.asarray(METRO),
                    rounds=1, algorithm=algorithm, codec=codec, rng=jax.random.key(7),
                    use_kernels=use_kernels,
                )
                for codec in CODECS for algorithm in ("drt", "classical")
            })
            cache[use_kernels] = fn(ref_K)
        return cache[use_kernels]

    return ref_K, get


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("algorithm", ["drt", "classical"])
@pytest.mark.parametrize("codec", CODECS)
def test_coded_round_matches_reference(reference_rounds, codec, algorithm, use_kernels):
    """One coded round from the same slab: identical wire (bit parity is
    in test_torch_comm), so only f32 sums in another order separate the
    two: out 1e-5, A 1e-6, the top-k residual exact."""
    ref_K, get = reference_rounds
    new_r, A_r, st_r = get(use_kernels)[codec, algorithm]
    before = (slab_codec.slab_encode_combine.launches, slab_codec.slab_quant_encode.launches)
    new, A, st = _port_rounds(ref_K, rng=prng.key(7), rounds=1, algorithm=algorithm, codec=codec)
    assert (slab_codec.slab_encode_combine.launches, slab_codec.slab_quant_encode.launches) == before
    assert _max_err(new, new_r) <= 1e-5
    np.testing.assert_allclose(A.numpy(), np.asarray(A_r), rtol=0, atol=1e-6)
    if codec.startswith("topk"):
        assert _max_err(st, st_r) == 0.0
    else:
        assert st == () and st_r == ()


def _kernel_inputs(K_, nb, seed):
    """Random kernel operands: a slab, scales, column maps and key words."""
    rng = np.random.default_rng(seed)
    D = nb * slab_codec.LANES
    slab = rng.normal(size=(K_, D)).astype(np.float32)
    n_segs, n_leaves = 3, 5
    scales = (np.abs(slab).max() / 127.0 * rng.uniform(0.5, 1.0, size=(K_, n_segs))).astype(np.float32)
    col_seg = np.sort(rng.integers(0, n_segs, D)).astype(np.int32)
    col_leaf = np.sort(rng.integers(0, n_leaves, D)).astype(np.int32)
    col_idx = rng.integers(0, 2**31, D).astype(np.int32)
    w = rng.integers(0, 2**32, size=(2, K_, n_leaves), dtype=np.uint64).astype(np.uint32)
    block_layer = np.sort(rng.integers(0, 3, nb)).astype(np.int32)
    block_layer[0], block_layer[-1] = 0, 2
    return slab, (scales, col_seg, col_leaf, col_idx, w[0], w[1]), block_layer


def test_quant_encode_plain_version_matches_pallas_bit_for_bit():
    slab, (scales, col_seg, col_leaf, col_idx, w0, w1), _ = _kernel_inputs(3, 4, seed=0)
    nb = slab.shape[1] // slab_codec.LANES
    want = ref_slab_codec.slab_quant_encode(
        jnp.asarray(scales), jnp.asarray(col_seg.reshape(nb, -1)), jnp.asarray(col_leaf.reshape(nb, -1)),
        jnp.asarray(col_idx.view(np.uint32).reshape(nb, -1)), jnp.asarray(w0), jnp.asarray(w1),
        jnp.asarray(slab), interpret=True,
    )
    t = torch.from_numpy
    got = slab_codec.slab_quant_encode(
        t(scales), t(col_seg), t(col_leaf), t(col_idx), prng.words_to_tensor(w0, "cpu"),
        prng.words_to_tensor(w1, "cpu"), t(slab),
    )
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.abs(got.numpy()).max() > 64  # the scales make full use of the int8 range


@pytest.mark.parametrize("mode", ["int8", "bf16", "sent"])
@pytest.mark.parametrize("algorithm", ["drt", "classical"])
def test_encode_combine_plain_version_matches_pallas(mode, algorithm):
    """At the kernel's own interface (3 layers, 4 agents, 6 blocks): out
    1e-5, A 1e-6."""
    slab, int8_ops, block_layer = _kernel_inputs(K, 6, seed=1)
    nb = block_layer.shape[0]
    sent = np.where(np.abs(slab) > 1.0, slab, 0.0).astype(np.float32)
    mix = C if algorithm == "drt" else METRO
    common = dict(algorithm=algorithm, num_layers=3, kappa=1e-6, N_clip=8.0, weight_mode="paper")
    scales, col_seg, col_leaf, col_idx, w0, w1 = int8_ops
    ref_ops = {
        "int8": (jnp.asarray(scales), jnp.asarray(col_seg.reshape(nb, -1)), jnp.asarray(col_leaf.reshape(nb, -1)),
                 jnp.asarray(col_idx.view(np.uint32).reshape(nb, -1)), jnp.asarray(w0), jnp.asarray(w1)),
        "bf16": (), "sent": (jnp.asarray(sent),),
    }[mode]
    out_r, A_r = ref_slab_codec.slab_encode_combine(
        jnp.asarray(block_layer), jnp.asarray(slab), ref_ops, jnp.asarray(mix), mode=mode, interpret=True, **common
    )
    t = torch.from_numpy
    port_ops = {
        "int8": (t(scales), t(col_seg), t(col_leaf), t(col_idx),
                 prng.words_to_tensor(w0, "cpu"), prng.words_to_tensor(w1, "cpu")),
        "bf16": (), "sent": (t(sent),),
    }[mode]
    out, A = slab_codec.slab_encode_combine(t(block_layer), t(slab), port_ops, t(mix), mode=mode, **common)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), rtol=0, atol=1e-5)
    np.testing.assert_allclose(A.numpy(), np.asarray(A_r), rtol=0, atol=1e-6)


def _int8_flip_bound(port_tree, ref_tree, s_max, rounds):
    """Where the two sides differ beyond f32 rounding, by how much and in
    how many columns.

    After round 1 the two sides' iterates differ in the last bits (the Gram
    and the mixing sum in another order), so ``floor(x / s + u)`` can land
    on the other integer when ``x / s + u`` sits within that difference of
    one: with a relative difference eps, an element flips with probability
    about ``2 eps |x| / s <= 2 eps qmax``, ~1e-4 per element and round at
    eps ~ 4e-7.  A flip moves one wire value by one step ``s <= s_max``;
    each later round mixes wire values with column-stochastic weights (a
    convex combination), so a flip's effect never exceeds one step per
    round: every difference is at most ``rounds * s_max``.  Its column
    carries it to the agent's neighbours and stays apart, so the count is
    of columns: well under 2% of them."""
    got = list(tree_items(bridge.params_to_jax(port_tree)))
    want = list(tree_items(jax.tree.map(np.asarray, ref_tree)))
    cols = n_cols = 0
    for (_, a), (_, b) in zip(got, want):
        d = np.abs(a - b).reshape(K, -1)
        assert d.max() <= rounds * s_max, (d.max(), s_max)
        cols += int((d > 1e-5).any(axis=0).sum())
        n_cols += d.shape[1]
    assert cols <= 0.02 * n_cols, (cols, n_cols)
    return cols


def _s_max(ref_K):
    return max(float(np.abs(x).max()) for _, x in tree_items(jax.tree.map(np.asarray, ref_K))) / 127.0


def test_three_int8_rounds_within_quantization_steps():
    ref_K = _resnet_agents(seed=3, spread=0.3)
    new_r, A_r, _ = _ref_rounds(ref_K, rounds=3, codec="int8", rng=jax.random.key(11))
    new, A, _ = _port_rounds(ref_K, rounds=3, codec="int8", rng=prng.key(11))
    _int8_flip_bound(new, new_r, _s_max(ref_K), rounds=3)
    # the last round's mixing sees the flips only through the Gram
    np.testing.assert_allclose(A.numpy(), np.asarray(A_r), rtol=0, atol=1e-4)


def _epoch_data():
    data = CifarLike(CifarLikeConfig(image_size=8, noise=0.1, max_shift=0))
    shards = data.paper_partition(num_agents=K, min_samples=24, max_samples=30, seed=1)
    return agent_minibatches(shards, batch_size=8, epoch_seed=0)  # 3 batches


def _trainers(codec, algorithm="drt"):
    ref_tr = ref_dec.DecentralizedTrainer(
        lambda p, b, rng: ref_resnet.resnet20_loss(p, b), lambda key: None,
        ref_optim.momentum(0.05, 0.9), ref_ring(K),
        ref_dec.TrainerConfig(algorithm=algorithm, consensus_steps=3, codec=codec),
    )
    tr = DecentralizedTrainer(
        resnet.resnet20_agent_losses, lambda g: resnet.init_resnet20(g, width=4),
        optimizers.momentum(0.05, 0.9), TOPO,
        TrainerConfig(algorithm=algorithm, consensus_steps=3, codec=codec), device="cpu",
    )
    return ref_tr, tr


def _ref_state(ref_tr, ref_K):
    p = jax.tree.map(jnp.asarray, ref_K)
    ref_tr.build_partition(p)
    return ref_dec.DecentralizedState(p, ref_tr.optimizer.init(p), jnp.zeros((), jnp.int32), ref_tr.init_comm(p))


def test_int8_epoch_matches_reference_within_quantization_steps():
    """3 local steps, then 3 int8 DRT rounds keyed by the step-derived rng
    (``fold_in(key(0), 3)`` on both sides).  The local steps agree to
    conv rounding, then the flip bound above holds for the parameters; the
    loss to 1e-5; the disagreement through the parameter difference E:
    ``|sqrt(K dis) - sqrt(K dis_ref)| <= ||E||_F``."""
    ref_K = _resnet_agents(seed=5, spread=0.02)
    batches = _epoch_data()
    ref_tr, tr = _trainers("int8")
    ref_st, ref_m = jax.jit(ref_tr.epoch)(
        _ref_state(ref_tr, ref_K), jax.tree.map(jnp.asarray, batches), jax.random.key(0)
    )
    st = tr.state_from_params(bridge.params_from_jax(ref_K, device="cpu"))
    st, m = tr.epoch(st, batches)
    assert st.step == int(ref_st.step) == 3 and st.comm == ()
    assert abs(float(m["loss"]) - float(ref_m["loss"])) < 1e-5
    _int8_flip_bound(st.params, ref_st.params, _s_max(ref_K) * 1.1, rounds=3)
    diff = sum(
        float(np.square(a - b).sum())
        for (_, a), (_, b) in zip(tree_items(bridge.params_to_jax(st.params)),
                                  tree_items(jax.tree.map(np.asarray, ref_st.params)))
    )
    gap = abs(np.sqrt(K * float(m["disagreement"])) - np.sqrt(K * float(ref_m["disagreement"])))
    assert gap <= np.sqrt(diff) + 1e-6, (gap, diff)
    assert float(m["effective_rounds"]) == float(ref_m["effective_rounds"]) == 3.0


def test_topk_residual_rides_in_the_trainer_state_through_the_bridge():
    """Two top-k consensus round-sets (3 rounds each) on the trainer: the
    error-feedback residual lives in ``state.comm``, shaped like the
    parameters, and carries across the bridge (conv leaves permuted like
    weights).  After the first round the slabs differ by f32 rounding,
    which the distances (differences of Gram entries) amplify as on the
    exact path: A to 1e-4 relative."""
    ref_K = _tiny_agents(seed=4)
    ref_tr, tr = _trainers("topk:0.1")
    ref_st = _ref_state(ref_tr, ref_K)
    st = tr.state_from_params(bridge.params_from_jax(ref_K, device="cpu"))
    for _ in range(2):
        ref_st, A_r = jax.jit(ref_tr.consensus)(ref_st)
        st, A = tr.consensus(st)
        assert _max_err(st.params, ref_st.params) <= 1e-5
        assert _max_err(st.comm, ref_st.comm) <= 1e-5
        np.testing.assert_allclose(A.numpy(), np.asarray(A_r), rtol=1e-4, atol=1e-6)
    assert any(bool(x.any()) for _, x in tree_items(st.comm))
    for (pa, a), (pb, b) in zip(tree_items(st.comm), tree_items(st.params)):
        assert pa == pb and a.shape == b.shape and a.dtype == torch.float32
    # the residual tree goes back and forth through the bridge like weights
    back = bridge.params_from_jax(bridge.params_to_jax(st.comm), device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(back), tree_items(st.comm)))


def test_coded_telemetry_and_unported_combinations():
    """Telemetry reads the per-round disagreement off each output slab;
    the coded path still refuses what is not ported, and int8 refuses to
    run without a key.  CPU slabs launch no kernel."""
    ref_K = _resnet_agents(seed=6, spread=0.2)
    port_K = bridge.params_from_jax(ref_K, device="cpu")
    part = LayerPartition.build(agent_template(port_K))
    launches = (slab_codec.slab_encode_combine.launches, slab_combine.launches)
    new, A, st, m = consensus.gather_consensus_rounds(
        part, port_K, C, DRTConfig(), rounds=3, codec="bf16", obs=ObsConfig()
    )
    assert launches == (slab_codec.slab_encode_combine.launches, slab_combine.launches)
    assert m.disagreement.shape == (3,) and float(m.disagreement[-1]) < float(m.disagreement[0])
    assert m.effective_rounds.tolist() == [1.0, 2.0, 3.0]
    t = agent_template(port_K)
    layout = packing.build_slab_layout(part, t)
    direct = packing.slab_disagreement(layout.pack(new), layout)
    torch.testing.assert_close(m.disagreement[-1], direct, rtol=0, atol=0)
    # the identity codec runs the exact path and hands its state back
    exact_new, exact_A = consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), rounds=2)
    id_new, id_A, id_st = consensus.gather_consensus_rounds(
        part, port_K, C, DRTConfig(), rounds=2, codec="identity"
    )
    assert id_st == () and torch.equal(id_A, exact_A)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(id_new), tree_items(exact_new)))
    with pytest.raises(ValueError, match="rng"):
        consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), codec="int8")
    with pytest.raises(ValueError, match="codec"):
        consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), codec="gzip")
    with pytest.raises(ValueError, match="codec"):
        TrainerConfig(codec="gzip")
