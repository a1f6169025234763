"""The exact consensus round-set and the whole training epoch against the
reference.

``gather_consensus_rounds`` (exact slab path, rounds=3, with telemetry) is
held against the reference with ``use_kernels=False`` (jnp combine) and
``use_kernels=True`` (the Pallas ``slab_combine`` in interpret mode); the
port always combines through its ``slab_combine`` wrapper, which runs the
plain version on CPU tensors.  Then one whole ``epoch`` (local steps + one
consensus round-set) at K=4 on a ring, from the same initial weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as ref_consensus
from repro.core import decentralized as ref_dec
from repro.core.drt import DRTConfig as RefDRTConfig
from repro.models import resnet as ref_resnet
from repro.obs import ObsConfig as RefObsConfig
from repro.optim import optimizers as ref_optim
from repro.utils.pytree import LayerPartition as RefLayerPartition
from repro_torch import bridge
from repro_torch.core import consensus
from repro_torch.core.decentralized import DecentralizedTrainer, TrainerConfig
from repro_torch.core.drt import DRTConfig
from repro_torch.core.topology import ring
from repro_torch.data.cifar_like import CifarLike, CifarLikeConfig, agent_minibatches
from repro_torch.kernels.slab_combine import slab_combine
from repro_torch.models import resnet
from repro_torch.obs.metrics import ObsConfig
from repro_torch.optim import optimizers
from repro_torch.utils.pytree import LayerPartition, agent_template, tree_items

torch.set_num_threads(1)
K = 4


def _agents(seed, spread):
    """K agents' reference-layout weights: one init plus seeded noise."""
    p0 = bridge.params_to_jax(resnet.init_resnet20(torch.Generator().manual_seed(seed), width=4))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: x[None] + spread * rng.normal(size=(K, *x.shape)).astype(np.float32), p0
    )


def _assert_trees_close(port_tree, ref_tree, atol, rtol=0.0):
    got = list(tree_items(bridge.params_to_jax(port_tree)))
    want = list(tree_items(jax.tree.map(np.asarray, ref_tree)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=str(path))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("algorithm", ["drt", "classical"])
def test_exact_round_set_matches_reference(algorithm, use_kernels):
    """Three exact rounds with telemetry.

    Both sides sum the Gram in f32 in different orders.  Distances and the
    disagreement are differences of Gram entries (n2_k + n2_l - 2 G_kl), so
    their rounding error scales with the Gram's size, eps * ||x||^2, not
    with their own; each round contracts the distances ~10x, and the error
    relative to them grows as much.  Agents start well apart (spread 0.3)
    so three rounds stay well conditioned: weights to 1e-4 relative,
    parameters to 5e-6, the disagreement to 1e-7 * mean_k ||x_k||^2."""
    ref_K = _agents(seed=3, spread=0.3)
    topo = ring(K)
    C, metro = topo.c_matrix().astype(np.float32), topo.metropolis().astype(np.float32)
    ref_t = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), ref_K)
    ref_part = RefLayerPartition.build(ref_t)

    def ref_fn(psi):
        new, A, _, m = ref_consensus.gather_consensus_rounds(
            ref_part, psi, jnp.asarray(C), RefDRTConfig(), rounds=3, algorithm=algorithm,
            metropolis=jnp.asarray(metro), use_kernels=use_kernels, obs=RefObsConfig(),
        )
        return new, A, m.disagreement, m.effective_rounds

    new_ref, A_ref, dis_ref, eff_ref = jax.jit(ref_fn)(ref_K)

    port_K = bridge.params_from_jax(ref_K, device="cpu")
    part = LayerPartition.build(agent_template(port_K))
    new, A, m = consensus.gather_consensus_rounds(
        part, port_K, C, DRTConfig(), rounds=3, algorithm=algorithm,
        metropolis=metro, obs=ObsConfig(),
    )
    np.testing.assert_allclose(A.numpy(), np.asarray(A_ref), rtol=1e-4, atol=1e-6)
    _assert_trees_close(new, new_ref, atol=5e-6)
    np.testing.assert_allclose(
        m.disagreement.numpy(), np.asarray(dis_ref), rtol=0, atol=1e-7 * _gram_scale(port_K)
    )
    np.testing.assert_array_equal(m.effective_rounds.numpy(), np.asarray(eff_ref))
    assert m.disagreement.shape == (3,)
    # consensus contracts the network
    assert float(m.disagreement[-1]) < float(m.disagreement[0])


def _gram_scale(params_K):
    """mean_k ||x_k||^2: the size of the Gram entries whose differences
    give distances and disagreement."""
    return sum(float(x.double().square().sum()) for _, x in tree_items(params_K)) / K


def test_unported_options_raise():
    """Per-round stacks and the control knobs are ported and validated as
    the reference validates them (faults, trust reweighting and robust
    combines are ported too: ``tests/test_torch_faults.py``)."""
    port_K = bridge.params_from_jax(_agents(seed=1, spread=0.01), device="cpu")
    part = LayerPartition.build(agent_template(port_K))
    C = ring(K).c_matrix()
    with pytest.raises(ValueError, match="stack has 3 rounds"):
        consensus.gather_consensus_rounds(part, port_K, np.stack([C, C, C]), DRTConfig(), rounds=2)
    with pytest.raises(ValueError, match="momentum"):
        consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), momentum=1.0)
    with pytest.raises(ValueError, match="round_tol"):
        consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), round_tol=0.0)
    with pytest.raises(ValueError):
        consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), rounds=0)


def _epoch_data():
    data = CifarLike(CifarLikeConfig(image_size=8, noise=0.1, max_shift=0))
    shards = data.paper_partition(num_agents=K, min_samples=24, max_samples=30, seed=1)
    return agent_minibatches(shards, batch_size=8, epoch_seed=0)  # 3 batches


@pytest.mark.parametrize("algorithm", ["drt", "classical"])
def test_epoch_matches_reference(algorithm):
    """The slice end to end: 3 local momentum-SGD steps per agent, then 3
    exact consensus rounds, from the same initial weights (agents start
    apart, so DRT has distances to weigh).  Per-step conv rounding (~1e-6)
    carries through three updates and the mixing: loss and parameters to
    1e-5.  The disagreement is read off the Gram recurrence, a difference of
    Gram entries (see above), so its error scales with mean_k ||x_k||^2: to
    1e-6 of that."""
    ref_K = _agents(seed=5, spread=0.02)
    batches = _epoch_data()
    topo = ring(K)

    from repro.core.topology import ring as ref_ring

    ref_tr = ref_dec.DecentralizedTrainer(
        lambda p, b, rng: ref_resnet.resnet20_loss(p, b),
        lambda key: None,
        ref_optim.momentum(0.05, 0.9),
        ref_ring(K),
        ref_dec.TrainerConfig(algorithm=algorithm, consensus_steps=3),
    )
    ref_params = jax.tree.map(jnp.asarray, ref_K)
    ref_tr.build_partition(ref_params)
    ref_st = ref_dec.DecentralizedState(
        ref_params, ref_tr.optimizer.init(ref_params), jnp.zeros((), jnp.int32), ()
    )
    ref_st, ref_m = jax.jit(ref_tr.epoch)(
        ref_st, jax.tree.map(jnp.asarray, batches), jax.random.key(0)
    )

    tr = DecentralizedTrainer(
        resnet.resnet20_agent_losses,
        lambda g: resnet.init_resnet20(g, width=4),
        optimizers.momentum(0.05, 0.9),
        topo,
        TrainerConfig(algorithm=algorithm, consensus_steps=3),
        device="cpu",
    )
    st = tr.state_from_params(bridge.params_from_jax(ref_K, device="cpu"))
    st, m = tr.epoch(st, batches)

    assert st.step == int(ref_st.step) == 3
    assert abs(float(m["loss"]) - float(ref_m["loss"])) < 1e-5
    assert abs(float(m["disagreement"]) - float(ref_m["disagreement"])) <= 1e-6 * _gram_scale(
        st.params
    ), (float(m["disagreement"]), float(ref_m["disagreement"]), _gram_scale(st.params))
    assert float(m["effective_rounds"]) == float(ref_m["effective_rounds"]) == 3.0
    _assert_trees_close(st.params, ref_st.params, atol=1e-5)
    _assert_trees_close(st.opt_state["m"], ref_st.opt_state["m"], atol=1e-4)
    assert m["local_seconds"] > 0 and m["consensus_seconds"] > 0


def test_trainer_init_same_init_and_no_kernel_launches_on_cpu():
    tr = DecentralizedTrainer(
        resnet.resnet20_agent_losses,
        lambda g: resnet.init_resnet20(g, width=4),
        optimizers.sgd(0.1),
        ring(K),
        device="cpu",
    )
    st = tr.init(torch.Generator().manual_seed(0))
    for _, leaf in tree_items(st.params):
        assert leaf.shape[0] == K and torch.equal(leaf[0], leaf[-1])
    before = slab_combine.launches
    st2, A = tr.consensus(st)
    assert slab_combine.launches == before  # CPU slabs take the plain version
    # identical agents: consensus is the identity
    for (_, a), (_, b) in zip(tree_items(st2.params), tree_items(st.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert A.shape == (tr.partition.num_layers, K, K)
