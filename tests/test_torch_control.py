"""Dynamic graphs and round control on the gather engine, the trainer and
the optimizers, against the reference.

* ``gather_consensus_rounds`` over a churn schedule's per-round stacks
  (ring/hypercube, K=8, rounds 5-7: agents isolated in rounds 5 and 6),
  momentum 0.4 and an adaptive ``round_tol``, on the slab (exact: the Gram
  path in coefficient space; int8, top-k: the coded rounds), edge and tree
  paths, DRT and classical.  ``tol`` sits at the geometric mean of the
  disagreements after rounds 1 and 2 of the same configuration's fixed run
  (the port's), so a last-bit difference cannot flip the gate: rounds 0 and
  1 run, round 2 is gated off, and ``effective_rounds`` equals the
  reference's exactly.  The reference's 8 cases run in one jitted program.
  Tolerances are those of the existing tests for each path (exact slab:
  parameters 5e-6, A 1e-4 relative; coded, edge, tree: 1e-5 and A 1e-6;
  the disagreement 1e-6 of mean_k ||x_k||^2), plus the momentum allowance:
  XLA contracts ``x + beta m`` into one fused multiply-add, the port rounds
  the product and the sum apart, one f32 rounding of |x| a round.  int8 is
  held in quantization steps (a flipped rounding moves a wire value by one
  step; momentum carries it on).  A round-set gated off at round 2 equals
  the 2-round set bit for bit.
* A trainer epoch with ``schedule``, ``consensus_momentum`` and
  ``rounds_policy`` against the reference trainer's (a small MLP, K=8);
  ``make_many_steps`` bit for bit against single steps; a static schedule
  bit for bit the schedule-free trainer.
* ``clip_by_global_norm``, ``chain`` and the learning-rate schedules.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as ref_consensus
from repro.core import decentralized as ref_dec
from repro.core import dynamic as ref_dynamic
from repro.core import topology as ref_topology
from repro.core.drt import DRTConfig as RefDRTConfig
from repro.obs import ObsConfig as RefObsConfig
from repro.optim import optimizers as ref_optim
from repro.optim import schedule as ref_schedule
from repro.utils.pytree import LayerPartition as RefLayerPartition
from repro_torch import bridge
from repro_torch.comm import prng
from repro_torch.core import consensus, dynamic, topology
from repro_torch.core.decentralized import DecentralizedTrainer, TrainerConfig
from repro_torch.core.drt import DRTConfig
from repro_torch.obs.metrics import ObsConfig
from repro_torch.optim import optimizers, schedule
from repro_torch.utils.pytree import LayerPartition, agent_template, tree_items, tree_map

torch.set_num_threads(1)
K, ROUNDS, START, BETA = 8, 3, 5, 0.4
# every codec and algorithm on the slab path, and on the edge and tree paths a
# DRT int8 case and a classical one (their control code is the codec's)
CASES = [("slab", None, "drt"), ("slab", None, "classical"), ("slab", "int8", "drt"), ("slab", "topk:0.25", "drt"),
         ("edge", "int8", "drt"), ("edge", "topk:0.25", "classical"), ("tree", None, "classical"),
         ("tree", "int8", "drt")]


def _churn(d=dynamic, t=topology):
    return d.ChurnSchedule(d.PeriodicSchedule((t.ring(K), t.hypercube(K))), agent_drop=0.25, edge_drop=0.1, seed=5)


def _tiny_agents(seed):
    """A tiny tree (reference layout): a stacked group with a conv leaf and
    a per-slot scale leaf, a plain group, and a plain conv group."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.normal(size=(K, *shape)).astype(np.float32)

    return {"blocks": {"conv1": 0.3 * n(2, 3, 3, 4, 4), "gn_w": 1.0 + 0.3 * n(2, 4)},
            "head": {"b": 0.3 * n(5), "w": 0.3 * n(4, 5)}, "stem": {"conv": 0.3 * n(3, 3, 3, 4)}}


def _case_kw(path, codec, algo, sched, tol, key, rounds=ROUNDS):
    """``(C stack, keyword arguments)`` of a case's round-set from round
    ``START`` of ``sched`` (either package's)."""
    C, M = sched.mixing_stacks(START, rounds)
    kw = dict(rounds=rounds, algorithm=algo, metropolis=M, path=path, momentum=BETA, round_tol=tol)
    if codec:
        kw.update(codec=codec, rng=key)
    if path == "edge":
        kw.update(edges=sched.edge_stacks(START, rounds), max_in_degree=sched.max_in_degree)
    return C, kw


def _port_rounds(port_K, case, tol, rounds=ROUNDS):
    part = LayerPartition.build(agent_template(port_K))
    C, kw = _case_kw(*case, _churn(), tol, prng.key(7), rounds)
    return consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), obs=ObsConfig(), **kw)


def _tol(port_K, case):
    """The geometric mean of the disagreements after rounds 1 and 2 of the
    fixed run: rounds 0 and 1 run, round 2 is gated off."""
    d = _port_rounds(port_K, case, None)[-1].disagreement.double().numpy()
    assert d[0] > d[1] > d[2], d
    return float(np.sqrt(d[0] * d[1]))


@pytest.fixture(scope="module")
def control_cases():
    """The agents, each case's tol and the reference's adaptive round-sets
    (one jitted program for all of them)."""
    ref_K = _tiny_agents(seed=2)
    port_K = bridge.params_from_jax(ref_K, device="cpu")
    tols = {case: _tol(port_K, case) for case in CASES}
    sched = _churn(ref_dynamic, ref_topology)
    part = RefLayerPartition.build(jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), ref_K))

    def run(psi):
        out = {}
        for case in CASES:
            C, kw = _case_kw(*case, sched, tols[case], jax.random.key(7))
            new, A, st, m = ref_consensus.gather_consensus_rounds(part, psi, C, RefDRTConfig(), obs=RefObsConfig(),
                                                                  **kw)
            out["|".join(map(str, case))] = (new, A, st, m.disagreement, m.effective_rounds)
        return out

    return ref_K, port_K, tols, jax.jit(run)(ref_K)


def _leaf_pairs(port_tree, ref_tree):
    got = list(tree_items(bridge.params_to_jax(port_tree)))
    want = list(tree_items(jax.tree.map(np.asarray, ref_tree)))
    assert [p for p, _ in got] == [p for p, _ in want]
    return [(a, b) for (_, a), (_, b) in zip(got, want)]


def _quant_steps(rounds, beta):
    """Bound, in quantization steps, on what flipped roundings move an
    iterate after ``rounds`` rounds: a flip moves one wire value by one
    step, mixing is convex, and e' <= (1 + beta) e + beta e_prev + 1."""
    e_prev, e = 0.0, 0.0
    for _ in range(rounds):
        e_prev, e = e, (1 + beta) * e + beta * e_prev + 1.0
    return e


@pytest.mark.parametrize("path,codec,algo", CASES)
def test_round_set_under_churn_and_control_matches_reference(control_cases, path, codec, algo):
    ref_K, port_K, tols, ref_out = control_cases
    new_r, A_r, st_r, dis_r, eff_r = ref_out[f"{path}|{codec}|{algo}"]
    out = _port_rounds(port_K, (path, codec, algo), tols[path, codec, algo])
    new, A, m = out[0], out[1], out[-1]
    np.testing.assert_array_equal(m.effective_rounds.numpy(), np.asarray(eff_r))
    assert m.effective_rounds.tolist() == [1.0, 2.0, 2.0]
    x_max = max(float(np.abs(x).max()) for _, x in tree_items(jax.tree.map(np.asarray, ref_K)))
    mom = ROUNDS * 2.0**-24 * x_max  # one more f32 rounding a round (FMA on the reference's side)
    exact_slab = path == "slab" and codec is None
    pairs = _leaf_pairs(new, new_r)
    if codec == "int8":
        step = x_max / 127.0 * 1.01
        for a, b in pairs:
            assert np.abs(a - b).max() <= _quant_steps(ROUNDS, BETA) * step + mom
        n_bad = sum(int((np.abs(a - b) > 1e-5).sum()) for a, b in pairs)
        assert n_bad <= 0.02 * sum(a.size for a, _ in pairs), n_bad
    else:
        tol = (5e-6 if exact_slab else 1e-5) + mom
        for a, b in pairs:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    np.testing.assert_allclose(A.numpy(), np.asarray(A_r), rtol=1e-4 if exact_slab else 0, atol=1e-6)
    scale = sum(float(x.double().square().sum()) for _, x in tree_items(port_K)) / K
    np.testing.assert_allclose(m.disagreement.numpy(), np.asarray(dis_r), rtol=0, atol=1e-6 * scale)
    if codec == "topk:0.25":
        for a, b in _leaf_pairs(out[2], st_r):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 + mom)
    # the round gated off changed nothing: the 2-round set, bit for bit
    two = _port_rounds(port_K, (path, codec, algo), None, rounds=2)
    for (_, a), (_, b) in zip(tree_items(new), tree_items(two[0])):
        assert torch.equal(a, b)
    assert torch.equal(A, two[1])
    if codec == "topk:0.25":
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(out[2]), tree_items(two[2])))


def test_control_validation_and_a_gate_off_from_the_start():
    """Momentum outside [0, 1) and tol <= 0 raise; a tol above the initial
    disagreement gates every round off: the iterate is returned unchanged,
    A_last is zeros and effective_rounds stays 0."""
    port_K = bridge.params_from_jax(_tiny_agents(seed=3), device="cpu")
    part = LayerPartition.build(agent_template(port_K))
    C = topology.ring(K).c_matrix()
    for kw in (dict(momentum=-0.1), dict(momentum=1.0), dict(round_tol=0.0), dict(round_tol=-1.0)):
        with pytest.raises(ValueError):
            consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), **kw)
    for path in ("slab", "tree"):
        new, A, m = consensus.gather_consensus_rounds(part, port_K, C, DRTConfig(), rounds=2, path=path,
                                                      momentum=0.3, round_tol=1e9, obs=ObsConfig())
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(new), tree_items(port_K)))
        assert not A.any() and m.effective_rounds.tolist() == [0.0, 0.0]


# -- the trainer ---------------------------------------------------------------------

D_IN, HID, N_CLS, BATCH = 12, 8, 4, 8


def _mlp_params(seed):
    rng = np.random.default_rng(seed)
    return {"dense1": {"b": 0.1 * rng.normal(size=(K, HID)).astype(np.float32),
                       "w": 0.5 * rng.normal(size=(K, D_IN, HID)).astype(np.float32)},
            "dense2": {"b": 0.1 * rng.normal(size=(K, N_CLS)).astype(np.float32),
                       "w": 0.5 * rng.normal(size=(K, HID, N_CLS)).astype(np.float32)}}


def _mlp_batches(n, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, K, BATCH, D_IN)).astype(np.float32),
            "y": rng.integers(0, N_CLS, size=(n, K, BATCH)).astype(np.int32)}


def _port_losses(p, batch):
    """Agent-batched MLP losses: (K,) mean cross-entropies."""
    h = torch.relu(torch.einsum("kbi,kio->kbo", batch["x"], p["dense1"]["w"]) + p["dense1"]["b"][:, None])
    logits = torch.einsum("kbi,kio->kbo", h, p["dense2"]["w"]) + p["dense2"]["b"][:, None]
    return torch.nn.functional.cross_entropy(logits.transpose(1, 2), batch["y"].long(), reduction="none").mean(1)


def _ref_loss(p, batch, rng):
    h = jax.nn.relu(batch["x"] @ p["dense1"]["w"] + p["dense1"]["b"])
    logits = h @ p["dense2"]["w"] + p["dense2"]["b"]
    return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), batch["y"][:, None], axis=1))


def _port_trainer(**cfg):
    return DecentralizedTrainer(_port_losses, None, optimizers.momentum(0.05, 0.9), topology.ring(K),
                                TrainerConfig(**cfg), device="cpu")


def test_epoch_with_schedule_momentum_and_adaptive_policy_matches_reference():
    """3 local steps, then the round-set of step 3 (rounds 9-11 of the churn
    schedule: four agents isolated in round 9, two in round 11) with
    momentum 0.4 and an adaptive policy whose tol gates round 2 off (the
    fixed run's geometric mean).  Loss to 1e-6, parameters 1e-5 (the
    local steps' f32 rounding carried through the rounds), the disagreement
    1e-6 of mean_k ||x_k||^2, effective_rounds exactly."""
    params, batches = _mlp_params(0), _mlp_batches(3, 1)
    base = dict(algorithm="drt", consensus_steps=3, schedule=_churn(), consensus_momentum=BETA)
    fixed = _port_trainer(**base)
    st = fixed.state_from_params(tree_map(torch.from_numpy, params))
    for i in range(3):
        st, _ = fixed.local_step(st, {k: torch.from_numpy(v[i]) for k, v in batches.items()})
    d = fixed.consensus(st, obs=ObsConfig())[-1].disagreement.double().numpy()
    assert d[0] > d[1] > d[2], d
    policy = f"adaptive:{float(np.sqrt(d[0] * d[1]))}:3"

    tr = _port_trainer(**base, rounds_policy=policy)
    st, m = tr.epoch(tr.state_from_params(tree_map(torch.from_numpy, params)), batches)
    ref_tr = ref_dec.DecentralizedTrainer(
        _ref_loss, lambda key: None, ref_optim.momentum(0.05, 0.9), ref_topology.ring(K),
        ref_dec.TrainerConfig(algorithm="drt", consensus_steps=3, schedule=_churn(ref_dynamic, ref_topology),
                              consensus_momentum=BETA, rounds_policy=policy),
    )
    ref_p = jax.tree.map(jnp.asarray, params)
    ref_tr.build_partition(ref_p)
    ref_st = ref_dec.DecentralizedState(ref_p, ref_tr.optimizer.init(ref_p), jnp.zeros((), jnp.int32), ())
    ref_st, ref_m = jax.jit(ref_tr.epoch)(ref_st, jax.tree.map(jnp.asarray, batches), jax.random.key(0))
    assert st.step == int(ref_st.step) == 3
    assert float(m["effective_rounds"]) == float(ref_m["effective_rounds"]) == 2.0
    assert abs(float(m["loss"]) - float(ref_m["loss"])) < 1e-6
    for (_, a), (_, b) in zip(tree_items(st.params), tree_items(jax.tree.map(np.asarray, ref_st.params))):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)
    scale = sum(float(x.double().square().sum()) for _, x in tree_items(st.params)) / K
    assert abs(float(m["disagreement"]) - float(ref_m["disagreement"])) <= 1e-6 * scale


def test_make_many_steps_equals_single_steps_bit_for_bit():
    """Two steps of local step + int8 consensus over the churn schedule with
    momentum and an adaptive policy: the chunk call equals two single
    steps bit for bit (the key and the schedule's rounds follow
    ``state.step``); with obs it returns (steps, rounds) metrics."""
    params, batches = _mlp_params(4), _mlp_batches(2, 5)
    tr = _port_trainer(algorithm="drt", consensus_steps=3, codec="int8", schedule=_churn(),
                       consensus_momentum=BETA, rounds_policy="adaptive:0.05:3")
    st0 = tr.state_from_params(tree_map(torch.from_numpy, params))
    st, losses = st0, []
    for i in range(2):
        st, m = tr.local_step(st, {k: torch.from_numpy(v[i]) for k, v in batches.items()})
        losses.append(m["loss"])
        st = tr.consensus(st)[0]
    got, out = tr.make_many_steps()(st0, batches)
    assert got.step == st.step == 2 and torch.equal(out["loss"], torch.stack(losses))
    for key in ("params", "opt_state"):
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(getattr(got, key)),
                                                               tree_items(getattr(st, key))))
    got_obs, out_obs = tr.make_many_steps(obs=ObsConfig())(st0, batches)
    assert out_obs["consensus"].disagreement.shape == (2, 3)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(got_obs.params), tree_items(st.params)))


def test_static_schedule_is_the_schedule_free_trainer_and_config_validation():
    params, batches = _mlp_params(6), _mlp_batches(1, 7)
    outs = []
    for sched in (None, "ring", dynamic.StaticSchedule(topology.ring(K))):
        tr = _port_trainer(consensus_steps=2, schedule=sched, consensus_path="edge")
        assert tr.schedule is None
        outs.append(tr.epoch(tr.state_from_params(tree_map(torch.from_numpy, params)), batches)[0].params)
    for other in outs[1:]:
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(outs[0]), tree_items(other)))
    tr = _port_trainer(consensus_steps=3, rounds_policy="fixed:2", schedule="periodic:ring,hypercube")
    assert tr.rounds == 2 and isinstance(tr.schedule, dynamic.PeriodicSchedule)
    for cfg in (dict(consensus_momentum=1.0), dict(consensus_momentum=-0.5)):
        with pytest.raises(ValueError, match="momentum"):
            TrainerConfig(**cfg)
    for cfg in (dict(rounds_policy="sometimes"), dict(schedule="moebius")):
        with pytest.raises(ValueError):
            _port_trainer(**cfg)


# -- optim ---------------------------------------------------------------------------


def test_clip_by_global_norm_and_chain_match_reference():
    """The norm over every leaf of the K-stacked gradient (all agents
    together, as the reference): clipped momentum and a chain of sgd and
    momentum, two steps, to 1e-6."""
    rng = np.random.default_rng(8)
    params = {"a": rng.normal(size=(4, 3, 5)).astype(np.float32), "b": rng.normal(size=(4, 7)).astype(np.float32)}
    grads = [tree_map(lambda x: (3.0 * rng.normal(size=x.shape)).astype(np.float32), params) for _ in range(2)]
    for make in (lambda o: o.clip_by_global_norm(o.momentum(0.1, 0.9), 1.0),
                 lambda o: o.chain(o.sgd(0.05), o.clip_by_global_norm(o.momentum(0.02), 0.5))):
        opt, ref_opt = make(optimizers), make(ref_optim)
        p, s = tree_map(torch.from_numpy, params), None
        rp = jax.tree.map(jnp.asarray, params)
        s, rs = opt.init(p), ref_opt.init(rp)
        for i, g in enumerate(grads):
            p, s = opt.update(tree_map(torch.from_numpy, g), s, p, i)
            rp, rs = jax.jit(ref_opt.update)(jax.tree.map(jnp.asarray, g), rs, rp, jnp.asarray(i, jnp.int32))
        for (_, a), (_, b) in zip(tree_items(p), tree_items(jax.tree.map(np.asarray, rp))):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    # one norm for all agents: scaling one agent's gradient changes every agent's step
    opt = optimizers.clip_by_global_norm(optimizers.sgd(1.0), 1.0)
    g = tree_map(torch.from_numpy, grads[0])
    big = dict(g, a=torch.cat([g["a"][:1] * 100.0, g["a"][1:]]))
    p0 = tree_map(torch.from_numpy, params)
    assert not torch.equal(opt.update(g, (), p0, 0)[0]["b"], opt.update(big, (), p0, 0)[0]["b"])


def test_learning_rate_schedules_match_reference():
    """step_decay and the warmup bit for bit; the cosine parts within 4 ulps
    of lr (XLA's f32 cosine is not correctly rounded)."""
    pairs = [(schedule.cosine_decay(0.05, 200, 0.1), ref_schedule.cosine_decay(0.05, 200, 0.1), 0.05),
             (schedule.linear_warmup_cosine(0.1, 20, 250, 0.01), ref_schedule.linear_warmup_cosine(0.1, 20, 250, 0.01),
              0.1),
             (schedule.step_decay(0.1, (50, 120, 200), 0.3), ref_schedule.step_decay(0.1, (50, 120, 200), 0.3), 0.1)]
    steps = np.arange(0, 280, 3)
    for i, (fn, ref_fn, lr) in enumerate(pairs):
        want = np.asarray(jax.jit(jax.vmap(ref_fn))(jnp.asarray(steps, jnp.int32)), np.float64)
        got = np.array([fn(int(s)) for s in steps])
        assert all(float(np.float32(v)) == v for v in got)  # f32 values
        if i == 2:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2.0**-24 * lr)
            if i == 1:
                np.testing.assert_array_equal(got[steps < 20], want[steps < 20])
    assert schedule.constant(0.3)(7) == 0.3
