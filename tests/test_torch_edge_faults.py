"""Faults and trust reweighting on the gather engine's edge path, against
the reference.

* ``faults.reweight_edge`` against ``repro.faults.robust.reweight_edge`` on
  the same numpy factors (temperature, clip, both; padding edges keep
  weight 0): 1e-6 (``p ** (1/temp)`` and the per-destination sums are libm
  and summation-order apart).
* The edge wrappers' options on the CPU (their plain versions):
  ``reweight`` runs between the factors and the combine, and the call
  returns the reweighted factors; ``return_d2e`` gives the per-edge
  distances of ``packing.edge_sq_dists``; ``slab_encode_combine``'s
  ``return_gram`` gives the wire view's per-layer Gram.  Bit for bit: the
  same operations in the same order.
* ``gather_consensus_rounds(path="edge")`` under sign-flip, Gauss and stale
  faults with ``trust_clip`` and ``trust_temp``, exact and coded, DRT and
  classical, with and without CSR tables (K=4 ring, 3 rounds, one
  Byzantine agent), against the reference's edge round-sets (one jitted
  program): parameters 1e-5 (int8 and top-k: within ``rounds``
  quantization steps, a rounding or threshold flipped after round 0), ``A``
  and the suspicion 1e-5 (int8 and top-k 1e-3), the whole telemetry
  record as ``tests/test_torch_obs.py`` holds it.
* A trainer epoch with ``consensus_path="edge"``, ``byzantine=0.25``,
  sign flip, stale delivery and ``trust_clip`` against the reference
  trainer's (loss 1e-6, parameters 1e-5, the disagreement 1e-6 of
  ``mean_k ||x_k||^2``); ``make_many_steps(obs=)`` stacks every step's
  full record.
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
from repro.core import topology as ref_topology
from repro.core.drt import DRTConfig as RefDRTConfig
from repro.faults import robust as ref_robust
from repro.obs import ObsConfig as RefObsConfig
from repro.optim import optimizers as ref_optim
from repro.utils.pytree import LayerPartition as RefLayerPartition
from repro_torch import faults
from repro_torch.comm import prng
from repro_torch.core import consensus, dynamic, packing, topology
from repro_torch.core.decentralized import DecentralizedTrainer, TrainerConfig
from repro_torch.core.drt import DRTConfig
from repro_torch.kernels import slab_codec, slab_segment
from repro_torch.obs.metrics import ConsensusMetrics, ObsConfig
from repro_torch.optim import optimizers
from repro_torch.utils.pytree import LayerPartition, agent_template, tree_items, tree_map

torch.set_num_threads(1)
K, ROUNDS, CLIP, TEMP = 4, 3, 0.3, 0.5
EXACT_FIELDS = ("wire_send_bytes", "wire_recv_bytes", "compression_ratio", "edges", "effective_rounds")


def _tree(seed=0, k=K):
    rng = np.random.default_rng(seed)
    return {"blocks": {"w": rng.normal(size=(k, 3, 8, 8)).astype(np.float32)},
            "embed": {"w": rng.normal(size=(k, 4, 8)).astype(np.float32)}}


def _compiled(fn, *args):
    """``fn(*args)`` as one jitted program at XLA's lowest backend
    optimization level (faster to compile), results as numpy."""
    return jax.tree.map(np.asarray, jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args))


def test_reweight_edge_matches_reference():
    rng = np.random.default_rng(4)
    L, E = 3, 10
    src = np.array([1, 3, 0, 2, 0, 2, 1, 3, 0, 0], np.int32)
    dst = np.array([0, 0, 1, 1, 2, 2, 3, 3, 0, 0], np.int32)
    A_e = rng.uniform(0.05, 0.6, size=(L, E)).astype(np.float32)
    A_e[:, 8:] = 0.0  # padding edges
    A_self = rng.uniform(0.1, 0.5, size=(L, K)).astype(np.float32)
    knobs = [(CLIP, None), (None, TEMP), (CLIP, TEMP), (0.2, 2.0)]
    want = _compiled(lambda a_s, a_e: [ref_robust.reweight_edge(a_s, a_e, jnp.asarray(dst), K, c, t)
                                       for c, t in knobs], A_self, A_e)
    for (c, t), (w_self, w_e) in zip(knobs, want):
        got_self, got_e = faults.reweight_edge(torch.from_numpy(A_self), torch.from_numpy(A_e),
                                               torch.from_numpy(dst), K, c, t)
        np.testing.assert_allclose(got_self.numpy(), w_self, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_e.numpy(), w_e, rtol=0, atol=1e-6)
        assert not got_e[:, 8:].any()
        if c is not None:
            assert float(got_e.max()) <= np.float32(c)
    with pytest.raises(ValueError, match="trust_clip"):
        faults.reweight_edge(torch.from_numpy(A_self), torch.from_numpy(A_e), torch.from_numpy(dst), K, clip=0.0)


def test_edge_wrappers_reweight_between_factors_and_combine_and_return_their_stats():
    pK = tree_map(torch.from_numpy, _tree())
    layout = packing.build_slab_layout(LayerPartition.build(agent_template(pK)), agent_template(pK))
    L = layout.num_layers
    slab = layout.pack(pK)
    bl = layout.block_layer_on(slab.device)
    edges = dynamic.edge_stacks_from_topology(topology.ring(K), 1)
    src, dst = (t[0].to(torch.int32) for t in edges[:2])
    w = edges.w[0].float()
    nbr, pos, valid, _ = dynamic.csr_from_edges(src, dst, w, K, 2)

    def rw(a_self, a_e):
        return faults.reweight_edge(a_self, a_e, dst, K, CLIP, TEMP)

    calls = {
        "csr": (lambda **o: slab_segment.slab_edge_encode_combine(bl, slab, (slab,), src, dst, w, nbr, pos, valid,
                                                                  mode="exact", num_layers=L, **o),
                lambda a_self, a_e: slab_segment.csr_combine_ref(bl, slab, slab, nbr, pos, valid, a_self, a_e)),
        "scatter": (lambda **o: slab_segment.slab_edge_combine(bl, slab, slab, src, dst, w, num_layers=L, **o),
                    lambda a_self, a_e: packing.edge_combine(a_self, a_e, src, dst, slab, slab, bl)),
    }
    for name, (call, combine) in calls.items():
        out, A_self, A_e = call()
        out_r, A_self_r, A_e_r, d2e = call(reweight=rw, return_d2e=True)
        want_self, want_e = rw(A_self, A_e)
        assert torch.equal(A_self_r, want_self) and torch.equal(A_e_r, want_e), name
        assert torch.equal(out_r, combine(want_self, want_e)) and not torch.equal(out_r, out), name
        assert torch.equal(d2e, packing.edge_sq_dists(slab, src, dst, bl, L)), name
        assert call(algorithm="classical", return_d2e=True)[3] is None, name
    C = torch.from_numpy(topology.ring(K).c_matrix()).float()
    out, A, G = slab_codec.slab_encode_combine(bl, slab, (), C, mode="bf16", num_layers=L, return_gram=True)
    plain = slab_codec.slab_encode_combine(bl, slab, (), C, mode="bf16", num_layers=L)
    assert torch.equal(out, plain[0]) and torch.equal(A, plain[1])
    dec = slab.to(torch.bfloat16).float()
    np.testing.assert_allclose(G.numpy(), layout.gram(layout.split(dec)).numpy(), rtol=1e-6, atol=1e-4)
    assert slab_codec.slab_encode_combine(bl, slab, (), C, mode="bf16", algorithm="classical", num_layers=L,
                                          return_gram=True)[2] is None


# (name, codec, algorithm, fault model, stale, trust keywords, CSR)
CASES = [
    ("exact-signflip-clip-csr", None, "drt", "sign_flip", 0.0, dict(trust_clip=CLIP), True),
    ("exact-stale-temp-scatter", None, "drt", None, 0.4, dict(trust_temp=TEMP), False),
    ("int8-gauss-clip-temp-csr", "int8", "drt", "gauss:0.3", 0.0, dict(trust_clip=CLIP, trust_temp=TEMP), True),
    ("bf16-signflip-classical-clip-scatter", "bf16", "classical", "sign_flip", 0.0, dict(trust_clip=CLIP), False),
    ("topk-stale-gauss-clip-csr", "topk:0.25", "drt", "gauss:0.3", 0.4, dict(trust_clip=CLIP), True),
]
IDS = [c[0] for c in CASES]


def _plan(pkg, fault, stale):
    return pkg.make_fault_plan(K, byzantine=0.25 if fault else 0.0, fault_model=fault, stale=stale, seed=1)


def _case_kw(case, pkg_topology, pkg_dynamic, key):
    _, codec, algo, _, _, trust, csr = case
    t = pkg_topology.ring(K)
    kw = dict(rounds=ROUNDS, algorithm=algo, metropolis=t.metropolis(), path="edge",
              edges=pkg_dynamic.edge_stacks_from_topology(t, ROUNDS), **trust)
    if csr:
        kw["max_in_degree"] = 2
    if codec:
        kw.update(codec=codec, rng=key)
    return t.c_matrix(), kw


@pytest.fixture(scope="module")
def reference():
    tree = _tree(1)
    part = RefLayerPartition.build(jax.tree.map(lambda x: x[0], tree))

    def run(psi):
        out = {}
        for case in CASES:
            C, kw = _case_kw(case, ref_topology, ref_dynamic, jax.random.key(7))
            res = ref_consensus.gather_consensus_rounds(part, psi, C, RefDRTConfig(), obs=RefObsConfig(),
                                                        faults=_plan(ref_faults, case[3], case[4]).realize(2, ROUNDS),
                                                        **kw)
            out[case[0]] = (res[0], res[1], res[-1])
        return out

    return _compiled(run, jax.tree.map(jnp.asarray, tree))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_edge_faults_match_reference(reference, case):
    new_r, A_r, m_r = reference[case[0]]
    pK = tree_map(torch.from_numpy, _tree(1))
    C, kw = _case_kw(case, topology, dynamic, prng.key(7))
    real = _plan(faults, case[3], case[4]).realize(2, ROUNDS, "cpu")
    new, A, *_, m = consensus.gather_consensus_rounds(LayerPartition.build(agent_template(pK)), pK, C, DRTConfig(),
                                                      obs=ObsConfig(), faults=real, **kw)
    coarse = case[1] in ("int8", "topk:0.25")
    x_max = max(float(np.abs(x).max()) for _, x in tree_items(new_r))
    for (_, a), (_, b) in zip(tree_items(new), tree_items(new_r)):
        assert float(np.abs(a.numpy() - b).max()) <= (ROUNDS * x_max / 127.0 if coarse else 1e-5), case[0]
    tol = 1e-3 if coarse else 1e-5
    np.testing.assert_allclose(A.numpy(), A_r, rtol=0, atol=tol)
    assert isinstance(m, ConsensusMetrics) and m._fields == tuple(m_r._fields)
    for name in m._fields:
        a, b = getattr(m, name).numpy(), getattr(m_r, name)
        if name in EXACT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(float(np.abs(b).max()), 1e-6) + 1e-6,
                                       err_msg=name)
    if case[3] is not None:
        assert float(m.byzantine_weight_mass.max()) > 0.0
    if case[1] == "topk:0.25":
        assert float(m.ef_residual.min()) > 0.0


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


def test_trainer_byzantine_on_the_edge_path_matches_reference():
    rng = np.random.default_rng(1)
    params = _mlp_params(0)
    batches = {"x": rng.normal(size=(2, K, BATCH, D_IN)).astype(np.float32),
               "y": rng.integers(0, N_CLS, size=(2, K, BATCH)).astype(np.int32)}
    cfg = dict(algorithm="drt", consensus_steps=3, consensus_path="edge", byzantine=0.25, fault_model="sign_flip",
               fault_seed=2, stale=0.3, trust_clip=CLIP)
    tr = DecentralizedTrainer(_port_losses, None, optimizers.momentum(0.05, 0.9), topology.ring(K),
                              TrainerConfig(**cfg), device="cpu")
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
    # make_many_steps(obs=) stacks each step's full record: (steps, rounds, ...)
    many = tr.make_many_steps(obs=ObsConfig())
    _, out = many(tr.state_from_params(tree_map(torch.from_numpy, params)), batches)
    rec = out["consensus"]
    assert isinstance(rec, ConsensusMetrics) and rec.layer_d2_mean.shape[:2] == (2, 3)
    assert rec.suspicion.shape == (2, 3, K) and float(rec.byzantine_weight_mass.min()) > 0.0
