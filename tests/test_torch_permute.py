"""The neighbour-exchange engine (``PermuteConsensus``) against the reference.

* the exchange decompositions bit for bit (ring, chain, hypercube, torus2d,
  full, the paper's Erdos-Renyi);
* the plain versions of ``drt_dist`` (one call, and every slot of an
  exchange) and ``slab_source_combine`` against the Pallas kernels in
  interpret mode, at odd sizes;
* ``PermuteConsensus`` through ``spmd_run`` on the CPU against the
  reference's ``PermuteConsensus`` under ``shard_map`` on forced CPU
  devices (one subprocess for the module: XLA fixes its device count when
  it starts), with ``use_kernels`` False for every case and True for exact
  and int8 on the ring; the int8 wire of round 0 bit for bit;
* its ``path="tree"`` (the per-leaf rounds) against the reference's tree
  path in the same subprocess (ring and Erdos-Renyi, every config, 3
  rounds), against the port's slab path in process, with every kernel
  wrapper made to raise, and refusing what is not ported;
* the port's permute engine against its gather engine, in process;
* ``collective_bytes_per_step`` against the reference;
* with a churn schedule (ring/hypercube, agents and edges dropped, an
  isolated agent), momentum 0.4 and an adaptive round budget, on both
  paths, against the reference in the same subprocess; the adaptive gate's
  ``tol`` sits at the geometric mean of the 2nd and 3rd rounds'
  disagreements of the same configuration's fixed run (the port's gather
  engine), so last-bit differences cannot flip it, and the adaptive
  round-set equals the 2-round one bit for bit; the gate's global
  disagreement (``exchange.psum``) is the same bits on every rank;
* ``DistExchange`` under gloo (4 processes) bit for bit with
  ``ThreadExchange`` (``ppermute`` and ``psum``); ``spmd_run`` raising a
  failed rank's exception.

Tolerances: the reference holds its permute engine to its gather engine,
and its kernel engine to its jnp one, at rtol 2e-4, atol 2e-5
(``tests/test_distributed.py``); the port is held to the reference there.
Over 3 rounds, a last-bit difference after round 0 can flip one rounding
of a rounding wire (int8, bf16, f16): there one wire step is allowed in
under 1% of the elements.
"""
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.comm import accounting as ref_accounting
from repro.core import consensus as ref_consensus
from repro.core import topology as ref_topology
from repro.kernels.drt_dist import drt_dist as ref_drt_dist
from repro.kernels.slab_combine import slab_source_combine as ref_slab_source_combine
from repro_torch import PermuteConsensus, spmd_run
from repro_torch.comm import accounting, prng
from repro_torch.core import consensus, dynamic, topology
from repro_torch.core.drt import DRTConfig
from repro_torch.kernels import counters
from repro_torch.kernels.drt_dist import drt_dist, drt_dist_ref
from repro_torch.kernels.slab_combine import LANES, slab_source_combine
from repro_torch.obs.metrics import ObsConfig
from repro_torch.utils.pytree import LayerPartition, agent_template, tree_items, tree_map

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
RTOL, ATOL = 2e-4, 2e-5
CONFIGS = [("drt", None), ("drt", "int8"), ("drt", "bf16"), ("drt", "f16"), ("drt", "topk:0.25"),
           ("classical", None)]
TOPOLOGIES = ["ring", "hypercube", "chain", "erdos_renyi"]
KERNEL_CASES = [("ring", "drt", c, r) for c in (None, "int8") for r in (1, 3)]  # also use_kernels=True
TREE_TOPOLOGIES = ["ring", "erdos_renyi"]  # path="tree", every config, 3 rounds
RNG_SEED = 7
# the churn schedule cases: K=8, rounds start at SCHED_START of the schedule
SCHED_START = 5
SCHED_CASES = [  # (path, algorithm, codec, momentum, adaptive); top-k: EMPTY_CASES
    ("slab", "drt", None, 0.4, True), ("slab", "drt", "int8", 0.4, True), ("slab", "classical", None, 0.4, True),
    ("tree", "drt", "int8", 0.4, True),
]


# a K=4 churn schedule whose round 1 has no edge at all: the round is
# skipped (no momentum step), on both paths
EMPTY_CASES = [("slab", "topk:0.25"), ("tree", None)]


def _empty_round_schedule(mod=dynamic, topo_mod=topology):
    return mod.ChurnSchedule(mod.PeriodicSchedule((topo_mod.ring(4), topo_mod.make_topology("full", 4))),
                             agent_drop=0.25, seed=4)


def _schedule(mod=dynamic, topo_mod=topology):
    """The churn schedule of tests/test_edge.py: ring/hypercube, a quarter
    of the agents and a tenth of the edges dropped a round."""
    return mod.ChurnSchedule(mod.PeriodicSchedule((topo_mod.ring(8), topo_mod.hypercube(8))),
                             agent_drop=0.25, edge_drop=0.1, seed=5)


def _topology(name, mod=topology):
    if name == "erdos_renyi":
        return mod.erdos_renyi(8, 0.1, mod.PAPER_ER_SEED)
    return mod.make_topology(name, 4)


def _tree(K, seed=0):
    """The reference test's tree (tests/test_distributed.py), from numpy:
    a plain group and a stacked group of 3 slots, 4 DRT layers."""
    rng = np.random.default_rng(seed)
    return {"blocks": {"w": rng.normal(size=(K, 3, 8, 8)).astype(np.float32)},
            "embed": {"w": rng.normal(size=(K, 4, 8)).astype(np.float32)}}


def _key(topo, algo, codec, rounds, uk):
    return f"{topo}|{algo}|{codec}|{rounds}|{int(uk)}"


# -- the reference under shard_map, once per module ------------------------------

_REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import DRTConfig, packing
from repro.core import topology as T
from repro.core.consensus import PermuteConsensus
from repro.utils.pytree import LayerPartition

TOPOLOGIES, CONFIGS, KERNEL_CASES, TREE_TOPOLOGIES, SEED, SCHED_JOBS, SCHED_START, EMPTY_CASES = {args}
out = {{}}

def tree(K):
    rng = np.random.default_rng(0)
    return {{"blocks": {{"w": rng.normal(size=(K, 3, 8, 8)).astype(np.float32)}},
            "embed": {{"w": rng.normal(size=(K, 4, 8)).astype(np.float32)}}}}

for name in TOPOLOGIES:
    topo = T.erdos_renyi(8, 0.1, T.PAPER_ER_SEED) if name == "erdos_renyi" else T.make_topology(name, 4)
    K = topo.num_agents
    mesh = Mesh(np.array(jax.devices()[:K]), ("data",))
    pK = jax.tree.map(jnp.asarray, tree(K))
    part = LayerPartition.build(jax.tree.map(lambda x: x[0], pK))
    specs = jax.tree.map(lambda _: P("data"), pK)
    jobs = [(a, c, r, False, "slab") for a, c in CONFIGS for r in (1, 3)]
    jobs += [(a, c, r, True, "slab") for t, a, c, r in KERNEL_CASES if t == name]
    if name in TREE_TOPOLOGIES:
        jobs += [(a, c, 3, False, "tree") for a, c in CONFIGS]

    def body(local):
        sq = jax.tree.map(lambda x: x[0], local)
        res = []
        for a, c, r, uk, p in jobs:
            eng = PermuteConsensus(part, topo, DRTConfig(), axis_name="data", algorithm=a,
                                   codec=c, use_kernels=uk, path=p)
            o = eng(sq, rng=jax.random.key(SEED), rounds=r)
            res.append(jax.tree.map(lambda x: x[None], o[0] if c else o))
        return res

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(specs,), out_specs=[specs] * len(jobs),
                               check_vma=False))
    for (a, c, r, uk, p), res in zip(jobs, fn(pK)):
        head = "tree|" if p == "tree" else ""
        for path in ("blocks", "embed"):
            out[f"{{head}}{{name}}|{{a}}|{{c}}|{{r}}|{{int(uk)}}|{{path}}"] = np.asarray(res[path]["w"])

    # the int8 wire of round 0 of every rank: the encode the engine runs
    layout = packing.cached_slab_layout(part, jax.tree.map(lambda x: x[0], pK))
    codec = packing.Int8StochasticCodec()
    enc = jax.jit(lambda regs, key: packing.slab_encode(codec, layout, regs, (), key)[0])
    for k in range(K):
        regs = layout.pack_regions(jax.tree.map(lambda x: x[k], pK))
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(SEED), 0), k)
        w = enc(regs, key)
        out[f"wire|{{name}}|{{k}}|q"] = np.asarray(layout.join(w.q))
        out[f"wire|{{name}}|{{k}}|s"] = np.asarray(w.s)

from repro.core import dynamic as D
sched = D.ChurnSchedule(D.PeriodicSchedule((T.ring(8), T.hypercube(8))), agent_drop=0.25, edge_drop=0.1, seed=5)
mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
pK = jax.tree.map(jnp.asarray, tree(8))
part = LayerPartition.build(jax.tree.map(lambda x: x[0], pK))
specs = jax.tree.map(lambda _: P("data"), pK)

def sched_body(local):
    sq = jax.tree.map(lambda x: x[0], local)
    res = []
    for p, a, c, mom, tol in SCHED_JOBS:
        eng = PermuteConsensus(part, T.ring(8), DRTConfig(), axis_name="data", algorithm=a, codec=c, path=p,
                               schedule=sched, momentum=mom, round_tol=tol)
        o = eng(sq, rng=jax.random.key(SEED), rounds=3, start_round=SCHED_START)
        res.append(jax.tree.map(lambda x: x[None], o[0] if c else o))
    return res

fn = jax.jit(jax.shard_map(sched_body, mesh=mesh, in_specs=(specs,), out_specs=[specs] * len(SCHED_JOBS),
                           check_vma=False))
for (p, a, c, mom, tol), res in zip(SCHED_JOBS, fn(pK)):
    for path in ("blocks", "embed"):
        out[f"sched|{{p}}|{{a}}|{{c}}|{{mom}}|{{tol is not None}}|{{path}}"] = np.asarray(res[path]["w"])

sched4 = D.ChurnSchedule(D.PeriodicSchedule((T.ring(4), T.make_topology("full", 4))), agent_drop=0.25, seed=4)
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
pK = jax.tree.map(jnp.asarray, tree(4))
part = LayerPartition.build(jax.tree.map(lambda x: x[0], pK))
specs = jax.tree.map(lambda _: P("data"), pK)

def empty_body(local):
    sq = jax.tree.map(lambda x: x[0], local)
    res = []
    for p, c in EMPTY_CASES:
        eng = PermuteConsensus(part, T.ring(4), DRTConfig(), axis_name="data", codec=c, path=p, schedule=sched4,
                               momentum=0.4)
        o = eng(sq, rng=jax.random.key(SEED), rounds=3, start_round=0)
        res.append(jax.tree.map(lambda x: x[None], o[0] if c else o))
    return res

fn = jax.jit(jax.shard_map(empty_body, mesh=mesh, in_specs=(specs,), out_specs=[specs] * len(EMPTY_CASES),
                           check_vma=False))
for (p, c), res in zip(EMPTY_CASES, fn(pK)):
    for path in ("blocks", "embed"):
        out[f"empty|{{p}}|{{c}}|{{path}}"] = np.asarray(res[path]["w"])
np.savez(sys.argv[1], **out)
print("REFERENCE-OK", len(out))
"""


def _sched_tol(algo, codec, momentum):
    """The adaptive gate's tol for a schedule case: the geometric mean of
    the disagreements after rounds 1 and 2 of the same configuration's
    fixed 3-round run (the port's gather engine, the same keys), so rounds
    0 and 1 run and round 2 is gated off."""
    sched = _schedule()
    pK = {g: {"w": torch.from_numpy(x["w"])} for g, x in _tree(8).items()}
    part = LayerPartition.build(agent_template(pK))
    C, M = sched.mixing_stacks(SCHED_START, 3)
    kw = dict(codec=codec, rng=prng.key(RNG_SEED)) if codec else {}
    m = consensus.gather_consensus_rounds(part, pK, C, DRTConfig(), rounds=3, algorithm=algo, metropolis=M,
                                          momentum=momentum, obs=ObsConfig(), **kw)[-1]
    d = m.disagreement.double().numpy()
    assert d[0] > d[1] > d[2], d
    return float(np.sqrt(d[0] * d[1]))


def _sched_jobs():
    return [(p, a, c, mom, _sched_tol(a, c, mom) if adaptive else None) for p, a, c, mom, adaptive in SCHED_CASES]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference output, from one subprocess with 8 forced
    CPU devices (a K=4 mesh takes the first four)."""
    path = tmp_path_factory.mktemp("permute") / "reference.npz"
    code = _REFERENCE.format(args=repr((TOPOLOGIES, CONFIGS, KERNEL_CASES, TREE_TOPOLOGIES, RNG_SEED,
                                        _sched_jobs(), SCHED_START, EMPTY_CASES)))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    run = subprocess.run([sys.executable, "-c", code, str(path)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0 and "REFERENCE-OK" in run.stdout, run.stderr[-3000:]
    with np.load(path) as f:
        return dict(f)


class _Recording:
    """An exchange that records what its rank puts on the wire."""

    def __init__(self, inner, sent):
        self._inner, self._sent = inner, sent
        self.rank, self.size = inner.rank, inner.size

    def ppermute(self, tensors, perm):
        self._sent.setdefault(self.rank, []).append(tuple(t.clone() for t in tensors))
        return self._inner.ppermute(tensors, perm)


def _run_port(topo, algo, codec, rounds, sent=None, path="slab", start_round=0, **control):
    """The port's engine through spmd_run on the CPU: the agent-stacked
    result (numpy, per group).  ``control``: ``schedule``, ``momentum``,
    ``round_tol``."""
    K = topo.num_agents
    pK = {g: {"w": torch.from_numpy(x["w"])} for g, x in _tree(K).items()}
    part = LayerPartition.build(agent_template(pK))
    eng = PermuteConsensus(part, topo, DRTConfig(), algorithm=algo, codec=codec, path=path, **control)
    rng = prng.key(RNG_SEED) if codec else None

    def body(rank, ex):
        if sent is not None:
            ex = _Recording(ex, sent)
        out = eng(tree_map(lambda x: x[rank], pK), ex, rng=rng, rounds=rounds, start_round=start_round)
        return out[0] if codec else out

    outs = spmd_run(body, K, device="cpu")
    return {g: torch.stack([o[g]["w"] for o in outs]).numpy() for g in ("blocks", "embed")}


@pytest.fixture(scope="module")
def port_results():
    cache = {}

    def get(topo_name, algo, codec, rounds, path="slab"):
        key = (topo_name, algo, codec, rounds, path)
        if key not in cache:
            cache[key] = _run_port(_topology(topo_name), algo, codec, rounds, path=path)
        return cache[key]

    return get


def _wire_step(codec, x0):
    """An upper bound on one step of the rounding wire for values bounded
    by the initial agents' (mixing is convex, so absmax never grows)."""
    amax = max(float(np.abs(v["w"]).max()) for v in x0.values())
    return {"int8": 1.01 * amax / 127.0, "bf16": amax * 2.0**-7, "f16": amax * 2.0**-10}[codec]


def _assert_matches(got, want, codec, rounds, x0, label):
    for g in ("blocks", "embed"):
        a, b = got[g], want[g]
        assert a.shape == b.shape and np.isfinite(a).all(), label
        diff = np.abs(a - b)
        if codec in ("int8", "bf16", "f16") and rounds > 1:
            bad = diff > ATOL + RTOL * np.abs(b)
            assert bad.mean() < 0.01, (label, g, bad.mean())
            assert diff.max() <= _wire_step(codec, x0), (label, g, diff.max())
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"{label} {g}")


_PARITY = [(t, a, c, r, False) for t in TOPOLOGIES for a, c in CONFIGS for r in (1, 3)]
_PARITY += [(t, a, c, r, True) for t, a, c, r in KERNEL_CASES]


@pytest.mark.parametrize("topo,algo,codec,rounds,use_kernels", _PARITY)
def test_permute_engine_matches_reference(reference, port_results, topo, algo, codec, rounds, use_kernels):
    """The port's engine on the CPU (the kernels' plain versions) against
    the reference's under shard_map, with its jnp inner loops
    (use_kernels=False) and its Pallas kernels in interpret mode (True)."""
    got = port_results(topo, algo, codec, rounds)
    key = _key(topo, algo, codec, rounds, use_kernels)
    want = {g: reference[f"{key}|{g}"] for g in ("blocks", "embed")}
    _assert_matches(got, want, codec, rounds, _tree(_topology(topo).num_agents), key)


@pytest.mark.parametrize("topo", ["ring", "erdos_renyi"])
def test_round0_int8_wire_matches_reference_bit_for_bit(reference, topo):
    """Every rank's round-0 int8 wire (one ``slab_quant_encode`` of its
    slab under ``fold_in(fold_in(rng, 0), rank)``) equals the reference's."""
    t = _topology(topo)
    sent = {}
    _run_port(t, "drt", "int8", 1, sent=sent)
    for k in range(t.num_agents):
        q, s = sent[k][0]
        np.testing.assert_array_equal(q[0].numpy(), reference[f"wire|{topo}|{k}|q"])
        np.testing.assert_array_equal(s[0].numpy(), reference[f"wire|{topo}|{k}|s"])


# -- host-side pieces, in process ----------------------------------------------------


@pytest.mark.parametrize("name,K", [("ring", 2), ("ring", 5), ("ring", 16), ("chain", 5), ("hypercube", 8),
                                    ("torus2d", 4), ("torus2d", 9), ("full", 5), ("erdos_renyi", 16),
                                    ("star", 6)])
def test_decompositions_match_reference_bit_for_bit(name, K):
    kw = dict(p=0.1, seed=topology.PAPER_ER_SEED) if name == "erdos_renyi" else {}
    t, rt = topology.make_topology(name, K, **kw), ref_topology.make_topology(name, K, **kw)
    assert t.name == rt.name
    got, want = consensus.permutation_decomposition(t), ref_consensus.permutation_decomposition(rt)
    assert (got is None) == (want is None)
    for a, b in zip(got or [], want or []):
        np.testing.assert_array_equal(a, b)
    assert len(got or []) == len(want or [])
    got, want = consensus.matching_decomposition(t), ref_consensus.matching_decomposition(rt)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["ring", "chain", "hypercube", "torus2d", "erdos_renyi"])
@pytest.mark.parametrize("engine", ["gather", "permute"])
@pytest.mark.parametrize("codec", [None, "int8", "bf16", "topk:0.25"])
def test_collective_bytes_match_reference(name, engine, codec):
    t, rt = _topology(name), _topology(name, ref_topology)
    x = _tree(1)
    port_t = {g: {"w": torch.from_numpy(v["w"][0])} for g, v in x.items()}
    ref_t = {g: {"w": v["w"][0]} for g, v in x.items()}
    assert accounting.collective_bytes_per_step(t, port_t, engine, codec) == \
        ref_accounting.collective_bytes_per_step(rt, ref_t, engine, codec)
    if codec is None:
        assert accounting.collective_bytes_per_step(t, 4096, engine) == \
            ref_accounting.collective_bytes_per_step(rt, 4096, engine)


@pytest.mark.parametrize("n", [1, 127, 129, 40_000])
def test_drt_dist_plain_version_matches_pallas(n):
    """Sums of n nonnegative f32 terms in two orders: relative 1e-5 of each
    sum (about 80 ulps)."""
    rng = np.random.default_rng(n)
    x, y = rng.normal(size=(2, n)).astype(np.float32)
    want = np.asarray(ref_drt_dist(jax.numpy.asarray(x), jax.numpy.asarray(y), interpret=True))
    got = drt_dist(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(drt_dist_ref(torch.from_numpy(x), torch.from_numpy(y)).numpy(), got.numpy())


def test_drt_dist_slots_plain_version_matches_pallas_slot_by_slot():
    """The exchange-wide wrapper's plain version on the 4 layer slots of a
    tiny slab layout (and on slots of 1, 127, 129 and 2,049 columns, across
    the kernel's 2,048-column chunks) against the Pallas kernel per slot:
    relative 1e-5 of each sum; the kernel's chunk table covers each slot
    once, in order, its chunks consecutive."""
    from repro_torch.core.packing import build_slab_layout
    from repro_torch.kernels.drt_dist import CHUNK, drt_dist_slots, slot_table

    x0 = _tree(2)
    pK = {g: {"w": torch.from_numpy(v["w"])} for g, v in x0.items()}
    layout = build_slab_layout(LayerPartition.build(agent_template(pK)), agent_template(pK))
    slab = layout.pack(pK)
    odd = ((0, 1), (1, 128), (128, 257), (300, 2349))
    row = np.random.default_rng(4).normal(size=(2, 2349)).astype(np.float32)
    for slots, (x, y) in ((layout.slot_table_on(torch.device("cpu")), slab),
                          (slot_table(odd, "cpu"), torch.from_numpy(row))):
        got = drt_dist_slots(x, y, slots)
        assert got.shape == (len(slots.bounds), 2) and got.dtype == torch.float32
        for p, (s, e) in enumerate(slots.bounds):
            want = np.asarray(ref_drt_dist(jax.numpy.asarray(x[s:e].numpy()), jax.numpy.asarray(y[s:e].numpy()),
                                           interpret=True))
            np.testing.assert_allclose(got[p].numpy(), want, rtol=1e-5, atol=0)
            chunks = slots.chunks[slots.chunks[:, 2] == p].tolist()
            first = chunks[0][3]
            assert [c[:2] for c in chunks] == [[b, min(e, b + CHUNK)] for b in range(s, e, CHUNK)]
            assert all(c[3:] == [first, len(chunks)] for c in chunks)
            assert slots.chunks[first : first + len(chunks), 2].eq(p).all()
    assert slots.chunks[:, 2].tolist() == [0, 1, 2, 3, 3]
    with pytest.raises(ValueError, match="start < stop"):
        slot_table(((3, 3),), "cpu")
    with pytest.raises(ValueError, match="past"):
        drt_dist_slots(torch.from_numpy(row[0, :100]), torch.from_numpy(row[1, :100]), slot_table(odd, "cpu"))


@pytest.mark.parametrize("N,nb", [(1, 3), (3, 5), (5, 7), (7, 1)])
def test_slab_source_combine_plain_version_matches_pallas(N, nb):
    """The Pallas kernel's dot against the port's ordered loop (rounding
    product and sum apart): N rounded terms of O(1) values, 1e-6.  The
    sequence form (N separate (D,) rows, as the permute engine passes
    them) equals the stacked form bit for bit."""
    rng = np.random.default_rng(N * 10 + nb)
    w = rng.dirichlet(np.ones(N), size=nb).astype(np.float32)
    x = rng.normal(size=(N, nb * LANES)).astype(np.float32)
    want = np.asarray(ref_slab_source_combine(jax.numpy.asarray(w), jax.numpy.asarray(x),
                                                          interpret=True))
    got = slab_source_combine(torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    rows = [torch.from_numpy(x[n].copy()) for n in range(N)]
    assert torch.equal(slab_source_combine(torch.from_numpy(w), rows), got)
    loop = sum(float(w[0, n]) * x[n, :LANES].astype(np.float64) for n in range(N))
    np.testing.assert_allclose(got.numpy()[:LANES], loop, rtol=0, atol=1e-6)


def test_slab_source_combine_refuses_mismatched_sources_before_any_launch(monkeypatch):
    """Sequence form on card tensors: a source of another length, or on
    another device, raises ValueError before the kernel is even built."""
    from test_torch_hygiene import _on_card

    from repro_torch.kernels import slab_combine

    def launched(name):
        raise AssertionError(f"{name} was reached")

    monkeypatch.setattr(slab_combine, "_kernel", launched)
    nb = 2
    D = nb * LANES
    w = _on_card(nb, 2)
    with pytest.raises(ValueError, match="columns"):
        slab_source_combine(w, [_on_card(D), _on_card(D + LANES)])
    with pytest.raises(ValueError, match="device|on cpu"):
        slab_source_combine(w, [_on_card(D), torch.zeros(D)])
    with pytest.raises(ValueError, match="w_blocks must be"):
        slab_source_combine(w, [_on_card(D)] * 3)


@pytest.mark.parametrize("name,algo,codec", [("ring", "drt", None), ("ring", "classical", None),
                                             ("ring", "drt", "int8"), ("hypercube", "drt", "bf16"),
                                             ("erdos_renyi", "drt", None), ("chain", "drt", "topk:0.25")])
def test_permute_engine_matches_gather_engine(port_results, name, algo, codec):
    """The port's two engines on the same agents, 3 rounds (the same wire
    keys), at the reference's engine tolerance."""
    t = _topology(name)
    x0 = _tree(t.num_agents)
    pK = {g: {"w": torch.from_numpy(v["w"])} for g, v in x0.items()}
    part = LayerPartition.build(agent_template(pK))
    kw = dict(codec=codec, rng=prng.key(RNG_SEED)) if codec else {}
    want = consensus.gather_consensus_rounds(part, pK, t.c_matrix(), DRTConfig(), rounds=3, algorithm=algo,
                                             metropolis=t.metropolis(), **kw)[0]
    got = port_results(name, algo, codec, 3)
    _assert_matches(got, {g: want[g]["w"].numpy() for g in got}, codec, 3, x0, (name, algo, codec))


_TREE = [(t, a, c) for t in TREE_TOPOLOGIES for a, c in CONFIGS]


@pytest.mark.parametrize("topo,algo,codec", _TREE)
def test_permute_tree_path_matches_reference(reference, port_results, topo, algo, codec):
    """``path="tree"`` (the codec's per-leaf wire, one ``ppermute`` an
    exchange, ``sq_norms`` and ``scale_by_layer``) against the reference's
    tree path under shard_map, 3 rounds."""
    got = port_results(topo, algo, codec, 3, "tree")
    key = "tree|" + _key(topo, algo, codec, 3, False)
    want = {g: reference[f"{key}|{g}"] for g in ("blocks", "embed")}
    _assert_matches(got, want, codec, 3, _tree(_topology(topo).num_agents), key)


@pytest.mark.parametrize("topo,algo,codec", _TREE)
def test_permute_tree_path_matches_slab_path(port_results, topo, algo, codec):
    """The port's two permute paths on the same agents and keys, 3 rounds."""
    got = port_results(topo, algo, codec, 3, "tree")
    want = port_results(topo, algo, codec, 3)
    _assert_matches(got, want, codec, 3, _tree(_topology(topo).num_agents), (topo, algo, codec))


def test_permute_tree_path_calls_no_kernel(monkeypatch):
    """Every kernel wrapper the consensus module holds made to raise: the
    tree path runs (exact, int8, top-k, classical), the slab path does not."""
    def refuse(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"{name} was called")
        return fn

    wrappers = [n for n, f in vars(consensus).items()
                if callable(f) and getattr(f, "__module__", "").startswith("repro_torch.kernels.")]
    assert {"drt_dist_slots", "slab_source_combine", "slab_quant_encode"} <= set(wrappers)
    for n in wrappers:
        monkeypatch.setattr(consensus, n, refuse(n))
    t = topology.ring(4)
    for algo, codec in (("drt", None), ("drt", "int8"), ("drt", "topk:0.25"), ("classical", None)):
        got = _run_port(t, algo, codec, 2, path="tree")
        assert all(np.isfinite(v).all() for v in got.values())
    with pytest.raises(AssertionError, match="was called"):
        _run_port(t, "drt", None, 1)


def test_engine_without_edges_keeps_every_iterate():
    """No edge anywhere: the rounds exchange nothing and every agent keeps
    its iterate bit for bit (the top-k residual still advances)."""
    empty = topology.Topology("empty", np.zeros((3, 3), bool))
    assert consensus.exchange_decomposition(empty) == []
    pK = {g: {"w": torch.from_numpy(v["w"])} for g, v in _tree(3).items()}
    part = LayerPartition.build(agent_template(pK))
    eng = PermuteConsensus(part, empty, DRTConfig(), codec="topk:0.25")
    outs = spmd_run(lambda r, ex: eng(tree_map(lambda x: x[r], pK), ex, rounds=2), 3, device="cpu")
    for r, (out, res) in enumerate(outs):
        for (_, a), (_, b) in zip(tree_items(out), tree_items(tree_map(lambda x: x[r], pK))):
            assert torch.equal(a, b)
        assert any(bool((v != 0).any()) for _, v in tree_items(res))


@pytest.mark.parametrize("path,algo,codec,momentum,adaptive", SCHED_CASES)
def test_permute_engine_under_churn_and_control_matches_reference(reference, path, algo, codec, momentum,
                                                                  adaptive):
    """A churn schedule (rounds 5-7: agents isolated, phantom pairs),
    momentum and the adaptive gate, against the reference under shard_map
    at the engine tolerance (rounding wires by the wire-step rule); the
    exact and int8 DRT round-sets gated off at round 2 equal their 2-round
    sets bit for bit."""
    sched = _schedule()
    assert any(not sched.topology_at(SCHED_START + r).adjacency[k].any() for r in range(3) for k in range(8))
    tol = _sched_tol(algo, codec, momentum) if adaptive else None
    control = dict(schedule=sched, momentum=momentum, round_tol=tol)
    got = _run_port(topology.ring(8), algo, codec, 3, path=path, start_round=SCHED_START, **control)
    key = f"sched|{path}|{algo}|{codec}|{momentum}|{adaptive}"
    want = {g: reference[f"{key}|{g}"] for g in ("blocks", "embed")}
    _assert_matches(got, want, codec, 3, _tree(8), key)
    if adaptive and codec in (None, "int8") and algo == "drt":
        two = _run_port(topology.ring(8), algo, codec, 2, path=path, start_round=SCHED_START,
                        **dict(control, round_tol=None))
        for g in got:
            np.testing.assert_array_equal(got[g], two[g])


@pytest.mark.parametrize("path,codec", EMPTY_CASES)
def test_permute_round_without_edges_is_skipped_by_the_control(reference, path, codec):
    """Round 1 of this K=4 churn schedule has no edge: nothing is exchanged
    or combined, momentum takes no step there (x_prev stays), a top-k
    residual still advances; against the reference, momentum 0.4."""
    sched = _empty_round_schedule()
    assert [int(sched.topology_at(t).adjacency.sum()) for t in range(3)][1] == 0
    got = _run_port(topology.ring(4), "drt", codec, 3, path=path, schedule=sched, momentum=0.4)
    want = {g: reference[f"empty|{path}|{codec}|{g}"] for g in ("blocks", "embed")}
    _assert_matches(got, want, codec, 3, _tree(4), (path, codec))


def test_permute_engine_schedule_matches_gather_engine():
    """The port's permute engine over the churn schedule with momentum
    against its gather engine over the same rounds' stacks, exact DRT, at
    the engine tolerance; a static schedule equals the schedule-free engine
    bit for bit."""
    path = "slab"
    sched = _schedule()
    pK = {g: {"w": torch.from_numpy(x["w"])} for g, x in _tree(8).items()}
    part = LayerPartition.build(agent_template(pK))
    C, M = sched.mixing_stacks(SCHED_START, 3)
    want = consensus.gather_consensus_rounds(part, pK, C, DRTConfig(), rounds=3, metropolis=M, momentum=0.4)[0]
    got = _run_port(topology.ring(8), "drt", None, 3, path=path, start_round=SCHED_START, schedule=sched,
                    momentum=0.4)
    _assert_matches(got, {g: want[g]["w"].numpy() for g in got}, None, 3, _tree(8), path)
    static = _run_port(topology.ring(8), "drt", None, 2, path=path, start_round=3,
                       schedule=dynamic.StaticSchedule(topology.ring(8)))
    plain = _run_port(topology.ring(8), "drt", None, 2, path=path)
    for g in static:
        np.testing.assert_array_equal(static[g], plain[g])


def test_gate_reads_the_same_bits_on_every_rank():
    """The global disagreement the gate compares with tol: one psum of each
    rank's slab and one of the local sums, identical bits on all 8 ranks,
    and equal (to f32 rounding) to the gather engine's slab disagreement."""
    from repro_torch.core import packing

    pK = {g: {"w": torch.from_numpy(x["w"])} for g, x in _tree(8).items()}
    part = LayerPartition.build(agent_template(pK))
    eng = PermuteConsensus(part, topology.ring(8), DRTConfig(), round_tol=1.0)
    layout = packing.build_slab_layout(part, agent_template(pK))
    slab = layout.pack(pK)
    vals = spmd_run(lambda r, ex: eng._global_disagreement(ex, slab[r].clone()), 8, device="cpu")
    assert all(torch.equal(v, vals[0]) for v in vals)
    want = packing.slab_disagreement(slab, layout)
    assert abs(float(vals[0]) - float(want)) <= 1e-6 * float(want), (float(vals[0]), float(want))


def test_unported_options_raise():
    """Tensor-parallel norms still raise, naming their ROADMAP item;
    telemetry runs (tests/test_torch_obs.py holds it against the
    reference); the control knobs are validated, and a schedule needs an int
    start round and the topology's K."""
    pK = {g: {"w": torch.from_numpy(v["w"])} for g, v in _tree(4).items()}
    part = LayerPartition.build(agent_template(pK))
    t = topology.ring(4)
    for kw in (dict(norm_reduce_axes=("model",)),):
        eng = PermuteConsensus(part, t, DRTConfig(), **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            spmd_run(lambda r, ex: eng(tree_map(lambda x: x[r], pK), ex), 4, device="cpu")
    eng = PermuteConsensus(part, t, DRTConfig())
    out = spmd_run(lambda r, ex: eng(tree_map(lambda x: x[r], pK), ex, obs=ObsConfig()), 4, device="cpu")
    assert all(len(o) == 2 and o[1].disagreement.shape == (1,) for o in out)
    with pytest.raises(ValueError, match="rounds"):
        spmd_run(lambda r, ex: eng(tree_map(lambda x: x[r], pK), ex, rounds=0), 4, device="cpu")
    with pytest.raises(ValueError, match="stochastic"):  # int8 needs a key
        eng8 = PermuteConsensus(part, t, DRTConfig(), codec="int8")
        spmd_run(lambda r, ex: eng8(tree_map(lambda x: x[r], pK), ex), 4, device="cpu")
    for kw, err in ((dict(momentum=1.0), ValueError), (dict(round_tol=0.0), ValueError),
                    (dict(schedule=object()), TypeError),
                    (dict(schedule=dynamic.StaticSchedule(topology.ring(8))), ValueError)):
        bad = PermuteConsensus(part, t, DRTConfig(), **kw)
        with pytest.raises(err):
            spmd_run(lambda r, ex: bad(tree_map(lambda x: x[r], pK), ex), 4, device="cpu")
    sched_eng = PermuteConsensus(part, t, DRTConfig(), schedule=dynamic.StaticSchedule(t))
    with pytest.raises(TypeError, match="start_round"):
        spmd_run(lambda r, ex: sched_eng(tree_map(lambda x: x[r], pK), ex, start_round=1.0), 4, device="cpu")


def test_tree_path_refuses_unported_options():
    """``path="tree"`` runs, telemetry included, but still refuses every
    option the port has not ported, naming its ROADMAP item; an unknown
    path is a ValueError."""
    pK = {g: {"w": torch.from_numpy(v["w"])} for g, v in _tree(4).items()}
    part = LayerPartition.build(agent_template(pK))
    t = topology.ring(4)
    for kw, item in ((dict(norm_reduce_axes=("model",)), "tensor-parallel norms"),):
        eng = PermuteConsensus(part, t, DRTConfig(), path="tree", **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP") as e:
            spmd_run(lambda r, ex: eng(tree_map(lambda x: x[r], pK), ex), 4, device="cpu")
        assert item in str(e.value), (kw, str(e.value))
    eng = PermuteConsensus(part, t, DRTConfig(), path="tree")
    out = spmd_run(lambda r, ex: eng(tree_map(lambda x: x[r], pK), ex, obs=ObsConfig()), 4, device="cpu")
    assert all(len(o) == 2 and o[1].disagreement.shape == (1,) for o in out)
    with pytest.raises(ValueError, match="path"):
        eng = PermuteConsensus(part, t, DRTConfig(), path="edge")
        spmd_run(lambda r, ex: eng(tree_map(lambda x: x[r], pK), ex), 4, device="cpu")


# -- the exchanges -------------------------------------------------------------------


def test_thread_exchange_has_ppermute_semantics():
    """Receivers get their source's tensors, unnamed receivers zeros, self
    pairs their own tensors; results come back in rank order."""
    def body(rank, ex):
        x = (torch.full((3,), float(rank)), torch.tensor([rank], dtype=torch.int8))
        shift = ex.ppermute(x, [(0, 1), (1, 2), (2, 0)])  # rank 3 is named by no pair
        swap = ex.ppermute(x, [(0, 1), (1, 0), (2, 2), (3, 3)])
        return shift, swap

    outs = spmd_run(body, 4, device="cpu")
    assert [float(o[0][0][0]) for o in outs] == [2.0, 0.0, 1.0, 0.0]
    assert [int(o[0][1][0]) for o in outs] == [2, 0, 1, 0]
    assert [float(o[1][0][0]) for o in outs] == [1.0, 0.0, 2.0, 3.0]


def _within(seconds, fn):
    """Run ``fn`` in a thread; fail if it has not returned after ``seconds``."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except Exception as e:  # handed to the test below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds} s"
    return box


def test_spmd_run_raises_the_failed_ranks_exception_within_seconds():
    def body(rank, ex):
        if rank == 2:
            raise KeyError("rank 2 failed")
        return ex.ppermute((torch.zeros(2),), [(0, 1), (1, 0)])

    t0 = time.perf_counter()
    box = _within(10, lambda: spmd_run(body, 4, device="cpu", timeout=30))
    assert isinstance(box.get("err"), KeyError), box
    assert time.perf_counter() - t0 < 5

    def mismatched(rank, ex):  # rank 0 exchanges once more than the others
        for _ in range(2 if rank == 0 else 1):
            ex.ppermute((torch.zeros(2),), [(0, 1), (1, 0)])

    box = _within(10, lambda: spmd_run(mismatched, 2, device="cpu", timeout=1.0))
    assert isinstance(box.get("err"), threading.BrokenBarrierError), box


def test_launch_counter_is_exact_across_threads():
    """16 threads bump one counter 1,000 times each, with a short switch
    interval so they interleave: no update is lost."""
    def fn():
        pass

    fn.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [counters.bump(fn) for _ in range(1000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == 16_000


_DIST_RANK = r"""
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch import PermuteConsensus
from repro_torch.comm import prng
from repro_torch.comm.exchange import DistExchange
from repro_torch.core.drt import DRTConfig
from repro_torch.core.topology import ring
from repro_torch.utils.pytree import LayerPartition, agent_template, tree_map

torch.set_num_threads(1)
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4)
try:
    x = np.load(out + ".in.npz")
    pK = {g: {"w": torch.from_numpy(x[g])} for g in ("blocks", "embed")}
    part = LayerPartition.build(agent_template(pK))
    ex = DistExchange()
    res = {"psum": ex.psum(torch.arange(5, dtype=torch.float32) * (rank + 1)).numpy()}
    for codec in (None, "int8"):
        eng = PermuteConsensus(part, ring(4), DRTConfig(), codec=codec)
        o = eng(tree_map(lambda t: t[rank], pK), ex, rng=prng.key(7), rounds=3)
        o = o[0] if codec else o
        for g in ("blocks", "embed"):
            res[f"{codec}|{g}"] = o[g]["w"].numpy()
    np.savez(f"{out}.{rank}.npz", **res)
finally:
    dist.destroy_process_group()
"""


def test_dist_exchange_under_gloo_matches_thread_exchange(tmp_path):
    """4 processes on the ring, exact and int8 DRT, 3 rounds each: the same
    bits as 4 threads; ``psum`` sums the 4 ranks' tensors on every rank."""
    x0 = _tree(4)
    base = str(tmp_path / "dist")
    np.savez(base + ".in.npz", **{g: v["w"] for g, v in x0.items()})
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, "-c", _DIST_RANK, str(r), str(port), base], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        logs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in logs]
    for r in range(4):
        with np.load(f"{base}.{r}.npz") as f:
            np.testing.assert_array_equal(f["psum"], np.arange(5, dtype=np.float32) * 10)
    for codec in (None, "int8"):
        want = _run_port(topology.ring(4), "drt", codec, 3)
        for r in range(4):
            with np.load(f"{base}.{r}.npz") as f:
                for g in ("blocks", "embed"):
                    np.testing.assert_array_equal(f[f"{codec}|{g}"], want[g][r])


def test_dist_exchange_refuses_cuda_tensors_under_gloo():
    """No silent staging through the host: a CUDA tensor under gloo raises."""
    from repro_torch.comm import exchange

    class _OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    ex = exchange.DistExchange.__new__(exchange.DistExchange)
    ex._dist, ex.group, ex.rank, ex.size, ex._backend = torch.distributed, None, 0, 2, "gloo"
    t = torch.zeros(2).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="gloo"):
        ex.ppermute((t,), [(0, 1), (1, 0)])
