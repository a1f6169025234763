"""The port's CUDA kernels on the card.

These tests need a CUDA device: they are marked ``gpu`` and skip without
one.  The file imports torch and the port only (the GPU machine has no
JAX); run it there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.slab_combine import LANES, MAX_AGENTS, slab_combine, slab_combine_ref


def _inputs(K, nb, seed=0, pad_cols=3):
    rng = np.random.default_rng(seed)
    A = np.ascontiguousarray(rng.dirichlet(np.ones(K), size=(nb, K)).swapaxes(1, 2), np.float32)
    slab = rng.normal(size=(K, nb * LANES)).astype(np.float32)
    slab.reshape(K, nb, LANES)[:, :, LANES - pad_cols :] = 0.0
    return torch.from_numpy(A).cuda(), torch.from_numpy(slab).cuda()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("K,nb", [(3, 1), (4, 5), (16, 2416), (MAX_AGENTS, 3),
                                  (3, 3), (3, 2417), (16, 1), (16, 3), (16, 2417), (MAX_AGENTS, 1),
                                  (MAX_AGENTS, 2417), (5, 7)])
def test_slab_combine_kernel_matches_plain_version(cuda, K, nb):
    """f32 sums of K products in another order: 1e-5 absolute on O(1)
    values; padding lanes stay exactly zero; one launch counted."""
    A, slab = _inputs(K, nb)
    before = slab_combine.launches
    out = slab_combine(A, slab)
    torch.cuda.synchronize()
    assert slab_combine.launches == before + 1
    torch.testing.assert_close(out, slab_combine_ref(A, slab), rtol=0, atol=1e-5)
    assert torch.all(out.view(K, nb, LANES)[:, :, LANES - 3 :] == 0)


@pytest.mark.gpu
def test_slab_combine_kernel_rejects_what_it_does_not_take(cuda):
    A, slab = _inputs(4, 2)
    with pytest.raises(ValueError, match="agents"):
        slab_combine(*_inputs(MAX_AGENTS + 1, 1))
    with pytest.raises(TypeError):
        slab_combine(A.double(), slab.double())
    with pytest.raises(ValueError, match="contiguous"):
        slab_combine(A.transpose(1, 2), slab)
    with pytest.raises(ValueError):
        slab_combine(A, slab.cpu())
    # TMA needs a 16-byte aligned base: a slab seen 4 bytes into its storage
    wide = torch.zeros(4 * 2 * LANES + 1, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        slab_combine(A, wide[1:].view(4, 2 * LANES))


def _codec_inputs(K, nb, L=3, seed=0):
    """Seeded operands of the coded-round kernels on the card: a slab,
    the int8 wire operands, a top-k-like sent slab and a sorted
    block -> layer map covering every layer."""
    from repro_torch.comm.prng import words_to_tensor

    rng = np.random.default_rng(seed)
    D = nb * LANES
    slab = rng.normal(size=(K, D)).astype(np.float32)
    n_segs, n_leaves = 4, 6
    scales = (np.abs(slab).max() / 127.0 * rng.uniform(0.5, 1.0, size=(K, n_segs))).astype(np.float32)
    col_seg = np.sort(rng.integers(0, n_segs, D)).astype(np.int32)
    col_leaf = np.sort(rng.integers(0, n_leaves, D)).astype(np.int32)
    col_idx = rng.integers(0, 2**31, D).astype(np.int32)
    w = rng.integers(0, 2**32, size=(2, K, n_leaves), dtype=np.uint64).astype(np.uint32)
    bl = np.sort(np.concatenate([np.arange(L), rng.integers(0, L, max(nb - L, 0))]))[:nb].astype(np.int32)
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    int8_ops = (t(scales), t(col_seg), t(col_leaf), t(col_idx),
                words_to_tensor(w[0], "cuda"), words_to_tensor(w[1], "cuda"))
    sent = t(np.where(np.abs(slab) > 1.0, slab, 0.0).astype(np.float32))
    return t(slab), int8_ops, sent, t(bl), L


@pytest.mark.gpu
@pytest.mark.parametrize("K,nb", [(3, 1), (5, 7), (16, 2416), (MAX_AGENTS, 3),
                                  (1, 1), (1, 2417), (2, 3), (7, 5), (16, 7), (17, 3), (MAX_AGENTS, 7)])
def test_slab_quant_encode_kernel_is_bit_exact(cuda, K, nb):
    """The int8 wire is integer arithmetic and IEEE division: bit for bit
    the plain version at K = 1 (the permute engine's rank slab) up to 64
    and at odd widths; one launch counted."""
    from repro_torch.kernels.slab_codec import slab_quant_encode, slab_quant_encode_ref

    slab, ops, _, _, _ = _codec_inputs(K, nb)
    before = slab_quant_encode.launches
    q = slab_quant_encode(*ops, slab)
    torch.cuda.synchronize()
    assert slab_quant_encode.launches == before + 1
    assert q.dtype == torch.int8
    assert torch.equal(q, slab_quant_encode_ref(*ops, slab))


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["drt", "classical"])
@pytest.mark.parametrize("mode", ["int8", "bf16", "f16", "sent"])
@pytest.mark.parametrize("K,nb", [(3, 2), (5, 7), (16, 2416), (MAX_AGENTS, 3)])
def test_slab_encode_combine_kernel_matches_plain_version(cuda, mode, algorithm, K, nb):
    """The wire view is exact on both sides; the Gram and the combine sum
    in another order (the plain version's index_add_ in an order that
    changes from run to run) and the mixing math uses CUDA's logf/expf:
    out within 1e-5 on O(1) values, A within 5e-6 (as in chip_smoke.py).
    Two calls give the same bits; the launch counter advances by the
    stated launches per call, and the int8 wire is hashed in-kernel (no
    ``slab_quant_encode`` launch).  K = MAX_AGENTS fills the combine
    kernel's 48 KB of default shared memory."""
    from repro_torch.core.topology import ring
    from repro_torch.kernels import slab_codec

    slab, int8_ops, sent, bl, L = _codec_inputs(K, nb, seed=K + nb)
    ops = {"int8": int8_ops, "sent": (sent,)}.get(mode, ())
    topo = ring(K)
    mix = torch.as_tensor(topo.c_matrix() if algorithm == "drt" else topo.metropolis(),
                          dtype=torch.float32).cuda()
    kw = dict(mode=mode, algorithm=algorithm, num_layers=L, N_clip=2.0 * K)
    before = (slab_codec.slab_encode_combine.launches, slab_codec.slab_quant_encode.launches)
    out, A = slab_codec.slab_encode_combine(bl, slab, ops, mix, **kw)
    out2, A2 = slab_codec.slab_encode_combine(bl, slab, ops, mix, **kw)
    torch.cuda.synchronize()
    per_call = slab_codec.LAUNCHES_PER_CALL[algorithm]
    assert (slab_codec.slab_encode_combine.launches, slab_codec.slab_quant_encode.launches) == (
        before[0] + 2 * per_call, before[1])
    assert torch.equal(out, out2) and torch.equal(A, A2)
    assert not _tickets_left().any()
    out_ref, A_ref = slab_codec.slab_encode_combine_ref(bl, slab, ops, mix, **kw)
    torch.testing.assert_close(out, out_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(A, A_ref.expand_as(A), rtol=0, atol=5e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["drt", "classical"])
@pytest.mark.parametrize("mode", ["int8", "sent"])
def test_slab_encode_combine_kernel_with_an_isolated_agents_column(cuda, mode, algorithm):
    """A churned round's mixing structure: agent 2's C column keeps only
    its diagonal (its Metropolis column is e_2) and agent 5 has one
    neighbour.  int8 and the exact wire (``sent`` = the slab itself), at
    K = 8 and at the width-16 slab's 2,416 blocks: out within 1e-5 and A
    within 5e-6 of the plain version; the isolated agent's output is its
    own slab and its A column e_2, bit for bit."""
    from repro_torch.core.dynamic import c_from_adjacency, metropolis_from_adjacency
    from repro_torch.core.topology import hypercube
    from repro_torch.kernels import slab_codec

    K = 8
    adj = torch.as_tensor(hypercube(K).adjacency, dtype=torch.float32)
    adj[2, :] = adj[:, 2] = 0.0
    adj[5, :] = adj[:, 5] = 0.0
    adj[5, 4] = adj[4, 5] = 1.0
    mix = (c_from_adjacency(adj) if algorithm == "drt" else metropolis_from_adjacency(adj)).cuda().contiguous()
    for nb in (7, 2416):
        slab, int8_ops, _, bl, L = _codec_inputs(K, nb, seed=nb)
        ops = int8_ops if mode == "int8" else (slab.clone(),)
        kw = dict(mode=mode, algorithm=algorithm, num_layers=L, N_clip=2.0 * K)
        before = slab_codec.slab_encode_combine.launches
        out, A = slab_codec.slab_encode_combine(bl, slab, ops, mix, **kw)
        torch.cuda.synchronize()
        assert slab_codec.slab_encode_combine.launches == before + slab_codec.LAUNCHES_PER_CALL[algorithm]
        out_ref, A_ref = slab_codec.slab_encode_combine_ref(bl, slab, ops, mix, **kw)
        torch.testing.assert_close(out, out_ref, rtol=0, atol=1e-5)
        torch.testing.assert_close(A, A_ref.expand_as(A), rtol=0, atol=5e-6)
        assert torch.equal(out[2], slab[2])
        e2 = torch.zeros(K, device="cuda")
        e2[2] = 1.0
        assert all(torch.equal(A[p, :, 2], e2) for p in range(L))
        assert bool((A[:, 5, 5] > 0).all()) and bool((A[:, 4, 5] > 0).all())


@pytest.mark.gpu
def test_thread_exchange_psum_on_the_card_is_the_same_bits_on_16_threads(cuda):
    """16 threads sharing the card: every rank's psum of a 309,248-element
    f32 vector (the width-16 slab's width) is the same bits, and equals the
    ranks' tensors added in rank order; a 0-d psum too."""
    from repro_torch import spmd_run

    K, D = 16, 309_248
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(D, generator=g, device="cuda") * (r + 1) for r in range(K)]
    outs = spmd_run(lambda r, ex: (ex.psum(xs[r]), ex.psum(xs[r].square().sum())), K, device="cuda")
    want = xs[0].clone()
    for x in xs[1:]:
        want.add_(x)
    assert all(torch.equal(o[0], want) for o in outs)
    assert all(torch.equal(o[1], outs[0][1]) for o in outs)


@pytest.mark.gpu
def test_controlled_round_sets_on_the_card_match_the_cpu(cuda):
    """K = 4 round-sets over a churn schedule (agent 0 isolated in round 0,
    agents 2 and 3 in round 1, agent 3 in round 2), momentum 0.4 and an adaptive gate (tol the
    geometric mean of the CPU fixed run's disagreements after rounds 1 and
    2), from the same weights on the CPU (plain versions) and on the card
    (kernels): the gather engine's exact slab, int8 and exact edge paths
    and the permute engine's slab path.  effective_rounds 2 on both; out
    within 1e-5 (int8 within one quantization step per round in under 1%
    of the elements); launches as each path states them, every round
    launched, gated or not."""
    from repro_torch import PermuteConsensus, spmd_run
    from repro_torch.comm import prng
    from repro_torch.core import consensus, dynamic
    from repro_torch.core.drt import DRTConfig
    from repro_torch.core.topology import make_topology, ring
    from repro_torch.kernels import drt_dist as dd
    from repro_torch.kernels import slab_codec, slab_segment
    from repro_torch.kernels.slab_combine import slab_combine, slab_source_combine
    from repro_torch.obs.metrics import ObsConfig
    from repro_torch.utils.pytree import LayerPartition, agent_template, tree_items, tree_map

    K, R = 4, 3
    sched = dynamic.ChurnSchedule(dynamic.PeriodicSchedule((ring(K), make_topology("full", K))), agent_drop=0.25,
                                  seed=1)
    rng = np.random.default_rng(3)
    x0 = {"blocks": {"w": rng.normal(size=(K, 3, 8, 8)).astype(np.float32)},
          "embed": {"w": rng.normal(size=(K, 4, 8)).astype(np.float32)}}
    amax = max(float(np.abs(v["w"]).max()) for v in x0.values())
    counters = {"slab_combine": slab_combine, "slab_encode_combine": slab_codec.slab_encode_combine,
                "slab_edge_encode_combine": slab_segment.slab_edge_encode_combine, "drt_dist": dd.drt_dist,
                "slab_source_combine": slab_source_combine}
    n_ex = [len(consensus.exchange_decomposition(sched.topology_at(t))) for t in range(R)]
    cases = {  # label: (run(pK, dev, tol), launches expected on the card)
        "gather exact": (None, "slab", {"slab_combine": 1}),
        "gather int8": ("int8", "slab", {"slab_encode_combine": R * slab_codec.LAUNCHES_PER_CALL["drt"]}),
        "gather edge": (None, "edge", {"slab_edge_encode_combine": R * slab_segment.LAUNCHES_PER_CALL["drt"]}),
        "permute": (None, "permute", {"drt_dist": K * sum(n_ex) * dd.LAUNCHES_PER_CALL,
                                      "slab_source_combine": K * sum(n > 0 for n in n_ex)}),
    }

    def run(codec, path, dev, tol):
        pK = tree_map(lambda a: torch.from_numpy(a).to(dev), x0)
        part = LayerPartition.build(agent_template(pK))
        if path == "permute":
            eng = PermuteConsensus(part, ring(K), DRTConfig(), schedule=sched, momentum=0.4, round_tol=tol)
            outs = spmd_run(lambda r, ex: eng(tree_map(lambda a: a[r], pK), ex, rounds=R), K, device=dev)
            return tree_map(lambda *xs: torch.stack(xs), *outs), None
        C, M = sched.mixing_stacks(0, R, dev)
        kw = dict(rounds=R, metropolis=M, path=path, momentum=0.4, round_tol=tol, obs=ObsConfig())
        if codec:
            kw.update(codec=codec, rng=prng.key(5))
        if path == "edge":
            kw.update(edges=sched.edge_stacks(0, R, dev), max_in_degree=sched.max_in_degree)
        out = consensus.gather_consensus_rounds(part, pK, C, DRTConfig(), **kw)
        return out[0], out[-1]

    d = run(None, "slab", "cpu", None)[1].disagreement.double().numpy()
    assert d[0] > d[1] > d[2], d
    tol = float(np.sqrt(d[0] * d[1]))
    for label, (codec, path, launches) in cases.items():
        got = {}
        for dev in ("cpu", "cuda"):
            before = {k: f.launches for k, f in counters.items()}
            got[dev] = run(codec, path, dev, tol)
            torch.cuda.synchronize()
            seen = {k: f.launches - before[k] for k, f in counters.items()}
            want = {k: (launches.get(k, 0) if dev == "cuda" else 0) for k in counters}
            assert seen == want, (label, dev, seen, want)
        if got["cpu"][1] is not None:
            assert got["cpu"][1].effective_rounds.tolist() == got["cuda"][1].effective_rounds.cpu().tolist() \
                == [1.0, 2.0, 2.0], label
        for (_, a), (_, b) in zip(tree_items(got["cpu"][0]), tree_items(got["cuda"][0])):
            diff = (a - b.cpu()).abs()
            if codec is None:
                assert float(diff.max()) <= 1e-5, label
            else:
                assert float((diff > 1e-5).float().mean()) < 0.01, label
                assert float(diff.max()) <= R * 1.01 * amax / 127.0, label


def _tickets_left():
    """The stats launches' ticket workspace of the current stream (every
    launch leaves it zeroed)."""
    from repro_torch.kernels import layer_chunks

    return layer_chunks.tickets(torch.device("cuda", 0), torch.cuda.current_stream().cuda_stream, 1)


# a layer of one column block, one of 610 (61 chunks: the width-16 ResNet-20's
# largest) and one of 5
ONE_AND_610 = np.repeat(np.arange(3), [1, 610, 5]).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "bf16", "sent"])
def test_slab_encode_combine_kernel_on_layers_of_1_and_610_blocks(cuda, mode):
    """A DRT round over a one-block layer (its chunk writes G directly) and
    a 610-block one (61 chunk partials summed by the layer's last block):
    out within 1e-5 and A within 5e-6 of the plain version, two runs
    bit-identical, two launches a call, the tickets back at zero."""
    from repro_torch.core.topology import ring
    from repro_torch.kernels import slab_codec

    K = 16
    slab, int8_ops, sent, _, _ = _codec_inputs(K, ONE_AND_610.size, seed=610)
    bl = torch.from_numpy(ONE_AND_610).cuda()
    ops = {"int8": int8_ops, "sent": (sent,)}.get(mode, ())
    mix = torch.as_tensor(ring(K).c_matrix(), dtype=torch.float32).cuda()
    kw = dict(mode=mode, algorithm="drt", num_layers=3, N_clip=2.0 * K)
    before = slab_codec.slab_encode_combine.launches
    out, A = slab_codec.slab_encode_combine(bl, slab, ops, mix, **kw)
    again = slab_codec.slab_encode_combine(bl, slab, ops, mix, **kw)
    torch.cuda.synchronize()
    assert slab_codec.LAUNCHES_PER_CALL["drt"] == 2
    assert slab_codec.slab_encode_combine.launches == before + 2 * 2
    assert not _tickets_left().any()
    assert all(torch.equal(a, b) for a, b in zip((out, A), again))
    out_ref, A_ref = slab_codec.slab_encode_combine_ref(bl, slab, ops, mix, **kw)
    torch.testing.assert_close(out, out_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(A, A_ref, rtol=0, atol=5e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_slab_encode_combine_kernel_reads_G_from_device_memory_when_it_does_not_fit(cuda, mode):
    """K=64 over 16 layers: every layer's Gram (256 KB) does not fit the
    mixing's shared memory, so the last block reads G from device memory:
    within 1e-5 / 5e-6 of the plain version, two runs bit-identical, the
    tickets back at zero."""
    from repro_torch.core.topology import ring
    from repro_torch.kernels import slab_codec

    K, L = MAX_AGENTS, 16
    slab, int8_ops, _, bl, _ = _codec_inputs(K, L, L=L, seed=64)
    ops = int8_ops if mode == "int8" else ()
    mix = torch.as_tensor(ring(K).c_matrix(), dtype=torch.float32).cuda()
    kw = dict(mode=mode, algorithm="drt", num_layers=L, N_clip=2.0 * K)
    out, A = slab_codec.slab_encode_combine(bl, slab, ops, mix, **kw)
    again = slab_codec.slab_encode_combine(bl, slab, ops, mix, **kw)
    torch.cuda.synchronize()
    assert not _tickets_left().any()
    assert all(torch.equal(a, b) for a, b in zip((out, A), again))
    out_ref, A_ref = slab_codec.slab_encode_combine_ref(bl, slab, ops, mix, **kw)
    torch.testing.assert_close(out, out_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(A, A_ref, rtol=0, atol=5e-6)


@pytest.mark.gpu
def test_slab_codec_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels.slab_codec import slab_encode_combine, slab_quant_encode

    slab, ops, sent, bl, L = _codec_inputs(4, 3)
    mix = torch.ones(4, 4, device="cuda") / 4
    with pytest.raises(ValueError, match="agents"):
        big, big_ops, _, big_bl, _ = _codec_inputs(MAX_AGENTS + 1, 1, L=1)
        slab_quant_encode(*big_ops, big)
    with pytest.raises(TypeError):
        slab_quant_encode(*ops, slab.double())
    with pytest.raises(TypeError):
        slab_encode_combine(bl.long(), slab, (), mix, mode="bf16", num_layers=L)
    with pytest.raises(ValueError, match="contiguous"):
        slab_encode_combine(bl, slab, (sent.t().contiguous().t(),), mix, mode="sent", num_layers=L)
    with pytest.raises(ValueError):
        slab_encode_combine(bl, slab, (), mix.cpu(), mode="bf16", num_layers=L)
    with pytest.raises(ValueError, match="mode"):
        slab_encode_combine(bl, slab, (), mix, mode="int4", num_layers=L)
    with pytest.raises(ValueError, match="operands"):
        slab_encode_combine(bl, slab, ops, mix, mode="bf16", num_layers=L)
    # the DRT stats launch streams the slab in 16-byte pieces
    wide = torch.zeros(4 * 3 * LANES + 1, device="cuda")
    wide[1:].view(4, 3 * LANES).copy_(slab)
    with pytest.raises(ValueError, match="16-byte aligned"):
        slab_encode_combine(bl, wide[1:].view(4, 3 * LANES), (), mix, mode="bf16", num_layers=L)


EDGE_MODES = ["exact", "int8", "bf16", "f16", "sent"]


def _edge_list(K, graph, seed=5):
    """(src, dst, w) numpy: the ring's edge list, or a churn round of it (the
    reference's ChurnSchedule draw: agents dropped with probability 0.25,
    edges with 0.1; the first round that isolates an agent and keeps an
    edge), padded to the ring's edge count."""
    from repro_torch.core.dynamic import StaticSchedule
    from repro_torch.core.topology import Topology, ring

    base = ring(K).adjacency
    adj = base
    if graph == "churn":
        for t in range(64):
            rng = np.random.default_rng(np.random.SeedSequence(entropy=seed, spawn_key=(1, t)))
            alive = rng.random(K) >= 0.25
            keep = np.triu(rng.random((K, K)) >= 0.1, k=1)
            adj = base & (keep | keep.T) & alive[:, None] & alive[None, :]
            if (~alive).any() and adj.any():
                break
    src, dst, w = (a[0] for a in StaticSchedule(Topology(graph, adj))._edge_table)
    pad = int(base.sum()) - src.shape[0]
    return tuple(np.pad(a, (0, pad)) for a in (src, dst, w))


def _edge_inputs(K, nb, graph, L=3, seed=0):
    """Seeded operands of the edge kernels on the card: block map, self
    slab, every mode's wire, the edge list and its CSR tables."""
    from repro_torch.core.dynamic import csr_from_edges

    rng = np.random.default_rng(seed)
    D = nb * LANES
    slab = rng.normal(size=(K, D)).astype(np.float32)
    bl = np.sort(np.concatenate([np.arange(L), rng.integers(0, L, max(nb - L, 0))]))[:nb].astype(np.int32)
    col_seg = np.sort(rng.integers(0, 3, D)).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    x = t(slab)
    wires = {
        "exact": (x,),
        "int8": (t(rng.integers(-127, 128, size=(K, D)).astype(np.int8)),
                 t(rng.uniform(0.005, 0.02, size=(K, 3)).astype(np.float32)), t(col_seg)),
        "bf16": (x.to(torch.bfloat16),),
        "f16": (x.to(torch.float16),),
        "sent": (t(np.where(np.abs(slab) > 1.0, slab, 0.0).astype(np.float32)),),
    }
    src, dst, w = (t(a) for a in _edge_list(K, graph))
    dmax = max(int(np.bincount(dst.cpu().numpy()[w.cpu().numpy() > 0], minlength=K).max()), 1)
    nbr, pos, valid, _ = csr_from_edges(src, dst, w, K, dmax)
    return t(bl), x, wires, (src, dst, w), (nbr, pos, valid), min(L, nb)


EDGE_SHAPES = [(3, 2, "ring"), (5, 7, "churn"), (16, 2416, "ring"), (MAX_AGENTS, 3, "churn")]


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["drt", "classical"])
@pytest.mark.parametrize("mode", EDGE_MODES)
@pytest.mark.parametrize("K,nb,graph", EDGE_SHAPES)
def test_slab_edge_encode_combine_kernel_matches_plain_version(cuda, mode, algorithm, K, nb, graph):
    """The decoded wire is exact on both sides; the stats sum in another
    order (the plain version's index_add_ in an order that changes from run
    to run) and the factors use CUDA's logf/expf: out within 1e-5, the
    factors within 5e-6.  With the kernel's own factors the plain combine
    is bit-identical (both round each product and each sum), two calls give
    the same bits, two destination halves (``dst_base``) joined are the
    whole, and the counter advances by the stated launches per call."""
    from repro_torch.kernels import slab_segment as ss

    bl, x, wires, edges, csr, L = _edge_inputs(K, nb, graph, seed=K + nb)
    kw = dict(mode=mode, algorithm=algorithm, num_layers=L, N_clip=2.0 * K)
    before = ss.slab_edge_encode_combine.launches
    out, A_self, A_e = ss.slab_edge_encode_combine(bl, x, wires[mode], *edges, *csr, **kw)
    again = ss.slab_edge_encode_combine(bl, x, wires[mode], *edges, *csr, **kw)
    torch.cuda.synchronize()
    assert ss.slab_edge_encode_combine.launches == before + 2 * ss.LAUNCHES_PER_CALL[algorithm]
    assert all(torch.equal(a, b) for a, b in zip((out, A_self, A_e), again))
    assert not _tickets_left().any()
    ref = ss.slab_edge_encode_combine_ref(bl, x, wires[mode], *edges, *csr, **kw)
    torch.testing.assert_close(out, ref[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(A_self, ref[1].expand_as(A_self), rtol=0, atol=5e-6)
    torch.testing.assert_close(A_e, ref[2].expand_as(A_e), rtol=0, atol=5e-6)
    dec = ss.decode_wire_ref(mode, wires[mode])
    assert torch.equal(out, ss.csr_combine_ref(bl, x, dec, *csr, A_self, A_e))
    h = K // 2
    if h:
        parts = [ss.slab_edge_encode_combine(bl, x[b:e].contiguous(), wires[mode], *edges,
                                             *(c[b:e].contiguous() for c in csr), b, **kw)[0]
                 for b, e in ((0, h), (h, K))]
        assert torch.equal(torch.cat(parts), out)


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["drt", "classical"])
@pytest.mark.parametrize("K,nb,graph", EDGE_SHAPES)
def test_slab_edge_combine_kernel_matches_plain_version(cuda, algorithm, K, nb, graph):
    """The scatter round over a decoded slab that is not the self slab:
    out 1e-5, factors 5e-6 against the plain version on the card; with the
    kernel's factors the CPU's scatter combine (index_add_ in edge-list
    order) is bit-identical; two calls give the same bits."""
    from repro_torch.core import packing
    from repro_torch.kernels import slab_segment as ss

    bl, x, wires, edges, _, L = _edge_inputs(K, nb, graph, seed=K * nb)
    dec = wires["sent"][0]
    kw = dict(algorithm=algorithm, num_layers=L, N_clip=2.0 * K)
    before = ss.slab_edge_combine.launches
    out, A_self, A_e = ss.slab_edge_combine(bl, x, dec, *edges, **kw)
    again = ss.slab_edge_combine(bl, x, dec, *edges, **kw)
    torch.cuda.synchronize()
    assert ss.slab_edge_combine.launches == before + 2 * ss.LAUNCHES_PER_CALL[algorithm]
    assert all(torch.equal(a, b) for a, b in zip((out, A_self, A_e), again))
    assert not _tickets_left().any()
    ref = ss.slab_edge_combine_ref(bl, x, dec, *edges, **kw)
    torch.testing.assert_close(out, ref[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(A_self, ref[1].expand_as(A_self), rtol=0, atol=5e-6)
    torch.testing.assert_close(A_e, ref[2].expand_as(A_e), rtol=0, atol=5e-6)
    cpu = packing.edge_combine(A_self.cpu(), A_e.cpu(), edges[0].cpu(), edges[1].cpu(), x.cpu(), dec.cpu(),
                               bl.cpu())
    assert torch.equal(out.cpu(), cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["exact", "int8"])
@pytest.mark.parametrize("K,nb,graph", [(5, 7, "churn"), (16, 2416, "ring")])
def test_edge_kernels_reweight_between_their_launches_and_return_d2e(cuda, mode, K, nb, graph):
    """Both edge wrappers with a trust reweighting (``reweight_edge``, clip
    0.3 and temperature 0.5) and ``return_d2e``: still two launches a call;
    the factors within 5e-6 of the plain version's reweighted factors, the
    per-edge distances within 1e-5 of their largest (sums in another
    order), and with the kernel's own reweighted factors the plain combine
    bit for bit, so the combine launch applied them."""
    from repro_torch import faults
    from repro_torch.kernels import slab_segment as ss

    bl, x, wires, edges, csr, L = _edge_inputs(K, nb, graph, seed=3 * K + nb)
    dst = edges[1]

    def rw(a_self, a_e):
        return faults.reweight_edge(a_self, a_e, dst, K, 0.3, 0.5)

    from repro_torch.core import packing

    kw = dict(algorithm="drt", num_layers=L, N_clip=2.0 * K, reweight=rw, return_d2e=True)
    dec = ss.decode_wire_ref(mode, wires[mode])
    src, cpu = edges[0], lambda t: t.cpu()  # noqa: E731
    calls = ((ss.slab_edge_encode_combine, ss.slab_edge_encode_combine_ref, (bl, x, wires[mode], *edges, *csr),
              dict(mode=mode), lambda a_self, a_e: ss.csr_combine_ref(bl, x, dec, *csr, a_self, a_e)),
             (ss.slab_edge_combine, ss.slab_edge_combine_ref, (bl, x, dec, *edges), {},
              lambda a_self, a_e: packing.edge_combine(*map(cpu, (a_self, a_e, src, dst, x, dec, bl)))))
    for fn, fn_ref, args, extra, combine in calls:
        before = fn.launches
        out, A_self, A_e, d2e = fn(*args, **extra, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        ref = fn_ref(*args, **extra, **kw)
        torch.testing.assert_close(A_self, ref[1], rtol=0, atol=5e-6)
        torch.testing.assert_close(A_e, ref[2], rtol=0, atol=5e-6)
        torch.testing.assert_close(d2e, ref[3], rtol=0, atol=1e-5 * float(ref[3].abs().max()))
        torch.testing.assert_close(out, ref[0], rtol=0, atol=1e-5)
        assert torch.equal(out.cpu(), combine(A_self, A_e).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "bf16", "sent"])
def test_slab_encode_combine_kernel_returns_its_gram(cuda, mode):
    """``return_gram``: the DRT stats launch's Gram within 1e-5 of its
    largest entry of the plain version's (sums in another order), the same
    out and A as without it, the same two launches; a classical round has
    none."""
    from repro_torch.core.topology import ring
    from repro_torch.kernels import slab_codec

    K, nb = 16, 2416
    slab, int8_ops, sent, bl, L = _codec_inputs(K, nb, seed=nb)
    ops = {"int8": int8_ops, "sent": (sent,)}.get(mode, ())
    mix = torch.as_tensor(ring(K).c_matrix(), dtype=torch.float32).cuda()
    kw = dict(mode=mode, num_layers=L, N_clip=2.0 * K)
    before = slab_codec.slab_encode_combine.launches
    out, A, G = slab_codec.slab_encode_combine(bl, slab, ops, mix, return_gram=True, **kw)
    plain = slab_codec.slab_encode_combine(bl, slab, ops, mix, **kw)
    torch.cuda.synchronize()
    assert slab_codec.slab_encode_combine.launches == before + 4
    assert torch.equal(out, plain[0]) and torch.equal(A, plain[1])
    G_ref = slab_codec.slab_encode_combine_ref(bl, slab, ops, mix, return_gram=True, **kw)[2]
    torch.testing.assert_close(G, G_ref, rtol=0, atol=1e-5 * float(G_ref.abs().max()))
    assert slab_codec.slab_encode_combine(bl, slab, ops, mix, algorithm="classical", return_gram=True, **kw)[2] is None


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["exact", "int8", "bf16"])
def test_edge_kernels_on_layers_of_1_and_610_blocks(cuda, mode):
    """The edge kernels' DRT round over a one-block layer and a 610-block
    one (K=16 ring): out within 1e-5 and the factors within 5e-6 of the
    plain versions, two runs bit-identical, two launches a call, the
    tickets back at zero."""
    from repro_torch.kernels import slab_segment as ss

    K = 16
    _, x, wires, edges, csr, _ = _edge_inputs(K, ONE_AND_610.size, "ring", seed=610)
    bl = torch.from_numpy(ONE_AND_610).cuda()
    kw = dict(algorithm="drt", num_layers=3, N_clip=2.0 * K)
    before = (ss.slab_edge_encode_combine.launches, ss.slab_edge_combine.launches)
    got = ss.slab_edge_encode_combine(bl, x, wires[mode], *edges, *csr, mode=mode, **kw)
    again = ss.slab_edge_encode_combine(bl, x, wires[mode], *edges, *csr, mode=mode, **kw)
    dec = ss.decode_wire_ref(mode, wires[mode])
    scat = ss.slab_edge_combine(bl, x, dec, *edges, **kw)
    torch.cuda.synchronize()
    assert ss.LAUNCHES_PER_CALL["drt"] == 2
    assert (ss.slab_edge_encode_combine.launches, ss.slab_edge_combine.launches) == (before[0] + 4, before[1] + 2)
    assert not _tickets_left().any()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = ss.slab_edge_encode_combine_ref(bl, x, wires[mode], *edges, *csr, mode=mode, **kw)
    scat_ref = ss.slab_edge_combine_ref(bl, x, dec, *edges, **kw)
    for out, want in ((got, ref), (scat, scat_ref)):
        torch.testing.assert_close(out[0], want[0], rtol=0, atol=1e-5)
        torch.testing.assert_close(out[1], want[1], rtol=0, atol=5e-6)
        torch.testing.assert_close(out[2], want[2], rtol=0, atol=5e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_edge_kernels_read_stats_from_device_memory_when_they_do_not_fit(cuda, mode):
    """K=64 on the full graph (E=4032) over 5 layers: the stats and log
    weights do not fit the factors' shared memory, so the last block works
    in device memory: within 1e-5 / 5e-6 of the plain versions, two runs
    bit-identical, the tickets back at zero."""
    from repro_torch.core.dynamic import StaticSchedule, csr_from_edges
    from repro_torch.core.topology import Topology
    from repro_torch.kernels import slab_segment as ss

    K, L = MAX_AGENTS, 5
    bl, x, wires, _, _, _ = _edge_inputs(K, 9, "ring", L=L, seed=4032)
    src, dst, w = (torch.from_numpy(np.ascontiguousarray(a[0])).cuda()
                   for a in StaticSchedule(Topology("full", ~np.eye(K, dtype=bool)))._edge_table)
    csr = csr_from_edges(src, dst, w, K, K - 1)[:3]
    kw = dict(mode=mode, algorithm="drt", num_layers=L, N_clip=2.0 * K)
    got = ss.slab_edge_encode_combine(bl, x, wires[mode], src, dst, w, *csr, **kw)
    again = ss.slab_edge_encode_combine(bl, x, wires[mode], src, dst, w, *csr, **kw)
    torch.cuda.synchronize()
    assert not _tickets_left().any()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = ss.slab_edge_encode_combine_ref(bl, x, wires[mode], src, dst, w, *csr, **kw)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=5e-6)
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=5e-6)


@pytest.mark.gpu
def test_edge_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels import slab_segment as ss

    bl, x, wires, edges, csr, L = _edge_inputs(4, 3, "ring")
    kw = dict(num_layers=L)
    with pytest.raises(ValueError, match="agents"):
        big = _edge_inputs(MAX_AGENTS + 1, 1, "ring", L=1)
        ss.slab_edge_encode_combine(big[0], big[1], big[2]["exact"], *big[3], *big[4], mode="exact", num_layers=1)
    with pytest.raises(TypeError):
        ss.slab_edge_encode_combine(bl, x, (wires["bf16"][0].float(),), *edges, *csr, mode="bf16", **kw)
    with pytest.raises(TypeError):
        ss.slab_edge_combine(bl.long(), x, x, *edges, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ss.slab_edge_combine(bl, x, x.t().contiguous().t(), *edges, **kw)
    with pytest.raises(ValueError):
        ss.slab_edge_combine(bl, x, x.cpu(), *edges, **kw)
    with pytest.raises(ValueError, match="dst_base"):
        ss.slab_edge_encode_combine(bl, x[:2], wires["exact"], *edges, *(c[:2] for c in csr), 3,
                                    mode="exact", **kw)
    with pytest.raises(ValueError, match="mode"):
        ss.slab_edge_encode_combine(bl, x, wires["exact"], *edges, *csr, mode="int4", **kw)
    wide = torch.zeros(x.numel() + 1, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        ss.slab_edge_combine(bl, x, wide[1:].view_as(x), *edges, **kw)


# -- the permute engine's kernels ------------------------------------------------------


def _main_layer_sizes():
    """The 11 DRT layer slots of the width-16 ResNet-20 slab (lane-padded
    column counts), from the port's own layout."""
    from repro_torch.core.packing import build_slab_layout
    from repro_torch.models.resnet import init_resnet20
    from repro_torch.utils.pytree import LayerPartition

    p = init_resnet20(torch.Generator().manual_seed(0), width=16)
    layout = build_slab_layout(LayerPartition.build(p), p)
    return [e - s for s, e in layout.layer_slices]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 127, 129, 1_000_003, "layers"])
def test_drt_dist_kernel_matches_plain_version(cuda, n):
    """Sums of n nonnegative f32 terms in another order: relative 1e-5 of
    each sum (as in chip_smoke.py); two runs give the same bits; one
    launch per call."""
    from repro_torch.kernels import drt_dist as dd

    sizes = _main_layer_sizes() if n == "layers" else [n]
    rng = np.random.default_rng(len(sizes))
    for size in sizes:
        x, y = (torch.from_numpy(a).cuda() for a in rng.normal(size=(2, size)).astype(np.float32))
        before = dd.drt_dist.launches
        got = dd.drt_dist(x, y)
        again = dd.drt_dist(x, y)
        torch.cuda.synchronize()
        assert dd.LAUNCHES_PER_CALL == 1 and dd.drt_dist.launches == before + 2
        assert torch.equal(got, again)
        torch.testing.assert_close(got, dd.drt_dist_ref(x, y), rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", [[1], [127], [129], [1, 127, 129, 2049, 4096], "layers"])
def test_drt_dist_slots_kernel_matches_plain_version(cuda, sizes):
    """Every slot of an exchange in one launch (slots of 1, 127, 129 and
    across chunks; ResNet-20's 11 layer slots, with a gap before each):
    within relative 1e-5 of the plain version's per-slot sums; two runs
    give the same bits, back to back and after a launch over other slots
    (the slots' tickets are left at 0)."""
    from repro_torch.kernels import drt_dist as dd

    sizes = _main_layer_sizes() if sizes == "layers" else sizes
    bounds, col = [], 0
    for size in sizes:
        bounds.append((col + 3, col + 3 + size))
        col += 3 + size
    slots = dd.slot_table(bounds, "cuda")
    rng = np.random.default_rng(len(sizes))
    x, y = (torch.from_numpy(a).cuda() for a in rng.normal(size=(2, col + 5)).astype(np.float32))
    before = dd.drt_dist.launches
    got, again = dd.drt_dist_slots(x, y, slots), dd.drt_dist_slots(x, y, slots)
    dd.drt_dist_slots(y, x, dd.slot_table([(0, col)], "cuda"))
    third = dd.drt_dist_slots(x, y, slots)
    torch.cuda.synchronize()
    assert dd.drt_dist.launches == before + 4
    assert got.shape == (len(sizes), 2)
    assert torch.equal(got, again) and torch.equal(got, third)
    torch.testing.assert_close(got, dd.drt_dist_slots_ref(x, y, slots), rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("N,nb", [(1, 7), (3, 2416), (5, 2416), (7, 13), (64, 3),
                                  (2, 3), (4, 5), (6, 9), (7, 2417), (9, 3), (64, 2417)])
def test_slab_source_combine_kernel_is_bit_exact(cuda, N, nb):
    """The kernel and the plain version both walk the sources in order and
    round product and sum apart: bit for bit, for a stacked (N, D) tensor
    and for N separately allocated rows (the permute engine's form); one
    launch per call."""
    from repro_torch.kernels.slab_combine import slab_source_combine, slab_source_combine_ref

    rng = np.random.default_rng(N + nb)
    w = torch.from_numpy(rng.dirichlet(np.ones(N), size=nb).astype(np.float32)).cuda()
    srcs = torch.from_numpy(rng.normal(size=(N, nb * LANES)).astype(np.float32)).cuda()
    rows = [srcs[n].clone() for n in range(N)]
    before = slab_source_combine.launches
    out = slab_source_combine(w, srcs)
    out_rows = slab_source_combine(w, rows)
    torch.cuda.synchronize()
    assert slab_source_combine.launches == before + 2
    want = slab_source_combine_ref(w, srcs)
    assert torch.equal(out, want) and torch.equal(out_rows, want)
    assert torch.equal(slab_source_combine_ref(w, rows), want)


@pytest.mark.gpu
def test_four_column_kernels_refuse_unaligned_operands(cuda):
    """slab_source_combine and slab_quant_encode read 16-byte pieces: a
    source or slab seen 4 bytes into its storage raises, in either form,
    before any launch."""
    from repro_torch.kernels.slab_codec import slab_quant_encode
    from repro_torch.kernels.slab_combine import slab_source_combine

    nb, N = 3, 2
    D = nb * LANES
    w = torch.full((nb, N), 0.5, device="cuda")
    buf = torch.zeros(N * D + 1, device="cuda")
    before = slab_source_combine.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        slab_source_combine(w, [torch.zeros(D, device="cuda"), buf[1 : D + 1]])
    with pytest.raises(ValueError, match="16-byte aligned"):
        slab_source_combine(w, buf[1:].view(N, D))
    assert slab_source_combine.launches == before
    slab, ops, _, _, _ = _codec_inputs(2, nb)
    shifted = torch.zeros(2 * D + 1, device="cuda")
    shifted[1:].view(2, D).copy_(slab)
    with pytest.raises(ValueError, match="16-byte aligned"):
        slab_quant_encode(*ops, shifted[1:].view(2, D))


@pytest.mark.gpu
def test_permute_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels.drt_dist import drt_dist, drt_dist_slots, slot_table
    from repro_torch.kernels.slab_combine import MAX_SOURCES, slab_source_combine

    x = torch.randn(300, device="cuda")
    with pytest.raises(TypeError):
        drt_dist(x.double(), x.double())
    with pytest.raises(ValueError, match="slot table"):
        drt_dist_slots(x, x, slot_table([(0, 10)], "cpu"))
    with pytest.raises(ValueError, match="past"):
        drt_dist_slots(x, x, slot_table([(0, 301)], "cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        drt_dist(x[::2], x[1::2])
    with pytest.raises(ValueError, match="shapes"):
        drt_dist(x, x[:10])
    w = torch.ones(2, MAX_SOURCES + 1, device="cuda")
    with pytest.raises(ValueError, match="sources"):
        slab_source_combine(w, torch.zeros(MAX_SOURCES + 1, 2 * LANES, device="cuda"))
    with pytest.raises(TypeError):
        slab_source_combine(torch.ones(2, 3, device="cuda"), torch.zeros(3, 2 * LANES, device="cuda").half())
    with pytest.raises(ValueError, match="contiguous"):
        slab_source_combine(torch.ones(3, 2, device="cuda").t(), torch.zeros(3, 2 * LANES, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("codec", [None, "int8"])
def test_permute_round_set_on_the_card_matches_the_cpu(cuda, codec):
    """A K=4 DRT round-set (ring, 3 rounds) of the permute engine from the
    same weights on the CPU (plain versions) and on the card (kernels):
    exact within 1e-5; int8 within one quantization step in under 1% of
    the elements (a last-bit difference after round 0 may flip a
    stochastic rounding).  Launch counts as the
    engine states them."""
    from repro_torch import PermuteConsensus, spmd_run
    from repro_torch.comm import prng
    from repro_torch.core.drt import DRTConfig
    from repro_torch.core.topology import ring
    from repro_torch.kernels import drt_dist as dd
    from repro_torch.kernels import slab_codec
    from repro_torch.kernels.slab_combine import slab_source_combine
    from repro_torch.utils.pytree import LayerPartition, agent_template, tree_items, tree_map

    K, rounds = 4, 3
    rng = np.random.default_rng(3)
    x0 = {"blocks": {"w": rng.normal(size=(K, 3, 8, 8)).astype(np.float32)},
          "embed": {"w": rng.normal(size=(K, 4, 8)).astype(np.float32)}}
    topo = ring(K)
    results = {}
    for dev in ("cpu", "cuda"):
        pK = tree_map(lambda a: torch.from_numpy(a).to(dev), x0)
        part = LayerPartition.build(agent_template(pK))
        eng = PermuteConsensus(part, topo, DRTConfig(), codec=codec)
        before = (dd.drt_dist.launches, slab_source_combine.launches, slab_codec.slab_quant_encode.launches)

        def body(rank, ex):
            out = eng(tree_map(lambda a: a[rank], pK), ex, rng=prng.key(7), rounds=rounds)
            return out[0] if codec else out

        outs = spmd_run(body, K, device=dev)
        after = (dd.drt_dist.launches, slab_source_combine.launches, slab_codec.slab_quant_encode.launches)
        on_card = dev == "cuda"
        # the ring's 2 exchanges a round, each one launch over every layer slot
        assert after[0] - before[0] == on_card * K * rounds * 2 * dd.LAUNCHES_PER_CALL
        assert after[1] - before[1] == on_card * K * rounds
        assert after[2] - before[2] == on_card * K * rounds * (codec == "int8")
        results[dev] = [torch.cat([x.cpu().reshape(-1) for _, x in tree_items(o)]) for o in outs]
    amax = max(float(np.abs(v["w"]).max()) for v in x0.values())
    for a, b in zip(results["cpu"], results["cuda"]):
        diff = (a - b).abs()
        if codec is None:
            assert float(diff.max()) <= 1e-5
        else:
            assert float((diff > 1e-5).float().mean()) < 0.01
            assert float(diff.max()) <= 1.01 * amax / 127.0


def _attention_inputs(B, H, Hkv, S, hd, dtype, seed=0):
    """q in the model's (B, S, H, hd) layout seen as (B, H, S, hd), as the
    LM hands it to the kernel (no copy); k, v the same with Hkv heads."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    make = lambda h: torch.randn(B, S, h, hd, generator=g, device="cuda").to(dtype).transpose(1, 2)  # noqa: E731
    return make(H), make(Hkv), make(Hkv)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,hd", [
    (1, 4, 2, 40, 32), (2, 4, 4, 37, 64), (1, 32, 8, 37, 128), (1, 8, 2, 1, 128), (2, 32, 8, 300, 128), (1, 4, 1, 64, 64),
])
def test_flash_attention_kernel_matches_plain_version(cuda, dtype, B, H, Hkv, S, hd):
    """f32 (the CUDA-core kernel): sums over the keys in another order,
    1e-5.  bf16 (the tensor-core kernel): both round an f32 result to bf16
    (one step, 2^-7 relative), and the kernel rounds P to bf16 before P V,
    which moves o by at most 2^-9 sum_j softmax_j |v_j|: rtol 2^-7 plus atol
    2^-8 max|v|.  One launch counted; out in q's dtype."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    q, k, v = _attention_inputs(B, H, Hkv, S, hd, dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == (B, H, S, hd) and out.dtype == dtype
    ref = flash_attention_ref(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), **_flash_tol(dtype, v))


def _flash_tol(dtype, v):
    if dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=2**-7, atol=2**-8 * float(v.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4])
@pytest.mark.parametrize("S", [1, 37, 128, 129, 300])
def test_flash_attention_tensor_core_kernel(cuda, hd, n_rep, S):
    """The bf16 tensor-core kernel on strided (B, S, H, hd) model-layout
    views, every head dim, GQA group and ragged length (one key, a partial
    tile, one tile, one past it, several): within rtol 2^-7 plus atol 2^-8
    max|v| of the plain version (P rounded to bf16); one launch, counted
    on both counters."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    q, k, v = _attention_inputs(2, 2 * n_rep, 2, S, hd, torch.bfloat16, seed=S + hd)
    assert q.stride(2) == 2 * n_rep * hd  # the model's layout, not a contiguous copy
    launches, tc = flash_attention.launches, flash_attention.tc_launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.tc_launches) == (launches + 1, tc + 1)
    torch.testing.assert_close(out.float(), flash_attention_ref(q, k, v).float(),
                               **_flash_tol(torch.bfloat16, v))


@pytest.mark.gpu
def test_flash_attention_tensor_core_kernel_refuses_misaligned_views(cuda):
    """TMA needs a 16-byte aligned base and byte strides that are multiples
    of 16: the wrapper raises on views that break either and launches
    nothing (no copy is made to fit them)."""
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = _attention_inputs(1, 4, 2, 16, 64, torch.bfloat16)
    base = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
    q_off = base[1:].view(1, 16, 4, 64).transpose(1, 2)  # 2 bytes past the allocation's start
    launches, tc = flash_attention.launches, flash_attention.tc_launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q_off, k, v)
    odd = torch.zeros(1, 16, 4, 65, dtype=torch.bfloat16, device="cuda")[..., :64]  # rows 130 bytes apart
    with pytest.raises(ValueError, match="multiples of 16"):
        flash_attention(odd.transpose(1, 2), k, v)
    assert (flash_attention.launches, flash_attention.tc_launches) == (launches, tc)


def _scan_inputs(B, S, di, ds, x_dtype, x_offset=0):
    """Scan operands on the card; x starts ``x_offset`` elements into its
    storage (a bf16 x at an odd offset is not 4-byte aligned)."""
    g = torch.Generator(device="cuda").manual_seed(S * di + ds)
    dt = torch.nn.functional.softplus(torch.randn(B, S, di, generator=g, device="cuda") - 2.0)
    A = -torch.arange(1, ds + 1, dtype=torch.float32, device="cuda").expand(di, ds).contiguous()
    Bm, Cm = (torch.randn(B, S, ds, generator=g, device="cuda") for _ in range(2))
    x = torch.randn(B * S * di + x_offset, generator=g, device="cuda").to(x_dtype)[x_offset:].view(B, S, di)
    return dt, A, Bm, Cm, x


def _assert_scan_close(got, want):
    """y and h_last within 1e-5 of the largest |value| (f32 steps with and
    without fused multiply-adds, y's sum over ds in another order)."""
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(1.0, float(b.abs().max())))


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,di,ds", [(2, 37, 16, 4), (1, 1, 100, 16), (2, 130, 200, 8), (1, 33, 64, 16),
                                       (1, 2047, 96, 16), (3, 37, 37, 16), (1, 130, 100, 4), (2, 1, 33, 8),
                                       (2, 37, 8, 5), (1, 2048, 40, 16)])
def test_selective_scan_kernel_matches_plain_version(cuda, x_dtype, B, S, di, ds):
    """Within 1e-5 of the largest |value| of y and of h_last, at ds 4, 5, 8
    and 16, S from 1 to 2048 (partial and whole 16-step tiles), di not a
    multiple of a block's 32 channels (odd di: bf16 x element by element);
    two runs give the same bits; one launch per call."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_ref

    ops = _scan_inputs(B, S, di, ds, x_dtype)
    before = selective_scan.launches
    got, again = selective_scan(*ops), selective_scan(*ops)
    torch.cuda.synchronize()
    assert selective_scan.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_scan_close(got, selective_scan_ref(*ops))


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("ds", [16, 5])
def test_selective_scan_kernel_at_every_lane_count(cuda, lanes, ds):
    """Both lane counts the kernel takes (the wrapper picks one by the
    grid's size): each within 1e-5 of the plain version, with rows copied
    in 16-byte pieces, in 4-byte pieces and element by element (bf16 x
    not 4-byte aligned)."""
    from repro_torch.kernels import selective_scan as ss

    for di, x_offset in ((72, 0), (70, 0), (70, 1)):  # 16-byte rows; 4-byte pieces; unaligned x
        ops = _scan_inputs(2, 45, di, ds, torch.bfloat16, x_offset)
        got = ss._launch(*ops, lanes)
        torch.cuda.synchronize()
        _assert_scan_close(got, ss.selective_scan_ref(*ops))


@pytest.mark.gpu
def test_lm_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.selective_scan import selective_scan

    q, k, v = _attention_inputs(1, 4, 2, 16, 48, torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, k, v)
    q, k, v = _attention_inputs(1, 4, 2, 16, 32, torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, k, v)
    q, k, v = _attention_inputs(1, 4, 2, 16, 64, torch.float32)
    with pytest.raises(ValueError, match="unit stride"):  # hd 32 at stride 2
        flash_attention(q[..., ::2], k[..., ::2], v[..., ::2])
    dt = torch.ones(1, 4, 8, device="cuda")
    with pytest.raises(ValueError, match="d_state"):
        selective_scan(dt, torch.ones(8, 17, device="cuda"), torch.ones(1, 4, 17, device="cuda"),
                       torch.ones(1, 4, 17, device="cuda"), dt)
    with pytest.raises(ValueError, match="contiguous"):  # A (8, 4) as a transposed view
        selective_scan(dt, torch.ones(4, 8, device="cuda").T, torch.ones(1, 4, 4, device="cuda"),
                       torch.ones(1, 4, 4, device="cuda"), dt)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-4b-smoke", "falcon-mamba-7b-smoke"])
def test_lm_prefill_and_decode_on_card_match_cpu(cuda, arch):
    """The smoke LM from one set of weights on the CPU (plain versions) and
    on the card (kernels), f32: prefill logits and caches and 4 decode
    steps within 1e-4 (f32 products summed in another order, 2 layers);
    one kernel launch per layer in prefill, none in decode."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.models.registry import get_bundle
    from repro_torch.utils.pytree import tree_map

    bundle = get_bundle(arch)
    params = bundle.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(1, 512, size=(2, 45)))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda x: x.to(dev), params)
        t = tokens.to(dev)
        before = flash_attention.launches + selective_scan.launches
        logits, caches, pos = bundle.prefill(p, {"tokens": t[:, :41]}, 46)
        prefilled = flash_attention.launches + selective_scan.launches - before
        steps = [logits]
        for i in range(4):
            logits, caches = bundle.decode_step(p, t[:, 41 + i : 42 + i], caches, pos + i)
            steps.append(logits)
        assert flash_attention.launches + selective_scan.launches - before == prefilled
        assert prefilled == (bundle.cfg.n_layers if dev == "cuda" else 0)
        out[dev] = [x.cpu() for x in steps] + [c.cpu() for cache in caches for c in cache.values()]
    for a, b in zip(out["cpu"], out["cuda"]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


# -- the kernel API: weighted_combine, the int8 kernels, slab_dequant_combine --------


def _strided(x, pad=5):
    """``x`` (N, ...) as a view whose rows sit ``pad`` elements further
    apart than its own width (a column slice of a wider slab)."""
    N, n = x.shape[0], x[0].numel()
    wide = torch.zeros(N, n + pad, dtype=x.dtype, device=x.device)
    wide[:, pad:] = x.reshape(N, n)
    return wide[:, pad:].reshape(x.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N,n", [(0, 1, 1), (0, 3, 256 * 128 + 37), (1, 5, 129), (16, 16, 78_080), (3, 64, 300)])
def test_weighted_combine_kernel_is_bit_exact(cuda, dtype, M, N, n):
    """The kernel and the plain version both sum in the Pallas body's order
    with product and sum rounded apart, and round once to the output dtype:
    bit for bit, strided rows included.  M = 0: one (N,) weight vector."""
    from repro_torch.kernels.combine import weighted_combine, weighted_combine_ref

    rng = np.random.default_rng(M * 100 + N)
    a = torch.from_numpy(rng.dirichlet(np.ones(N), size=max(M, 1)).astype(np.float32)).cuda()
    a = a[0] if M == 0 else a
    xs = _strided(torch.from_numpy(rng.normal(size=(N, n)).astype(np.float32)).cuda().to(dtype))
    before = weighted_combine.launches
    out = weighted_combine(a, xs)
    torch.cuda.synchronize()
    assert weighted_combine.launches == before + 1
    assert out.dtype == dtype and out.shape == (*a.shape[:-1], n)
    assert torch.equal(out, weighted_combine_ref(a, xs))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(1,), (7, 129), (16, 78_080), (3, 256 * 128 + 37)])
def test_int8_kernels_are_bit_exact(cuda, dtype, shape):
    """int8_quantize: the same scale, reciprocal, rounding and clip as the
    plain version, bit for bit; int8_dequantize exactly q * s; one launch
    each."""
    from repro_torch.kernels import quantize as qz

    rng = np.random.default_rng(len(shape))
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(dtype)
    u = torch.from_numpy(rng.uniform(size=shape).astype(np.float32)).cuda()
    before = (qz.int8_quantize.launches, qz.int8_dequantize.launches)
    q, s = qz.int8_quantize(x, u)
    out = qz.int8_dequantize(q, s)
    torch.cuda.synchronize()
    assert (qz.int8_quantize.launches, qz.int8_dequantize.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(s, qz.int8_scale(x))
    assert torch.equal(q, qz.int8_quantize_plain(x, u, s))
    assert torch.equal(out, qz.int8_dequantize_plain(q, s))
    assert int(q.abs().max()) >= 126  # the scale spans the int8 range


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,n", [(0, 1, 1), (0, 5, 256 * 128 + 37), (16, 16, 73_728), (3, 64, 300)])
def test_dequant_combine_kernel_is_bit_exact(cuda, M, N, n):
    from repro_torch.kernels.quantize import dequant_combine, dequant_combine_plain

    rng = np.random.default_rng(N + n)
    a = torch.from_numpy(rng.dirichlet(np.ones(N), size=max(M, 1)).astype(np.float32)).cuda()
    a = a[0] if M == 0 else a
    s = torch.from_numpy(rng.uniform(0.001, 0.02, N).astype(np.float32)).cuda()
    q = _strided(torch.from_numpy(rng.integers(-127, 128, size=(N, n)).astype(np.int8)).cuda())
    before = dequant_combine.launches
    out = dequant_combine(a, s, q)
    torch.cuda.synchronize()
    assert dequant_combine.launches == before + 1
    assert torch.equal(out, dequant_combine_plain(a, s, q))


def _main_layout():
    """The width-16 ResNet-20 slab layout of the main path (K=16: 11 layer
    slots, 68 (slot, leaf) pieces, D = 309,248)."""
    from repro_torch.core.packing import build_slab_layout
    from repro_torch.models.resnet import init_resnet20
    from repro_torch.utils.pytree import LayerPartition

    p = init_resnet20(torch.Generator().manual_seed(0), width=16)
    return build_slab_layout(LayerPartition.build(p), p)


def _segment_case(K, n_cols, P, n_scale, seed, dtype=torch.float32, M=None, ldx_pad=0):
    """Seeded operands of a segment call: W a (P, M, N) transposed view (as
    the per-slot combines pass their matrices), scales (N, n_scale), xs
    (N, n_cols) in ``dtype`` and qs (N, n_cols) int8, each row ``ldx_pad``
    elements further apart than its width (a view), nonzero everywhere."""
    rng = np.random.default_rng(seed)
    M = K if M is None else M
    W = torch.from_numpy(rng.dirichlet(np.ones(K), size=(P, M)).astype(np.float32)).cuda()
    W = W.transpose(1, 2).contiguous().transpose(1, 2)
    s = torch.from_numpy(rng.uniform(0.001, 0.02, size=(K, n_scale)).astype(np.float32)).cuda()
    xs = torch.from_numpy(rng.normal(size=(K, n_cols)).astype(np.float32)).cuda().to(dtype)
    qs = torch.from_numpy(rng.integers(-127, 128, size=(K, n_cols)).astype(np.int8)).cuda()
    if ldx_pad:
        xs, qs = _strided(xs, ldx_pad), _strided(qs, ldx_pad)
    return W, s, xs, qs


def _one_launch_each(W, s, xs, qs, table):
    """Both segment kernels, each one launch, against their plain versions
    bit for bit; returns the two outputs."""
    from repro_torch.kernels import combine as wc
    from repro_torch.kernels import quantize as qz

    before = (wc.weighted_combine.launches, qz.dequant_combine.launches)
    out = wc.weighted_combine_segments(W, xs, table)
    out_q = qz.dequant_combine_segments(W, s, qs, table)
    torch.cuda.synchronize()
    assert (wc.weighted_combine.launches, qz.dequant_combine.launches) == (before[0] + 1, before[1] + 1)
    assert out.dtype == xs.dtype and out.shape == (W.shape[1], table.n_cols)
    assert torch.equal(out, wc.weighted_combine_segments_ref(W, xs, table))
    assert torch.equal(out_q, qz.dequant_combine_segments_plain(W, s, qs, table))
    return out, out_q


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["slots", "leaves"])
def test_segment_kernels_on_the_main_layout_are_bit_exact(cuda, kind):
    """The per-slot combines' tables of the K=16 slab (11 slots; 68 pieces
    with the lane padding in no segment): one launch each, bit for bit with
    the plain versions, and the padding exactly 0 although the sources are
    not zero there."""
    layout = _main_layout()
    table = layout.segment_table_on(kind, torch.device("cuda", 0))
    assert len(table.segments) == (11 if kind == "slots" else 68)
    W, s, xs, qs = _segment_case(16, layout.D, layout.num_layers, layout.n_scale_segs, seed=1)
    out, out_q = _one_launch_each(W, s, xs, qs, table)
    if kind == "leaves":
        for (s0, e0), size in zip(layout.layer_slices, layout.layer_sizes):
            assert torch.all(out_q[:, s0 + size : e0] == 0) and torch.all(out[:, s0 + size : e0] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,M,ldx_pad", [(16, 16, 0), (5, 3, 0), (5, 3, 3), (MAX_AGENTS, MAX_AGENTS, 0),
                                         (MAX_AGENTS, 17, 5), (1, 1, 0), (2, 7, 1)])
def test_segment_kernels_on_ragged_tables_are_bit_exact(cuda, dtype, K, M, ldx_pad):
    """Segments that start and end off every 4-column boundary, one column
    wide, across 512-column tile edges, with gaps; rows an odd number of
    elements apart (ldx_pad odd: the per-column path throughout); M != N,
    K = 64 (passes of 16 output rows), bf16 sources for weighted_combine."""
    from repro_torch.kernels.combine import segment_table

    segs = [(1, 3, 2, 1), (7, 500, 0, 4), (509, 6, 3, 0), (530, 1, 1, 2), (600, 2437, 2, 3), (3039, 61, 0, 1),
            (3100, 4096, 1, 5)]
    n_cols = 7300
    W, s, xs, qs = _segment_case(K, n_cols, 4, 6, seed=K * 10 + M, dtype=dtype, M=M, ldx_pad=ldx_pad)
    _one_launch_each(W, s, xs, qs, segment_table(segs, n_cols, torch.device("cuda", 0)))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 10, 513, 78_080])
def test_one_segment_call_equals_the_single_call_api(cuda, n):
    """A table of one segment over all columns and the single-call API
    (the kernel's null table) give the same bits, each in one launch."""
    from repro_torch.kernels import combine as wc
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels.combine import segment_table

    W, s, xs, qs = _segment_case(16, n, 1, 1, seed=n)
    out, out_q = _one_launch_each(W, s, xs, qs, segment_table([(0, n, 0, 0)], n, torch.device("cuda", 0)))
    before = (wc.weighted_combine.launches, qz.dequant_combine.launches)
    single = wc.weighted_combine(W[0], xs)
    single_q = qz.dequant_combine(W[0], s[:, 0], qs)
    torch.cuda.synchronize()
    assert (wc.weighted_combine.launches, qz.dequant_combine.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(single, out) and torch.equal(single_q, out_q)


@pytest.mark.gpu
@pytest.mark.parametrize("K,nb,n_segs", [(3, 1, 1), (5, 7, 4), (16, 2416, 64), (MAX_AGENTS, 3, 2)])
def test_slab_dequant_combine_kernel_matches_plain_version(cuda, K, nb, n_segs):
    """f32 sums of K products in another order: 1e-5 absolute on O(1)
    values; padding columns (q = 0) stay exactly zero; one launch."""
    from repro_torch.kernels.slab_combine import slab_dequant_combine, slab_dequant_combine_ref

    rng = np.random.default_rng(K + nb)
    A, _ = _inputs(K, nb)
    s = torch.from_numpy(rng.uniform(0.001, 0.02, size=(K, n_segs)).astype(np.float32)).cuda()
    seg = torch.from_numpy(np.sort(rng.integers(0, n_segs, nb * LANES)).astype(np.int32)).cuda()
    q = rng.integers(-127, 128, size=(K, nb * LANES)).astype(np.int8)
    q.reshape(K, nb, LANES)[:, :, LANES - 3 :] = 0
    q = torch.from_numpy(q).cuda()
    before = slab_dequant_combine.launches
    out = slab_dequant_combine(A, s, seg, q)
    torch.cuda.synchronize()
    assert slab_dequant_combine.launches == before + 1
    torch.testing.assert_close(out, slab_dequant_combine_ref(A, s, seg, q), rtol=0, atol=1e-5)
    assert torch.all(out.view(K, nb, LANES)[:, :, LANES - 3 :] == 0)


@pytest.mark.gpu
def test_api_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels import ops

    x = torch.ones(3, 4, device="cuda")
    with pytest.raises(TypeError):
        ops.weighted_combine(torch.ones(3, device="cuda"), x.double())
    with pytest.raises(ValueError, match="sources"):
        ops.weighted_combine(torch.ones(65, device="cuda"), torch.ones(65, 4, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        ops.weighted_combine(torch.ones(4, device="cuda"), x.T)
    with pytest.raises(ValueError):
        ops.weighted_combine(torch.ones(3), x)
    with pytest.raises(TypeError):
        ops.int8_quantize(x.double(), torch.zeros(3, 4, device="cuda", dtype=torch.float64))
    with pytest.raises(TypeError):
        ops.int8_dequantize(x, 1.0)
    with pytest.raises(TypeError):
        ops.dequant_combine(torch.ones(3, device="cuda"), torch.ones(3, device="cuda"), x)
    A, _ = _inputs(4, 2)
    q = torch.zeros(4, 2 * LANES, dtype=torch.int8, device="cuda")
    s = torch.ones(4, 2, device="cuda")
    seg = torch.zeros(2 * LANES, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        ops.slab_dequant_combine(A, s, seg.long(), q)
    with pytest.raises(ValueError, match="segments"):
        ops.slab_dequant_combine(A, s, seg + 2, q)


def _segment_ids(nb, cuts):
    """(nb * 128,) int32 scale segment ids that step up by one at each column
    of ``cuts``: a cut off every multiple of 4 puts two ids in one
    four-column group, a cut at a multiple of 128 starts a column block."""
    return torch.from_numpy(np.searchsorted(np.asarray(cuts), np.arange(nb * LANES), side="right")
                            .astype(np.int32)).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 3, 5, 16, MAX_AGENTS])
def test_slab_dequant_combine_kernel_routes_and_segment_edges(cuda, K):
    """Segment ids that change inside a four-column group (columns 6, 131,
    257 and 389) and at a 128-column boundary (128, 384); lane padding
    (q = 0) exactly 0; a (P, K, K) stack through a block map equals the
    per-block A_blocks route bit for bit; 1e-5 of the plain version; one
    launch a call."""
    from repro_torch.kernels.slab_combine import slab_dequant_combine, slab_dequant_combine_ref

    nb, P = 5, 7
    rng = np.random.default_rng(K)
    A = torch.from_numpy(np.ascontiguousarray(
        rng.dirichlet(np.ones(K), size=(P, K)).swapaxes(1, 2), np.float32)).cuda()
    block_map = torch.from_numpy(rng.integers(0, P, nb).astype(np.int32)).cuda()
    seg = _segment_ids(nb, [6, 128, 131, 257, 384, 389])
    s = torch.from_numpy(rng.uniform(0.001, 0.02, size=(K, 7)).astype(np.float32)).cuda()
    q = rng.integers(-127, 128, size=(K, nb * LANES)).astype(np.int8)
    q.reshape(K, nb, LANES)[:, :, LANES - 3 :] = 0
    q = torch.from_numpy(q).cuda()
    before = slab_dequant_combine.launches
    out_map = slab_dequant_combine(A, s, seg, q, block_map)
    torch.cuda.synchronize()
    assert slab_dequant_combine.launches == before + 1
    out = slab_dequant_combine(A[block_map.long()].contiguous(), s, seg, q)
    torch.cuda.synchronize()
    assert slab_dequant_combine.launches == before + 2
    assert torch.equal(out_map, out)
    torch.testing.assert_close(out, slab_dequant_combine_ref(A, s, seg, q, block_map), rtol=0, atol=1e-5)
    assert torch.all(out.view(K, nb, LANES)[:, :, LANES - 3 :] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [16, MAX_AGENTS])
def test_slab_dequant_combine_kernel_reads_scales_from_device_memory_when_they_do_not_fit(cuda, K):
    """A (K, 600) scale table (over the 32 KB the kernel stages in shared
    memory) is read from device memory: the same results, one launch."""
    from repro_torch.kernels.slab_combine import slab_dequant_combine, slab_dequant_combine_ref

    nb, n_segs = 9, 600
    rng = np.random.default_rng(K + n_segs)
    A, _ = _inputs(K, nb)
    s = torch.from_numpy(rng.uniform(0.001, 0.02, size=(K, n_segs)).astype(np.float32)).cuda()
    seg = torch.from_numpy(rng.integers(0, n_segs, nb * LANES).astype(np.int32)).cuda()
    q = torch.from_numpy(rng.integers(-127, 128, size=(K, nb * LANES)).astype(np.int8)).cuda()
    before = slab_dequant_combine.launches
    out = slab_dequant_combine(A, s, seg, q)
    torch.cuda.synchronize()
    assert slab_dequant_combine.launches == before + 1
    torch.testing.assert_close(out, slab_dequant_combine_ref(A, s, seg, q), rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4099])
def test_int8_round_kernel_on_ragged_and_unaligned_views(cuda, dtype, n):
    """The rounding kernel bit for bit with the plain version at lengths
    around its 16-element step, on aligned operands and on x or u views 1-3
    elements off a 16-byte boundary (the per-element path); one launch a
    call."""
    from repro_torch.kernels import quantize as qz

    rng = np.random.default_rng(n)
    xb = torch.from_numpy(rng.normal(size=n + 8).astype(np.float32)).cuda().to(dtype)
    ub = torch.from_numpy(rng.uniform(size=n + 8).astype(np.float32)).cuda()
    for off in range(4):
        for x, u in ((xb[off : off + n], ub[:n]), (xb[:n], ub[off : off + n])):
            before = qz.int8_quantize.launches
            q, s = qz.int8_quantize(x, u)
            torch.cuda.synchronize()
            assert qz.int8_quantize.launches == before + 1
            assert torch.equal(q, qz.int8_quantize_plain(x, u, s)), (off, x.data_ptr() % 16, u.data_ptr() % 16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_int8_round_kernel_clips_at_127(cuda, dtype):
    """x = +-absmax with u just below 1 (and 0) reaches the clip on both
    sides: bit for bit with the plain version, q in [-127, 127]."""
    from repro_torch.kernels import quantize as qz

    x = torch.tensor([1.5, -1.5, 0.25, -0.75] * 9, device="cuda").to(dtype)
    u = torch.tensor([float(np.nextafter(np.float32(1), np.float32(0))), 0.0] * 18, device="cuda")
    q, s = qz.int8_quantize(x, u)
    torch.cuda.synchronize()
    assert torch.equal(q, qz.int8_quantize_plain(x, u, s))
    assert (int(q.max()), int(q.min())) == (127, -127)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4099, 16 * 309_248])
def test_int8_dequantize_kernel_on_ragged_and_unaligned_views(cuda, n):
    """``q * s`` bit for bit with the plain version at lengths around the
    kernel's 16-element step and at the main path's slab, on aligned ``q``
    (the 16-byte path) and on views 1-3 elements off a 16-byte boundary
    (the per-element path); one launch a call."""
    from repro_torch.kernels import quantize as qz

    rng = np.random.default_rng(n)
    qb = torch.from_numpy(rng.integers(-128, 128, size=n + 8).astype(np.int8)).cuda()
    s = torch.tensor(float(rng.uniform(0.001, 0.02)), device="cuda")
    for off in range(4):
        q = qb[off : off + n]
        before = qz.int8_dequantize.launches
        out = qz.int8_dequantize(q, s)
        torch.cuda.synchronize()
        assert qz.int8_dequantize.launches == before + 1
        assert torch.equal(out, qz.int8_dequantize_plain(q, s)), (off, q.data_ptr() % 16)


def _bwd_tol(dtype, ref):
    """The backward kernel against its plain version: f32, sums over the
    keys in another order, 1e-5 of the largest |value|; bf16, both round an
    f32 result once to bf16 (at most one step apart, 2^-7 relative) plus
    2^-10 of the largest |value| for the f32 sums' order on entries near 0.
    The scale is never under 1: the gradients are sums of O(1) terms of
    O(1) inputs, and one that cancels to 0 (dq at S = 1) is still rounded
    on that scale."""
    m = max(float(ref.float().abs().max()), 1.0)
    if dtype == torch.float32:
        return dict(rtol=0, atol=1e-5 * m)
    return dict(rtol=2**-7, atol=2**-10 * m)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,hd", [(1, 4, 2, 37, 32), (2, 8, 2, 130, 64), (1, 4, 1, 256, 128),
                                          (1, 2, 2, 1, 128), (1, 8, 8, 65, 64)])
def test_flash_attention_bwd_kernel_matches_plain_version(cuda, dtype, B, H, Hkv, S, hd):
    """The backward kernel at every head dim, GQA group and ragged length,
    on the model's strided layout, given the forward kernel's own o and
    log-sum-exp: within :func:`_bwd_tol` of the plain version on the same
    inputs, two runs bit-identical, three launches a call."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _attention_inputs(B, H, Hkv, S, hd, dtype, seed=S + hd)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, return_lse=True)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-5 if dtype == torch.float32 else 1e-4)
    do = _attention_inputs(B, H, Hkv, S, hd, dtype, seed=1)[0]
    before = fa.flash_attention_bwd.launches
    got, again = fa.flash_attention_bwd(q, k, v, o, do, lse), fa.flash_attention_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 2 * fa.BWD_LAUNCHES_PER_CALL
    for name, a, b, r in zip(("dq", "dk", "dv"), got, again, fa.flash_attention_bwd_ref(q, k, v, o, do, lse)):
        assert a.dtype == dtype and a.shape == r.shape, name
        assert torch.equal(a, b), ("not bit-reproducible", name)
        torch.testing.assert_close(a.float(), r.float(), **_bwd_tol(dtype, r))


@pytest.mark.gpu
def test_kernel_wrappers_never_drop_a_gradient(cuda):
    """On CUDA inputs that require a gradient: the raw flash_attention
    wrapper and selective_scan raise (neither output would carry one);
    ``FlashAttention`` carries it through the backward kernel, equal to
    autograd through the plain version (f32)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.selective_scan import selective_scan

    q, k, v = (t.detach().requires_grad_(True) for t in _attention_inputs(1, 4, 2, 40, 64, torch.float32))
    with pytest.raises(RuntimeError, match="FlashAttention"):
        fa.flash_attention(q, k, v)
    (fa.FlashAttention.apply(q, k, v) * 1.5).sum().backward()
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad((fa.flash_attention_ref(*leaves) * 1.5).sum(), leaves)
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    dt = torch.ones(1, 4, 8, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="#5b"):
        selective_scan(dt, -torch.ones(8, 4, device="cuda"), torch.ones(1, 4, 4, device="cuda"),
                       torch.ones(1, 4, 4, device="cuda"), torch.ones(1, 4, 8, device="cuda"))


@pytest.mark.gpu
def test_lm_train_step_on_the_card_runs_its_kernels(cuda):
    """One exact DRT train step of four tiny qwen3-8b-smoke agents (f32, no
    remat) on the card: finite loss, and per step 2 forward and 2 backward
    attention calls an agent (3 launches each backward) and one
    ``slab_combine``, equal to the same step on the CPU within 1e-4 of each
    leaf's largest magnitude (the agents start apart)."""
    from repro_torch.comm import prng
    from repro_torch.core.topology import make_topology
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.slab_combine import slab_combine
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.optim.optimizers import momentum
    from repro_torch.utils.pytree import tree_items, tree_map

    cfg = registry.get_config("qwen3-8b-smoke", d_model=32, vocab=64, d_ff=64)
    bundle = registry.build_bundle(cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, size=(4, 2, 17)))
    out = {}
    for dev in ("cpu", "cuda"):
        s0 = train.init_train_state(bundle, momentum(0.1, 0.9), torch.Generator().manual_seed(0))
        # the agents start apart: DRT's Gram-derived distances are badly
        # conditioned when the spread is tiny against the norms
        g = torch.Generator().manual_seed(1)
        apart = tree_map(lambda x: x + 0.05 * torch.randn(x.shape, generator=g), s0.params)
        state = train.state_to(s0._replace(params=apart), dev)
        step = train.make_train_step(bundle, make_topology("ring", 4), momentum(0.1, 0.9), device=dev)
        counts = (fa.flash_attention.launches, fa.flash_attention_bwd.launches, slab_combine.launches)
        state, m = step(state, {"tokens": tokens}, prng.key(0))
        torch.cuda.synchronize()
        delta = [a - b for a, b in zip((fa.flash_attention.launches, fa.flash_attention_bwd.launches,
                                        slab_combine.launches), counts)]
        assert delta == ([8, 8 * fa.BWD_LAUNCHES_PER_CALL, 1] if dev == "cuda" else [0, 0, 0]), delta
        assert torch.isfinite(m["loss"])
        out[dev] = {p: x.cpu() for p, x in tree_items(state.params)}
    for p, ref in out["cpu"].items():
        torch.testing.assert_close(out["cuda"][p], ref, rtol=0, atol=1e-4 * float(ref.abs().max()), msg=str(p))
