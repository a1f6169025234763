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
@pytest.mark.parametrize("K,nb", [(3, 1), (4, 5), (16, 2416), (MAX_AGENTS, 3)])
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
@pytest.mark.parametrize("K,nb", [(3, 1), (5, 7), (16, 2416), (MAX_AGENTS, 3)])
def test_slab_quant_encode_kernel_is_bit_exact(cuda, K, nb):
    """The int8 wire is integer arithmetic and IEEE division: bit for bit
    the plain version; one launch counted."""
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
    out_ref, A_ref = slab_codec.slab_encode_combine_ref(bl, slab, ops, mix, **kw)
    torch.testing.assert_close(out, out_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(A, A_ref.expand_as(A), rtol=0, atol=5e-6)


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
    ref = ss.slab_edge_combine_ref(bl, x, dec, *edges, **kw)
    torch.testing.assert_close(out, ref[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(A_self, ref[1].expand_as(A_self), rtol=0, atol=5e-6)
    torch.testing.assert_close(A_e, ref[2].expand_as(A_e), rtol=0, atol=5e-6)
    cpu = packing.edge_combine(A_self.cpu(), A_e.cpu(), edges[0].cpu(), edges[1].cpu(), x.cpu(), dec.cpu(),
                               bl.cpu())
    assert torch.equal(out.cpu(), cpu)


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
    each sum (as in chip_smoke.py); two runs give the same bits; two
    launches per call."""
    from repro_torch.kernels import drt_dist as dd

    sizes = _main_layer_sizes() if n == "layers" else [n]
    rng = np.random.default_rng(len(sizes))
    for size in sizes:
        x, y = (torch.from_numpy(a).cuda() for a in rng.normal(size=(2, size)).astype(np.float32))
        before = dd.drt_dist.launches
        got = dd.drt_dist(x, y)
        again = dd.drt_dist(x, y)
        torch.cuda.synchronize()
        assert dd.drt_dist.launches == before + 2 * dd.LAUNCHES_PER_CALL
        assert torch.equal(got, again)
        torch.testing.assert_close(got, dd.drt_dist_ref(x, y), rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("N,nb", [(1, 7), (3, 2416), (5, 2416), (7, 13), (64, 3)])
def test_slab_source_combine_kernel_is_bit_exact(cuda, N, nb):
    """The kernel and the plain version both walk the sources in order and
    round product and sum apart: bit for bit; one launch per call."""
    from repro_torch.kernels.slab_combine import slab_source_combine, slab_source_combine_ref

    rng = np.random.default_rng(N + nb)
    w = torch.from_numpy(rng.dirichlet(np.ones(N), size=nb).astype(np.float32)).cuda()
    srcs = torch.from_numpy(rng.normal(size=(N, nb * LANES)).astype(np.float32)).cuda()
    before = slab_source_combine.launches
    out = slab_source_combine(w, srcs)
    torch.cuda.synchronize()
    assert slab_source_combine.launches == before + 1
    assert torch.equal(out, slab_source_combine_ref(w, srcs))


@pytest.mark.gpu
def test_permute_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels.drt_dist import drt_dist
    from repro_torch.kernels.slab_combine import MAX_SOURCES, slab_source_combine

    x = torch.randn(300, device="cuda")
    with pytest.raises(TypeError):
        drt_dist(x.double(), x.double())
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
        L = part.num_layers
        assert after[0] - before[0] == on_card * K * rounds * 2 * L * dd.LAUNCHES_PER_CALL
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
    """f32: sums over the keys in another order, 1e-5.  bf16: both round an
    f32 result to bf16, so they may differ by one bf16 step (2^-7
    relative).  One launch counted; out in q's dtype."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    q, k, v = _attention_inputs(B, H, Hkv, S, hd, dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == (B, H, S, hd) and out.dtype == dtype
    ref = flash_attention_ref(q, k, v)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-5)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,di,ds", [(2, 37, 16, 4), (1, 1, 100, 16), (2, 130, 200, 8), (1, 33, 64, 16)])
def test_selective_scan_kernel_matches_plain_version(cuda, x_dtype, B, S, di, ds):
    """y and h_last within 1e-5 of the largest |value| (f32 steps with and
    without fused multiply-adds, y's sum over ds in another order)."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_ref

    g = torch.Generator(device="cuda").manual_seed(S * di)
    dt = torch.nn.functional.softplus(torch.randn(B, S, di, generator=g, device="cuda") - 2.0)
    A = -torch.arange(1, ds + 1, dtype=torch.float32, device="cuda").expand(di, ds).contiguous()
    Bm, Cm = (torch.randn(B, S, ds, generator=g, device="cuda") for _ in range(2))
    x = torch.randn(B, S, di, generator=g, device="cuda").to(x_dtype)
    before = selective_scan.launches
    y, h = selective_scan(dt, A, Bm, Cm, x)
    torch.cuda.synchronize()
    assert selective_scan.launches == before + 1
    y_ref, h_ref = selective_scan_ref(dt, A, Bm, Cm, x)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-5 * max(1.0, float(y_ref.abs().max())))
    torch.testing.assert_close(h, h_ref, rtol=0, atol=1e-5 * max(1.0, float(h_ref.abs().max())))


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
