"""The port's wire layer against the reference, bit for bit: the counter
hash (``repro_torch.comm.rng``), the threefry key derivation
(``repro_torch.comm.prng``), the codec registry and wire bytes, and the
slab wire itself (int8 ``q`` and scales, bf16/f16 casts, top-k sent values
and residual) on a small ResNet-20 whose conv leaves sit in another layout
on each side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import accounting as ref_accounting
from repro.comm import codec as ref_codec
from repro.comm import rng as ref_rng
from repro.core import packing as ref_packing
from repro.core.consensus import _agent_keys
from repro.utils.pytree import LayerPartition as RefLayerPartition
from repro_torch import bridge
from repro_torch.comm import accounting, codec, prng, rng
from repro_torch.core import consensus, packing
from repro_torch.models.resnet import init_resnet20
from repro_torch.utils.pytree import LayerPartition, agent_template, tree_items

torch.set_num_threads(1)
K = 4
EDGES = np.array(
    [0, 1, 2, 0xFFFF, 0x10000, 2**31 - 1, 2**31, 2**32 - 1,
     rng.PHI, rng.C1, rng.C2, rng.PHI - 1, rng.C2 + 1],
    np.uint32,
)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_mul32_keeps_the_low_32_bits():
    """The split multiply equals numpy's wrapping uint32 product for edge
    values and random ones, with every constant the hash uses."""
    x = np.concatenate([EDGES, np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)])
    for c in (rng.PHI, rng.C1, rng.C2, 0xFFFFFFFF, 1):
        want = x * np.uint32(c)
        np.testing.assert_array_equal(_u32(rng.mul32(torch.from_numpy(x.astype(np.int64)), c)), want)


def test_counter_hash_matches_reference_at_edge_values():
    """fmix32, counter_bits and the uniforms equal ``repro.comm.rng`` on
    every combination of edge words and counters (int32 bit patterns read
    back as their uint32)."""
    w0, w1, idx = np.meshgrid(EDGES, EDGES, EDGES, indexing="ij")
    w0, w1, idx = (a.ravel() for a in (w0, w1, idx))
    want_mix = np.asarray(ref_rng.fmix32(jnp.asarray(EDGES)))
    np.testing.assert_array_equal(_u32(rng.fmix32(torch.from_numpy(EDGES.astype(np.int64)))), want_mix)
    want = np.asarray(ref_rng.counter_bits(jnp.asarray(w0), jnp.asarray(w1), jnp.asarray(idx)))
    as_i32 = [torch.from_numpy(a.view(np.int32)) for a in (w0, w1, idx)]
    got = rng.counter_bits(*as_i32)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(
        rng.bits_to_uniform(got).numpy(), np.asarray(ref_rng.bits_to_uniform(jnp.asarray(want)))
    )
    u = rng.uniform_from_words(*as_i32).numpy()
    assert u.dtype == np.float32 and u.min() >= 0.0 and u.max() < 1.0


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_threefry_keys_match_jax(seed):
    """Under ``jax_threefry_partitionable=True`` (JAX's default):
    ``key_data(key(s)) == [0, s]``, ``fold_in`` is threefry2x32 of
    ``(0, i)``, ``split(k, n)[i] == fold_in(k, i)``, and per-leaf words of
    per-agent keys equal the reference's ``leaf_key_words``."""
    assert jax.config.jax_threefry_partitionable
    k = jax.random.key(seed)
    np.testing.assert_array_equal(prng.key(seed), np.asarray(jax.random.key_data(k)))
    data = np.array([0, 1, 5, 2**31, 2**32 - 1], np.uint32)
    want = np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(k, int(d)))) for d in data])
    np.testing.assert_array_equal(prng.fold_in(prng.key(seed), data), want)
    np.testing.assert_array_equal(prng.split(prng.key(seed), 6), np.asarray(jax.random.key_data(jax.random.split(k, 6))))
    np.testing.assert_array_equal(prng.split(prng.key(seed), 6), prng.fold_in(prng.key(seed), np.arange(6)))
    # the coded round's derivation: round key, agent keys, per-leaf words
    agents = _agent_keys(jax.random.fold_in(k, 2), K)
    port_agents = prng.fold_in(prng.fold_in(prng.key(seed), 2), np.arange(K))
    np.testing.assert_array_equal(port_agents, np.asarray(jax.random.key_data(agents)))
    leaf_words = np.asarray(jax.random.key_data(jax.vmap(lambda a: jax.random.split(a, 9))(agents)))
    np.testing.assert_array_equal(prng.split(port_agents, 9), leaf_words)
    with pytest.raises(ValueError):
        prng.key(2**32)


def test_counter_uniform_matches_reference():
    words = prng.split(prng.key(3), 2)[1]
    want = np.asarray(ref_rng.counter_uniform(jax.random.split(jax.random.key(3), 2)[1], (5, 7, 3)))
    np.testing.assert_array_equal(rng.counter_uniform(words, (5, 7, 3)).numpy(), want)


def _small_resnet(seed=1, spread=0.1):
    """K agents of a width-4 ResNet-20 in the reference layout, the same
    weights in the port's, and both layouts."""
    p0 = bridge.params_to_jax(init_resnet20(torch.Generator().manual_seed(seed), width=4))
    r = np.random.default_rng(seed)
    ref_K = jax.tree.map(lambda x: x[None] + spread * r.normal(size=(K, *x.shape)).astype(np.float32), p0)
    port_K = bridge.params_from_jax(ref_K, device="cpu")
    t = agent_template(port_K)
    layout = packing.build_slab_layout(LayerPartition.build(t), t)
    ref_t = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), ref_K)
    ref_layout = ref_packing.build_slab_layout(RefLayerPartition.build(ref_t), ref_t)
    return ref_K, port_K, layout, ref_layout


SPECS = ["identity", "bf16", "f16", "int8", "topk", "topk:0.05", "topk:0.3:0"]


def test_codec_registry_and_wire_bytes_match_reference():
    ref_K, port_K, _, _ = _small_resnet()
    template = agent_template(port_K)
    ref_template = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), ref_K)
    assert codec.codec_names() == ref_codec.codec_names()
    for spec in SPECS:
        c, rc = codec.make_codec(spec), ref_codec.make_codec(spec)
        assert (c.name, c.stateful, c.needs_rng) == (rc.name, rc.stateful, rc.needs_rng)
        assert accounting.wire_bytes(template, spec) == ref_accounting.wire_bytes(ref_template, spec)
        assert accounting.compression_ratio(template, spec) == ref_accounting.compression_ratio(ref_template, spec)
    assert isinstance(codec.make_codec(None), codec.IdentityCodec)
    for bad in ("gzip", "topk:2", "topk:x", "topk:0.1:-1"):
        with pytest.raises(ValueError):
            codec.make_codec(bad)
    for n in (1, 7, 1024, 1025, 6912, 100_000):
        for frac in (0.01, 0.1, 0.25, 1.0):
            for sample in (0, 64, 1024):
                assert codec.topk_sample_plan(n, frac, sample) == ref_codec._topk_sample_plan(n, frac, sample)


def test_init_comm_state():
    _, port_K, _, _ = _small_resnet()
    res = codec.init_comm_state("topk:0.1", port_K)
    for (pa, a), (pb, b) in zip(tree_items(res), tree_items(port_K)):
        assert pa == pb and a.shape == b.shape and a.dtype == torch.float32 and not a.any()
    for spec in ("int8", "bf16", None):
        assert codec.init_comm_state(spec, port_K) == ()


def _port_tree(layout, port_K, slab):
    """A port (K, D) slab -> a tree of numpy arrays in the reference layout."""
    return bridge.params_to_jax(layout.unpack(slab.float(), like=port_K))


def _ref_tree(ref_layout, ref_K, regions):
    regions = tuple(jnp.asarray(r, jnp.float32) for r in regions)
    return jax.tree.map(np.asarray, ref_layout.unpack_regions(regions, like=ref_K, dtype=jnp.float32))


def _assert_trees_equal(got, want):
    got, want = list(tree_items(got)), list(tree_items(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_layout_maps_match_reference_after_conv_permutation():
    """Scale segments, rng leaf indices and reference element indices of
    every column equal the reference's, element for element, once the
    port's columns are carried back to the reference layout."""
    ref_K, port_K, layout, ref_layout = _small_resnet()
    assert layout.D == ref_layout.D
    assert layout.n_tree_leaves == ref_layout.n_tree_leaves
    assert layout.n_scale_segs == ref_layout.n_scale_segs
    names = ("col_scale_seg", "col_leaf", "col_idx")
    ref_maps = np.stack([getattr(ref_layout, n).astype(np.float32) for n in names])  # (3, D)
    ref_trees = jax.jit(lambda m: ref_layout.unpack_regions(
        ref_layout.split(jnp.broadcast_to(m[:, None], (3, K, layout.D))), like=ref_K, dtype=jnp.float32
    ))(ref_maps)
    for i, name in enumerate(names):
        port_map = torch.from_numpy(getattr(layout, name).astype(np.float32))[None].expand(K, -1)
        want = jax.tree.map(lambda x: np.asarray(x[i]), ref_trees)
        _assert_trees_equal(_port_tree(layout, port_K, port_map), want)
    # padding columns, which no tree leaf holds, carry the reference's values too
    for (s, e), size in zip(layout.layer_slices, layout.layer_sizes):
        np.testing.assert_array_equal(layout.col_scale_seg[s + size : e], ref_layout.col_scale_seg[s + size : e])
        np.testing.assert_array_equal(layout.col_leaf[s + size : e], ref_layout.col_leaf[s + size : e])
        assert not layout.col_idx[s + size : e].any()


@pytest.mark.parametrize("spec", ["int8", "bf16", "f16", "topk:0.1", "topk:0.3:0"])
def test_slab_wire_matches_reference_bit_for_bit(spec):
    """The port's ``slab_encode_batched`` (int8 through the
    ``slab_quant_encode`` wrapper, its plain version on the CPU) against
    the reference's, from the same weights and keys: int8 ``q``, scales
    and decoded view; bf16/f16 casts; top-k sent values and residual over
    two rounds (the second with the carried residual).  The width-4
    ResNet-20 has conv leaves (a different element order on each side)
    and leaves above the top-k sample size (strided thresholds)."""
    ref_K, port_K, layout, ref_layout = _small_resnet(spread=0.1)
    rc, c = ref_codec.make_codec(spec), codec.make_codec(spec)
    keys = _agent_keys(jax.random.key(5), K)
    port_keys = prng.fold_in(prng.key(5), np.arange(K))
    slab = layout.pack(port_K)

    @jax.jit
    def ref_encode(tree, res):
        return ref_packing.slab_encode_batched(rc, ref_layout, ref_layout.pack_regions(tree), res, keys)

    wire, st = ref_encode(ref_K, ())
    pw, pst = consensus.slab_encode_batched(c, layout, slab, (), port_keys)
    if spec == "int8":
        assert pw.q.dtype == torch.int8
        _assert_trees_equal(_port_tree(layout, port_K, pw.q), _ref_tree(ref_layout, ref_K, wire.q))
        np.testing.assert_array_equal(pw.s.numpy(), np.asarray(wire.s))
        decoded = jax.jit(lambda w: ref_packing.slab_decode(rc, ref_layout, w))(wire)
        _assert_trees_equal(
            _port_tree(layout, port_K, consensus.slab_decode(c, layout, pw)),
            _ref_tree(ref_layout, ref_K, decoded),
        )
    elif spec in ("bf16", "f16"):
        assert pw.dtype == c.dtype
        _assert_trees_equal(_port_tree(layout, port_K, pw), _ref_tree(ref_layout, ref_K, wire))
    else:
        _assert_trees_equal(_port_tree(layout, port_K, pw), _ref_tree(ref_layout, ref_K, wire))
        _assert_trees_equal(_port_tree(layout, port_K, pst), _ref_tree(ref_layout, ref_K, st))
        wire2, st2 = ref_encode(ref_K, st)
        pw2, pst2 = consensus.slab_encode_batched(c, layout, slab, pst, port_keys)
        _assert_trees_equal(_port_tree(layout, port_K, pw2), _ref_tree(ref_layout, ref_K, wire2))
        _assert_trees_equal(_port_tree(layout, port_K, pst2), _ref_tree(ref_layout, ref_K, st2))
        assert 0 < int((pw != 0).sum()) < pw.numel()
