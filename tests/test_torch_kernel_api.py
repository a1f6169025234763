"""The kernel API (``repro_torch.kernels.ops``) against the reference's.

The plain versions of the five kernels of this slice (``weighted_combine``,
``int8_quantize``, ``int8_dequantize``, ``dequant_combine``,
``slab_dequant_combine``) are held against the Pallas kernels in interpret
mode on the same inputs, made with numpy (the uniforms of ``int8_quantize``
with ``jax.random.uniform``); the ``ref`` oracles against the reference's;
the per-slot and fused int8 slab combines against the reference's parity
helpers; and ``SlabLayout.combine_unpack`` / ``scale_by_layer`` against the
reference's.  CPU tensors run the plain versions: no kernel launches here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import make_codec as ref_make_codec
from repro.core import consensus as ref_consensus
from repro.core import packing as ref_packing
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.utils.pytree import LayerPartition as RefLayerPartition
from repro_torch.comm import prng
from repro_torch.comm.codec import make_codec
from repro_torch.core import consensus, packing
from repro_torch.kernels import combine as combine_mod
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as quantize_mod
from repro_torch.kernels import slab_combine as slab_combine_mod
from repro_torch.utils.pytree import LayerPartition, agent_template, tree_items

torch.set_num_threads(1)
K = 4
D_ODD = 256 * 128 + 37  # one full Pallas block (256 x 128) and a ragged tail
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
BF16_STEP = 2.0**-8  # bf16 keeps 8 significant bits: one step is 2^-8 of the value or less


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.float() if x.dtype == torch.bfloat16 else x)


@pytest.mark.parametrize("N", [1, 3, 5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_weighted_combine_matches_pallas(dtype, N):
    """f32: 1e-5 relative of the largest |value| (the Pallas body's f32 sum
    in the same order; XLA may contract it into fmas).  bf16: one bf16
    step.  The batched (M, N) call equals M single calls bit for bit."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(N)
    a = rng.dirichlet(np.ones(N)).astype(np.float32)
    xs = rng.normal(size=(N, D_ODD)).astype(np.float32)
    want = np.asarray(ref_ops.weighted_combine(jnp.asarray(a), jnp.asarray(xs).astype(jdt), interpret=True),
                      np.float32)
    x_t = _t(xs).to(tdt)
    got = ops.weighted_combine(_t(a), x_t)
    assert got.dtype == tdt and got.shape == (D_ODD,)
    scale = np.abs(want).max()
    tol = 1e-5 * scale if dtype == "f32" else BF16_STEP * scale
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol)
    np.testing.assert_allclose(_np(ops.ref.combine_ref(_t(a), x_t)), want, rtol=0, atol=tol)
    W = rng.dirichlet(np.ones(N), size=3).astype(np.float32)
    wide = torch.zeros(N, D_ODD + 7, dtype=tdt)
    wide[:, 7:] = x_t
    batched = ops.weighted_combine(_t(W), wide[:, 7:])  # rows D_ODD + 7 apart, no copy
    for m in range(3):
        assert torch.equal(batched[m], ops.weighted_combine(_t(W[m]), x_t))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_quantize_matches_pallas_bit_for_bit(dtype):
    """The same uniforms (``jax.random.uniform(key, x.shape)``, as the
    reference draws them inside its wrapper) through both: the scale and
    every int8 value equal the Pallas kernel's.  The reference's oracle
    ``int8_quantize_ref`` divides by the scale where the kernels multiply
    by its reciprocal: the two can land on either side of an integer only
    where ``x / s + u`` sits within a rounding of it; counted (none of the
    33,333 values here), and never more than one apart."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 11_111)) * 0.7).astype(np.float32)
    key = jax.random.key(5)
    u = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    xj = jnp.asarray(x).astype(jdt)
    q_r, s_r = ref_ops.int8_quantize(xj, key, interpret=True)
    q, s = ops.int8_quantize(_t(x).to(tdt), _t(u))
    assert q.dtype == torch.int8 and q.shape == x.shape
    assert s.numpy().tobytes() == np.asarray(s_r).tobytes()
    assert int((q.numpy() != np.asarray(q_r)).sum()) == 0
    by_division = ops.ref.int8_quantize_ref(_t(x).to(tdt), _t(u), s)
    div_ref = np.asarray(ref_ref.int8_quantize_ref(xj, jnp.asarray(u), s_r))
    np.testing.assert_array_equal(by_division.numpy(), div_ref)
    n_rule = int((by_division.numpy() != q.numpy()).sum())
    print(f"int8_quantize {dtype}: {n_rule} of {x.size} values differ between the reciprocal and division rules")
    assert n_rule <= 1e-3 * x.size, n_rule  # one rounding apart, at an integer boundary only
    assert np.abs(by_division.numpy().astype(int) - q.numpy()).max() <= 1


def test_int8_quantize_of_zeros_takes_scale_one():
    q, s = ops.int8_quantize(torch.zeros(5, 3), torch.full((5, 3), 0.5))
    assert float(s) == 1.0 and not q.any()


def test_int8_dequantize_matches_pallas_exactly():
    rng = np.random.default_rng(4)
    q = rng.integers(-127, 128, size=(7, 5003)).astype(np.int8)
    s = np.float32(0.0123)
    want = np.asarray(ref_ops.int8_dequantize(jnp.asarray(q), jnp.asarray(s), interpret=True))
    got = ops.int8_dequantize(_t(q), torch.tensor(s))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ops.ref.int8_dequantize_ref(_t(q), torch.tensor(s)).numpy(), want)


@pytest.mark.parametrize("N", [1, 3, 5])
def test_dequant_combine_matches_pallas(N):
    """1e-5 relative of the largest |value|; batched rows equal single
    calls bit for bit; the tensordot oracle agrees with the reference's."""
    rng = np.random.default_rng(10 + N)
    a = rng.dirichlet(np.ones(N)).astype(np.float32)
    s = rng.uniform(0.001, 0.02, N).astype(np.float32)
    q = rng.integers(-127, 128, size=(N, D_ODD)).astype(np.int8)
    want = np.asarray(ref_ops.dequant_combine(jnp.asarray(a), jnp.asarray(s), jnp.asarray(q), interpret=True))
    got = ops.dequant_combine(_t(a), _t(s), _t(q))
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    oracle = np.asarray(ref_ref.dequant_combine_ref(jnp.asarray(a), jnp.asarray(s), jnp.asarray(q)))
    np.testing.assert_allclose(ops.ref.dequant_combine_ref(_t(a), _t(s), _t(q)).numpy(), oracle, rtol=0, atol=tol)
    W = rng.dirichlet(np.ones(N), size=2).astype(np.float32)
    batched = ops.dequant_combine(_t(W), _t(s), _t(q))
    for m in range(2):
        assert torch.equal(batched[m], ops.dequant_combine(_t(W[m]), _t(s), _t(q)))


def _slab_setup():
    """The reference test's tree (tests/test_kernels.py ``_slab_setup``),
    from numpy: multi-leaf groups whose widths force lane padding; no conv
    leaf, so both sides pack the same columns."""
    rng = np.random.default_rng(0)

    def n(*shape):
        return rng.normal(size=(K, *shape)).astype(np.float32)

    tree = {"embed": {"b": n(5), "w": n(4, 8)}, "blocks": {"g": n(3, 7), "s": n(3), "w": n(3, 8, 8)}}
    ref_t = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), tree)
    ref_layout = ref_packing.build_slab_layout(RefLayerPartition.build(ref_t), ref_t)
    port_K = {g: {k: _t(v) for k, v in leaves.items()} for g, leaves in tree.items()}
    layout = packing.build_slab_layout(LayerPartition.build(agent_template(port_K)), agent_template(port_K))
    A = rng.dirichlet(np.ones(K), size=(layout.num_layers, K)).swapaxes(1, 2).astype(np.float32)
    return tree, ref_layout, port_K, layout, np.ascontiguousarray(A)


def _counting(monkeypatch, name):
    """Count the calls ``consensus`` makes to one kernel wrapper (on the CPU
    a call runs the plain version; on the card each is one launch)."""
    calls = []
    real = getattr(consensus, name)
    monkeypatch.setattr(consensus, name, lambda *a: calls.append(1) or real(*a))
    return calls


def test_slab_parity_helpers_match_reference(monkeypatch):
    """The per-slot combine, the per-(slot, leaf) int8 combine and the fused
    int8 slab combine against the reference's (``_combine_slab_per_slot``,
    ``_dequant_combine_slab_per_slot``, ``_dequant_combine_slab_kernels``,
    the Pallas kernels in interpret mode), 1e-5 as the reference holds them
    against each other; padding lanes exactly 0; the wrapper calls are the
    stated launch counts."""
    tree, ref_layout, port_K, layout, A = _slab_setup()
    regions = ref_layout.pack_regions(jax.tree.map(jnp.asarray, tree))
    slab = layout.pack(port_K)
    np.testing.assert_array_equal(slab.numpy(), np.asarray(ref_layout.join(regions)))

    calls = _counting(monkeypatch, "weighted_combine")
    per_slot = consensus.combine_slab_per_slot(layout, _t(A), slab)
    assert len(calls) == layout.num_layers == 4
    want = np.asarray(ref_layout.join(ref_consensus._combine_slab_per_slot(ref_layout, jnp.asarray(A), regions)))
    np.testing.assert_allclose(per_slot.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(consensus.combine_slab_kernels(layout, _t(A), slab).numpy(), want, rtol=0, atol=1e-5)

    codec = make_codec("int8")
    keys = prng.fold_in(prng.key(5), np.arange(K))
    wire, _ = consensus.slab_encode_batched(codec, layout, slab, (), keys)
    ref_keys = ref_consensus._agent_keys(jax.random.key(5), K)
    ref_codec = ref_make_codec("int8")
    ref_wire, _ = jax.vmap(
        lambda s, k: ref_packing.slab_encode(ref_codec, ref_layout, s, (), k),
        in_axes=(1, 0), out_axes=(ref_packing.wire_out_axes(ref_codec), 0),
    )(regions, ref_keys)
    np.testing.assert_array_equal(wire.q.numpy(), np.asarray(ref_layout.join(ref_wire.q)))
    A_off = A * (1.0 - np.eye(K, dtype=np.float32))[None]
    calls = _counting(monkeypatch, "dequant_combine")
    got_slot = consensus.dequant_combine_slab_per_slot(layout, _t(A_off), wire)
    assert len(calls) == consensus.dequant_per_slot_launches(layout) == 2 + 3 * 3
    calls = _counting(monkeypatch, "slab_dequant_combine")
    got_fused = consensus.dequant_combine_slab_kernels(layout, _t(A_off), wire)
    assert len(calls) == 1
    want_slot = np.asarray(ref_layout.join(
        ref_consensus._dequant_combine_slab_per_slot(ref_layout, jnp.asarray(A_off), ref_wire)))
    want_fused = np.asarray(ref_layout.join(
        ref_consensus._dequant_combine_slab_kernels(ref_layout, jnp.asarray(A_off), ref_wire)))
    for got in (got_slot, got_fused):
        np.testing.assert_allclose(got.numpy(), want_slot, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want_fused, rtol=0, atol=1e-5)
    decoded = consensus.slab_decode(codec, layout, wire)
    np.testing.assert_allclose(got_fused.numpy(), consensus.combine_slab_kernels(layout, _t(A_off), decoded).numpy(),
                               rtol=0, atol=1e-5)
    for out in (per_slot, got_slot, got_fused):
        for (s, e), size in zip(layout.layer_slices, layout.layer_sizes):
            assert torch.all(out[:, s + size : e] == 0), "lane padding must stay exactly zero"


def test_slab_dequant_combine_matches_pallas_and_checks_segments():
    """At the kernel's own interface (K = 3, 5 blocks, 4 segments): 1e-5;
    a segment id out of range raises before anything runs."""
    rng = np.random.default_rng(7)
    Kk, nb, n_segs = 3, 5, 4
    A = rng.dirichlet(np.ones(Kk), size=(nb, Kk)).swapaxes(1, 2).astype(np.float32)
    s = rng.uniform(0.001, 0.02, size=(Kk, n_segs)).astype(np.float32)
    seg = np.sort(rng.integers(0, n_segs, nb * 128)).astype(np.int32)
    q = rng.integers(-127, 128, size=(Kk, nb * 128)).astype(np.int8)
    want = np.asarray(ref_ops.slab_dequant_combine(jnp.asarray(A), jnp.asarray(s), jnp.asarray(seg.reshape(nb, 128)),
                                                   jnp.asarray(q), interpret=True))
    got = ops.slab_dequant_combine(_t(A), _t(s), _t(seg.reshape(nb, 128)), _t(q))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    bad = seg.copy()
    bad[7] = n_segs
    with pytest.raises(ValueError, match="segments"):
        ops.slab_dequant_combine(_t(A), _t(s), _t(bad), _t(q))


def test_layout_combine_unpack_and_scale_by_layer_match_reference():
    tree, ref_layout, port_K, layout, A = _slab_setup()
    regions = ref_layout.pack_regions(jax.tree.map(jnp.asarray, tree))
    want = ref_layout.combine_unpack(jnp.asarray(A), regions, like=jax.tree.map(jnp.asarray, tree))
    got = layout.combine_unpack(_t(A), layout.split(layout.pack(port_K)), like=port_K)
    for (p, a), (_, b) in zip(tree_items(got), tree_items(jax.tree.map(np.asarray, want))):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5, err_msg=str(p))
    w = np.random.default_rng(1).uniform(size=(K, layout.num_layers)).astype(np.float32)
    want_r = ref_layout.scale_by_layer(jnp.asarray(w), regions)
    got_r = layout.scale_by_layer(_t(w), layout.split(layout.pack(port_K)))
    for a, b in zip(got_r, want_r):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ops_exposes_every_reference_wrapper():
    """Every public wrapper of ``repro.kernels.ops`` has its namesake here,
    bar the TPU-only knobs; each is this port's wrapper, not a plain
    version, and the ``ref`` module holds the four oracles."""
    tpu_only = {"default_interpret"}
    names = {n for n in dir(ref_ops) if not n.startswith("_") and callable(getattr(ref_ops, n))}
    names -= {"annotations"} | tpu_only
    assert names <= set(ops.__all__), names - set(ops.__all__)
    for n in names:
        assert hasattr(getattr(ops, n), "launches") or n == "slab_cast_combine", n
    for n in ("combine_ref", "int8_quantize_ref", "int8_dequantize_ref", "dequant_combine_ref"):
        assert callable(getattr(ops.ref, n))
    assert ops.weighted_combine is combine_mod.weighted_combine
    assert ops.int8_quantize is quantize_mod.int8_quantize
    assert ops.slab_dequant_combine is slab_combine_mod.slab_dequant_combine


def test_slab_cast_combine_is_the_cast_coded_round():
    rng = np.random.default_rng(2)
    slab = _t(rng.normal(size=(K, 3 * 128)).astype(np.float32))
    bl = torch.tensor([0, 0, 1], dtype=torch.int32)
    mix = _t(np.full((K, K), 0.25, np.float32))
    kw = dict(algorithm="classical", num_layers=2)
    out, A = ops.slab_cast_combine(bl, slab, mix, dtype="f16", **kw)
    out2, A2 = ops.slab_encode_combine(bl, slab, (), mix, mode="f16", **kw)
    assert torch.equal(out, out2) and torch.equal(A, A2)
    with pytest.raises(ValueError, match="dtype"):
        ops.slab_cast_combine(bl, slab, mix, dtype="int8", **kw)


def test_wrappers_refuse_other_devices_and_shapes():
    meta = torch.empty(3, 4, device="meta")
    with pytest.raises(ValueError):
        ops.weighted_combine(torch.ones(3, device="meta"), meta)
    with pytest.raises(ValueError):
        ops.int8_dequantize(meta.to(torch.int8), 1.0)
    with pytest.raises(ValueError):
        ops.weighted_combine(torch.ones(2), torch.ones(3, 4))
    with pytest.raises(ValueError):
        ops.int8_quantize(torch.ones(3, 4), torch.ones(4, 3))
    with pytest.raises(ValueError):
        ops.dequant_combine(torch.ones(3), torch.ones(2), torch.ones(3, 4, dtype=torch.int8))
    before = (ops.weighted_combine.launches, ops.int8_quantize.launches, ops.int8_dequantize.launches,
              ops.dequant_combine.launches, ops.slab_dequant_combine.launches)
    ops.weighted_combine(torch.ones(2), torch.ones(2, 5))
    ops.int8_dequantize(*ops.int8_quantize(torch.ones(5), torch.zeros(5)))
    assert before == (ops.weighted_combine.launches, ops.int8_quantize.launches, ops.int8_dequantize.launches,
                      ops.dequant_combine.launches, ops.slab_dequant_combine.launches)
