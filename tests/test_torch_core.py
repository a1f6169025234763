"""Port parity, numpy/geometry layer: topologies, DRT weights, data, packing.

Each test feeds the same seeded numpy inputs to the JAX reference
(``repro``) and to the PyTorch port (``repro_torch``, on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import diffusion as ref_diffusion
from repro.core import drt as ref_drt
from repro.core import packing as ref_packing
from repro.core import topology as ref_topology
from repro.data import cifar_like as ref_data
from repro.models.resnet import init_resnet20 as ref_init_resnet20
from repro.utils.pytree import LayerPartition as RefLayerPartition
from repro_torch import bridge
from repro_torch.core import diffusion, drt, packing, topology
from repro_torch.data import cifar_like
from repro_torch.models.resnet import init_resnet20
from repro_torch.utils.pytree import LayerPartition, agent_template

torch.set_num_threads(1)


def _topologies(mod, K=16):
    return {
        "ring": mod.make_topology("ring", K),
        "erdos_renyi": mod.make_topology("erdos_renyi", K, p=0.1, seed=mod.PAPER_ER_SEED),
        "hypercube": mod.make_topology("hypercube", K),
    }


@pytest.mark.parametrize("name", ["ring", "erdos_renyi", "hypercube"])
def test_topology_matrices_bit_identical(name):
    ref, port = _topologies(ref_topology)[name], _topologies(topology)[name]
    np.testing.assert_array_equal(port.adjacency, ref.adjacency)
    np.testing.assert_array_equal(port.c_matrix(), ref.c_matrix())
    np.testing.assert_array_equal(port.metropolis(), ref.metropolis())
    assert port.lambda2() == ref.lambda2()
    assert port.name == ref.name
    np.testing.assert_array_equal(
        diffusion.classical_mixing_matrices(port, 11).numpy(),
        np.asarray(ref_diffusion.classical_mixing_matrices(ref, 11)),
    )


def _d2_n2(rng, L, K):
    """Random but geometrically consistent distances: from points."""
    x = rng.normal(size=(L, K, 6)).astype(np.float32)
    x += rng.normal(size=(L, 1, 6)).astype(np.float32) * 3.0
    n2 = np.sum(x * x, -1)
    d2 = np.sum((x[:, :, None] - x[:, None]) ** 2, -1)
    return d2.astype(np.float32), n2.astype(np.float32)


@pytest.mark.parametrize("mode", ["paper", "exact_grad"])
@pytest.mark.parametrize("name", ["ring", "erdos_renyi", "hypercube"])
def test_drt_mixing_matrices_match(name, mode):
    """Eqs. 12-14 in log space: same f32 formulas, so agreement to ~1e-6
    (exp/log1p rounding differs by an ulp or two between backends)."""
    topo = _topologies(topology)[name]
    d2, n2 = _d2_n2(np.random.default_rng(7), 5, 16)
    C = topo.c_matrix().astype(np.float32)
    cfg_ref = ref_drt.DRTConfig(weight_mode=mode)
    cfg = drt.DRTConfig(weight_mode=mode)
    A_ref = np.asarray(
        jax.jit(ref_drt.drt_mixing_matrices, static_argnums=3)(d2, n2, C, cfg_ref)
    )
    A = drt.drt_mixing_matrices(torch.from_numpy(d2), torch.from_numpy(n2), C, cfg).numpy()
    np.testing.assert_allclose(A, A_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(A.sum(1), 1.0, atol=1e-5)
    assert np.all((A > 0) == (C[None] > 0))


def test_cifar_like_shards_and_minibatches_bit_identical():
    cfg_kw = dict(image_size=8, noise=0.1, max_shift=1)
    ref = ref_data.CifarLike(ref_data.CifarLikeConfig(**cfg_kw))
    port = cifar_like.CifarLike(cifar_like.CifarLikeConfig(**cfg_kw))
    np.testing.assert_array_equal(port.prototypes, ref.prototypes)
    kw = dict(num_agents=4, min_samples=20, max_samples=30, seed=1)
    s_ref, s_port = ref.paper_partition(**kw), port.paper_partition(**kw)
    for (xr, yr), (xp, yp) in zip(s_ref, s_port):
        np.testing.assert_array_equal(xp, xr)
        np.testing.assert_array_equal(yp, yr)
    b_ref = ref_data.agent_minibatches(s_ref, batch_size=8, epoch_seed=3)
    b_port = cifar_like.agent_minibatches(s_port, batch_size=8, epoch_seed=3)
    for k in ("images", "labels"):
        np.testing.assert_array_equal(b_port[k], b_ref[k])
        assert b_port[k].dtype == b_ref[k].dtype
    np.testing.assert_array_equal(port.test_set(16)[0], ref.test_set(16)[0])


def _ref_shapes(width):
    shapes = jax.eval_shape(lambda k: ref_init_resnet20(k, width=width), jax.random.key(0))
    return jax.tree.map(lambda s: s.shape, shapes)


def _resnet_pair(K=3, width=4, seed=0):
    """Agent-stacked ResNet-20 trees (reference HWIO, port OIHW) holding the
    same weights: one port init carried to the reference layout, plus
    seeded per-agent noise.  (A jax.random init would cost seconds of
    op-by-op compiles; its shapes are checked against the carried tree.)"""
    p0 = bridge.params_to_jax(init_resnet20(torch.Generator().manual_seed(seed), width=width))
    assert jax.tree.map(np.shape, p0) == _ref_shapes(width)
    rng = np.random.default_rng(seed)
    ref_K = jax.tree.map(
        lambda x: x[None] + 0.05 * rng.normal(size=(K, *x.shape)).astype(np.float32), p0
    )
    return ref_K, bridge.params_from_jax(ref_K, device="cpu")


def _layouts(ref_K, port_K):
    ref_t = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), ref_K)
    ref_layout = ref_packing.build_slab_layout(RefLayerPartition.build(ref_t), ref_t)
    t = agent_template(port_K)
    return ref_layout, packing.build_slab_layout(LayerPartition.build(t), t)


def test_partition_and_layout_match_reference():
    ref_K, port_K = _resnet_pair()
    ref_l, port_l = _layouts(ref_K, port_K)
    t = agent_template(port_K)
    part = LayerPartition.build(t)
    assert [g.key for g in part.groups] == [
        "head", "stage1_blocks", "stage2_blocks", "stage3_blocks", "stem"
    ]
    assert part.num_layers == 11
    assert port_l.D == ref_l.D
    assert port_l.layer_slices == ref_l.layer_slices
    assert port_l.layer_sizes == ref_l.layer_sizes
    np.testing.assert_array_equal(port_l.block_layer, ref_l.block_layer)


def test_width16_layout_is_the_papers():
    """The main path's sizes: L=11, 308,890 parameters, D=309,248."""
    t = agent_template(bridge.params_from_jax(
        jax.tree.map(lambda s: np.zeros((1, *s), np.float32), _ref_shapes(16),
                     is_leaf=lambda x: isinstance(x, tuple)),
        device="cpu",
    ))
    layout = packing.build_slab_layout(LayerPartition.build(t), t)
    assert layout.num_layers == 11
    assert sum(layout.layer_sizes) == 308_890
    assert layout.D == 309_248 and layout.n_blocks == 2_416


def test_pack_unpack_roundtrip_and_zero_padding():
    ref_K, port_K = _resnet_pair()
    _, layout = _layouts(ref_K, port_K)
    slab = layout.pack(port_K)
    assert slab.shape == (3, layout.D)
    for (s, e), size in zip(layout.layer_slices, layout.layer_sizes):
        assert torch.all(slab[:, s + size : e] == 0)
    back = layout.unpack(slab, like=port_K)
    for (pa, a), (pb, b) in zip(_items(back), _items(port_K)):
        assert pa == pb
        assert torch.equal(a, b)
    regions = layout.split(slab)
    assert torch.equal(layout.join(regions), slab)
    assert torch.equal(layout.pack_regions(port_K)[1], regions[1])


def _items(tree):
    from repro_torch.utils.pytree import tree_items

    return list(tree_items(tree))


def test_gram_update_and_disagreement_match_reference():
    """Per-layer Grams are sums over ~1e3-1e4 f32 products in different
    orders (and a different element order inside conv leaves): 1e-5
    relative.  The disagreement is a difference of Gram means, so its
    error scales with the Gram's magnitude, not its own."""
    ref_K, port_K = _resnet_pair()
    ref_l, port_l = _layouts(ref_K, port_K)
    G_ref = np.array(jax.jit(lambda t: ref_l.gram(ref_l.pack_regions(t)))(ref_K))
    G = port_l.gram(port_l.pack_regions(port_K))
    np.testing.assert_allclose(G.numpy(), G_ref, rtol=1e-5, atol=1e-5)
    d2_ref, n2_ref = ref_packing.gram_sq_dists(jnp.asarray(G_ref))
    d2, n2 = packing.gram_sq_dists(torch.from_numpy(G_ref))
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(n2.numpy(), np.asarray(n2_ref))
    A = np.random.default_rng(1).dirichlet(np.ones(3), size=(11, 3)).swapaxes(1, 2).astype(np.float32)
    G2_ref = np.array(ref_packing.gram_update(jnp.asarray(G_ref), jnp.asarray(A)))
    G2 = packing.gram_update(torch.from_numpy(G_ref), torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(G2, G2_ref, rtol=1e-5, atol=1e-4)
    dis_ref = float(ref_packing.gram_disagreement(jnp.asarray(G2_ref)))
    dis = float(packing.gram_disagreement(torch.from_numpy(G2_ref)))
    assert abs(dis - dis_ref) <= 1e-6 * float(np.abs(G2_ref).sum())


def test_layout_combine_matches_reference():
    ref_K, port_K = _resnet_pair()
    ref_l, port_l = _layouts(ref_K, port_K)
    A = np.random.default_rng(2).dirichlet(np.ones(3), size=(11, 3)).swapaxes(1, 2).astype(np.float32)
    out_ref = jax.jit(
        lambda a, t: ref_l.unpack_regions(ref_l.combine(a, ref_l.pack_regions(t)), like=t)
    )(A, ref_K)
    out = port_l.unpack_regions(port_l.combine(torch.from_numpy(A), port_l.pack_regions(port_K)), port_K)
    got = bridge.params_to_jax(out)
    for (pa, a), (pb, b) in zip(_items(got), _items(jax.tree.map(np.asarray, out_ref))):
        assert pa == pb
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
