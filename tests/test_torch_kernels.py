"""The ``slab_combine`` kernel's module against the reference.

On the CPU the wrapper runs its plain PyTorch version; that version is held
against the JAX Pallas kernel (interpret mode, as ``tests/test_kernels.py``
runs it) and against the reference's per-group ``layout.combine``.  The CUDA
kernel itself only runs on a GPU: see ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import slab_combine as ref_slab_combine
from repro_torch.kernels.slab_combine import LANES, slab_combine

torch.set_num_threads(1)


def _inputs(K, nb, seed=0, pad_cols=0):
    rng = np.random.default_rng(seed)
    A = np.ascontiguousarray(rng.dirichlet(np.ones(K), size=(nb, K)).swapaxes(1, 2), np.float32)
    slab = rng.normal(size=(K, nb * LANES)).astype(np.float32)
    if pad_cols:
        slab.reshape(K, nb, LANES)[:, :, LANES - pad_cols :] = 0.0
    return A, slab


@pytest.mark.parametrize("K,nb", [(3, 1), (4, 5), (3, 7), (16, 3)])
def test_plain_version_matches_pallas_reference(K, nb):
    """f32 sums of K products in another order: 1e-6 absolute on O(1)
    values."""
    A, slab = _inputs(K, nb, seed=K * 10 + nb, pad_cols=5)
    ref = np.asarray(ref_slab_combine(jnp.asarray(A), jnp.asarray(slab), interpret=True))
    out = slab_combine(torch.from_numpy(A), torch.from_numpy(slab))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    # padding lanes stay exactly zero
    assert torch.all(out.view(K, nb, LANES)[:, :, LANES - 5 :] == 0)


def test_cpu_calls_do_not_count_as_launches():
    A, slab = _inputs(3, 2)
    before = slab_combine.launches
    slab_combine(torch.from_numpy(A), torch.from_numpy(slab))
    assert slab_combine.launches == before


def test_matches_reference_layout_combine_on_a_packed_model():
    """Through the real layout: gather one (K, K) matrix per block from
    ``block_layer`` and combine the packed slab; the unpacked result equals
    the reference's per-group combine, and lane padding stays zero."""
    from repro.core import packing as ref_packing
    from repro.utils.pytree import LayerPartition as RefLayerPartition
    from repro_torch import bridge
    from repro_torch.core import packing
    from repro_torch.core.consensus import combine_slab_kernels
    from repro_torch.models.resnet import init_resnet20
    from repro_torch.utils.pytree import LayerPartition, agent_template, tree_items

    K = 4
    rng = np.random.default_rng(3)
    p0 = bridge.params_to_jax(init_resnet20(torch.Generator().manual_seed(1), width=4))
    ref_K = jax.tree.map(lambda x: x[None] + 0.1 * rng.normal(size=(K, *x.shape)).astype(np.float32), p0)
    port_K = bridge.params_from_jax(ref_K, device="cpu")
    t = agent_template(port_K)
    layout = packing.build_slab_layout(LayerPartition.build(t), t)
    ref_t = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), ref_K)
    ref_layout = ref_packing.build_slab_layout(RefLayerPartition.build(ref_t), ref_t)
    A = rng.dirichlet(np.ones(K), size=(layout.num_layers, K)).swapaxes(1, 2).astype(np.float32)

    slab = layout.pack(port_K)
    out = combine_slab_kernels(layout, torch.from_numpy(A), slab)
    for (s, e), size in zip(layout.layer_slices, layout.layer_sizes):
        assert torch.all(out[:, s + size : e] == 0)
    got = bridge.params_to_jax(layout.unpack(out, like=port_K))
    want = jax.jit(
        lambda a, tr: ref_layout.unpack_regions(ref_layout.combine(a, ref_layout.pack_regions(tr)), like=tr)
    )(A, ref_K)
    for (pa, a), (pb, b) in zip(tree_items(got), tree_items(jax.tree.map(np.asarray, want))):
        assert pa == pb
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    A, slab = _inputs(3, 2)
    A, slab = torch.from_numpy(A), torch.from_numpy(slab)
    with pytest.raises(ValueError, match="blocks"):
        slab_combine(A, slab[:, :-LANES])
    with pytest.raises(ValueError):
        slab_combine(A[:, :2], slab)
    with pytest.raises(ValueError):
        slab_combine(A[0], slab)
    with pytest.raises(ValueError):
        slab_combine(A, torch.zeros(3, 2 * LANES, device="meta"))
