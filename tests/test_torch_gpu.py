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
