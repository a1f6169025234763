"""The LM kernels' plain versions against the reference's Pallas kernels.

``repro_torch.kernels.flash_attention`` and ``repro_torch.kernels.selective_scan``
take their plain PyTorch versions on CPU tensors; here they are held against
the Pallas TPU kernels run in interpret mode (as the reference's own tests
run them on the CPU) and against the reference models' jnp functions, on the
same inputs made from a seed with numpy.  Everything is f32, so the
tolerances are f32 ones: 1e-5 relative, 1e-6 absolute (the sums of one dot
product or one scan step in another order).  The CUDA kernels themselves are
held against these plain versions on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro.kernels.selective_scan import selective_scan as pallas_selective_scan
from repro.models import layers as ref_layers
from repro.models.ssm import selective_scan_chunked
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import selective_scan as ss
from repro_torch.models import layers

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _qkv(B, H, Hkv, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, S, hd)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, hd)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("S", [40, 48])
def test_flash_attention_plain_matches_pallas_kernel(S):
    """B 1, H 4 over Hkv 2, hd 32, causal, 16-row tiles on the Pallas side:
    S 40 (not a tile multiple: the Pallas kernel pads, the port masks by
    bounds) and S 48 (three whole tiles).  The Pallas kernel gets k and v
    GQA-expanded; the port reads KV head h // 2 in place."""
    q, k, v = _qkv(1, 4, 2, S, 32)
    expand = lambda t: np.repeat(t, 2, axis=1)  # noqa: E731  (head j -> KV head j // 2)
    want = pallas_flash_attention(jnp.asarray(q), jnp.asarray(expand(k)), jnp.asarray(expand(v)),
                                  causal=True, interpret=True, blk_q=16, blk_k=16)
    before = fa.flash_attention.launches
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert fa.flash_attention.launches == before  # a CPU tensor takes the plain version
    assert got.shape == (1, 4, S, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_flash_attention_layer_matches_reference_layer():
    """The model-level function in (B, S, H, hd) layout against the
    reference's jnp ``layers.flash_attention`` with Hkv 2 (its own GQA
    expansion, 16-key chunks: several tiles and a ragged last one)."""
    q, k, v = (np.ascontiguousarray(t.transpose(0, 2, 1, 3)) for t in _qkv(2, 4, 2, 37, 32, seed=1))
    want = ref_layers.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, kv_chunk=16)
    got = layers.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert got.shape == (2, 37, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _scan_inputs(B, S, di, ds, seed=0):
    """Mamba-like operands: softplus'd dt, S4D-real A = -(1..ds)."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(-1.0, 1.0, size=(B, S, di)))).astype(np.float32)
    A = -np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32), (di, ds)).copy()
    Bm = rng.normal(size=(B, S, ds)).astype(np.float32)
    Cm = rng.normal(size=(B, S, ds)).astype(np.float32)
    x = rng.normal(size=(B, S, di)).astype(np.float32)
    return dt, A, Bm, Cm, x


def test_selective_scan_plain_matches_pallas_kernel_and_chunked_state():
    """B 2, S 37 (not a chunk multiple), di 16, ds 4, chunk 16: y against the
    Pallas kernel; h_last (which the Pallas kernel does not return) against
    the reference model's ``selective_scan_chunked``."""
    ops = _scan_inputs(2, 37, 16, 4)
    jops = [jnp.asarray(t) for t in ops]
    want_y = pallas_selective_scan(*jops, interpret=True, chunk=16)
    chunk_y, want_h = jax.jit(selective_scan_chunked, static_argnames="chunk")(*jops, chunk=16)
    before = ss.selective_scan.launches
    y, h_last = ss.selective_scan(*(torch.from_numpy(t) for t in ops))
    assert ss.selective_scan.launches == before
    assert y.shape == (2, 37, 16) and h_last.shape == (2, 16, 4)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(chunk_y), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(want_h), rtol=RTOL, atol=ATOL)


def test_lm_kernel_wrappers_check_their_operands():
    q = torch.zeros(1, 4, 8, 32)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, torch.zeros(1, 3, 8, 32), torch.zeros(1, 3, 8, 32))
    with pytest.raises(TypeError):
        fa.flash_attention(q, torch.zeros(1, 2, 8, 32).double(), torch.zeros(1, 2, 8, 32).double())
    with pytest.raises(NotImplementedError, match="ROADMAP"):  # only the causal form is ported
        fa.flash_attention(q, torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 8, 32), causal=False)
    dt, A, Bm, Cm, x = (torch.from_numpy(t) for t in _scan_inputs(1, 5, 8, 4))
    with pytest.raises(ValueError, match="must be"):
        ss.selective_scan(dt, A, Bm[..., :3], Cm, x)
    with pytest.raises(TypeError):
        ss.selective_scan(dt.double(), A, Bm, Cm, x)
