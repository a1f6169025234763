"""The tensor-map arguments that the port's TMA kernels are launched with
(``repro_torch.kernels.tma``): dims, byte strides and boxes for the bf16
``flash_attention`` kernel's q, k and v views and for ``slab_combine``'s slab,
``A_blocks`` and output, and the refusals of what TMA does not take (a base address
off a 16-byte boundary, a byte stride that is not a multiple of 16, a
non-unit innermost stride, a box out of range).  CPU tensors only: the
helper reads shapes, strides and addresses, and launches nothing."""
import ctypes

import pytest
import torch

from repro_torch.kernels import tma
from repro_torch.kernels.flash_attention import TC_BLOCK_K, TC_BLOCK_Q, attention_tensor_maps
from repro_torch.kernels.slab_combine import LANES, slab_combine_tensor_maps


def _model_layout(B, S, H, hd, dtype=torch.bfloat16):
    """A (B, S, H, hd) projection seen as (B, H, S, hd), as the LM hands it over."""
    return torch.zeros(B, S, H, hd, dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_attention_maps_follow_the_model_layout(hd):
    B, S, H, Hkv = 2, 300, 8, 2
    q, k, v = _model_layout(B, S, H, hd), _model_layout(B, S, Hkv, hd), _model_layout(B, S, Hkv, hd)
    box_d = min(hd, 64)  # one 128-byte swizzle row (64 bytes for hd 32)
    mq, mk, mv = attention_tensor_maps(q, k, v)
    assert mq == tma.TensorMapArgs(q.data_ptr(), (hd, S, H, B), (2 * H * hd, 2 * hd, 2 * S * H * hd),
                                   (box_d, TC_BLOCK_Q, 1, 1))
    for m, t in ((mk, k), (mv, v)):
        assert m == tma.TensorMapArgs(t.data_ptr(), (hd, S, Hkv, B), (2 * Hkv * hd, 2 * hd, 2 * S * Hkv * hd),
                                      (box_d, TC_BLOCK_K, 1, 1))


def test_attention_maps_of_contiguous_heads_and_size_one_dims():
    """(B, H, S, hd) contiguous works as well; a dimension of extent 1 is
    never stepped over, so its stride is not checked and goes as 16."""
    q = torch.zeros(1, 1, 5, 64, dtype=torch.bfloat16)
    (m, _, _) = attention_tensor_maps(q, q, q)
    assert m.dims == (64, 5, 1, 1) and m.strides == (128, 16, 16)


@pytest.mark.parametrize("K", [3, 4, 5, 16, 64])
def test_slab_maps(K):
    nb = 7
    A = torch.zeros(nb, K, K)
    slab, out = torch.zeros(K, nb * LANES), torch.zeros(K, nb * LANES)
    m_slab, m_a, m_out = slab_combine_tensor_maps(A, slab, out)
    for m, t in ((m_slab, slab), (m_out, out)):
        assert m == tma.TensorMapArgs(t.data_ptr(), (nb * LANES, K), (4 * nb * LANES,), (LANES, K))
    # one block's K^2 floats from the 16-byte boundary at or below them
    span = K * K + (3 if K % 4 else 0)
    a_box = min(256, -(-span // 4) * 4)
    assert m_a == tma.TensorMapArgs(A.data_ptr(), (nb * K * K,), (), (a_box,))
    assert a_box % 4 == 0 and -(-span // a_box) * a_box >= span


def test_pack_lays_out_sixteen_words():
    args = tma.TensorMapArgs(0, (64, 300, 8, 2), (2048, 128, 614400), (64, 128, 1, 1))
    words = tma.pack(args)
    assert isinstance(words, ctypes.Array) and len(words) == tma.PACKED_WORDS
    assert list(words) == [4, 64, 300, 8, 2, 0, 2048, 128, 614400, 0, 64, 128, 1, 1, 0, 0]
    assert list(tma.pack(tma.TensorMapArgs(0, (27,), (), (12,)))) == [1, 27] + [0] * 8 + [12] + [0] * 5


def test_refuses_a_base_off_a_16_byte_boundary():
    store = torch.zeros(4 * 128 + 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tma.tensor_map_args(store[1:513].view(4, 128), (1, 0), (128, 4))
    A = torch.zeros(3 * 9 + 1)[1:].view(3, 3, 3)
    with pytest.raises(ValueError, match="16-byte aligned"):
        slab_combine_tensor_maps(A, torch.zeros(3, 3 * LANES), torch.zeros(3, 3 * LANES))
    q = torch.zeros(1, 16, 4, 64, dtype=torch.bfloat16)
    q_off = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(1, 16, 4, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention_tensor_maps(q_off, q.transpose(1, 2), q.transpose(1, 2))
    # a view 16 bytes in is taken as it is
    assert tma.tensor_map_args(store[4:516].view(4, 128), (1, 0), (128, 4)).dims == (128, 4)


def test_refuses_byte_strides_that_are_not_multiples_of_16():
    rows = torch.zeros(1, 16, 4, 65, dtype=torch.bfloat16)[..., :64].transpose(1, 2)  # rows 130 bytes apart
    with pytest.raises(ValueError, match="multiples of 16"):
        attention_tensor_maps(rows, rows, rows)
    with pytest.raises(ValueError, match="multiples of 16"):
        tma.tensor_map_args(torch.zeros(5, 3)[:, :2], (1, 0), (4, 5))  # f32 rows 12 bytes apart


def test_refuses_a_strided_innermost_axis_and_boxes_out_of_range():
    x = torch.zeros(8, 256)
    with pytest.raises(ValueError, match="unit stride"):
        tma.tensor_map_args(x[:, ::2], (1, 0), (64, 8))
    with pytest.raises(ValueError, match="1..256"):
        tma.tensor_map_args(x, (1, 0), (512, 8))
    with pytest.raises(ValueError, match="1..256"):
        tma.tensor_map_args(x, (1, 0), (64, 0))
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        tma.tensor_map_args(x, (1, 0), (6, 8))  # a 24-byte box row
    with pytest.raises(ValueError, match="each of the tensor's"):
        tma.tensor_map_args(x, (1, 1), (64, 8))
    with pytest.raises(ValueError, match="one box extent each"):
        tma.tensor_map_args(x, (1, 0), (64,))
