"""The chunk plan and ticket workspace of a DRT round's stats launch
(``repro_torch.kernels.layer_chunks``), on the CPU: the plan is host code,
so it is checked here against the paper's width-16 ResNet-20 layout."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import layer_chunks
from repro_torch.kernels.layer_chunks import CHUNK_BLOCKS, chunk_plan, plan_chunks


def _width16_layout():
    from repro_torch.core.packing import build_slab_layout
    from repro_torch.models.resnet import init_resnet20
    from repro_torch.utils.pytree import LayerPartition

    p = init_resnet20(torch.Generator().manual_seed(0), width=16)
    return build_slab_layout(LayerPartition.build(p), p)


def _check_plan(block_layer, num_layers, chunks, layers, chunk_blocks):
    """Chunks tile every layer's blocks in order, each at most
    ``chunk_blocks`` long and within one of its layer's others."""
    bl = np.asarray(block_layer)
    assert chunks.dtype == layers.dtype == np.int32
    assert layers.shape == (num_layers, 2) and chunks.shape[1] == 4
    assert np.array_equal(chunks[:, 3], np.zeros(len(chunks)))
    assert np.array_equal(chunks[:, 1], np.concatenate([[0], chunks[:-1, 2]]))  # contiguous, in order
    assert chunks[-1, 2] == bl.size
    for p, (first, count) in enumerate(layers):
        rows = chunks[first : first + count]
        assert np.all(rows[:, 0] == p)
        n = int((bl == p).sum())
        assert count == -(-n // chunk_blocks)
        if count:
            sizes = rows[:, 2] - rows[:, 1]
            assert sizes.sum() == n and sizes.max() <= chunk_blocks and sizes.max() - sizes.min() <= 1
            assert np.all(bl[rows[0, 1] : rows[-1, 2]] == p)
    assert layers[:, 1].sum() == len(chunks)


def test_plan_of_the_width16_resnet20_layout():
    """The paper's slab: 11 layer slots of [6, 39, 39, 39, 153, 153, 153,
    610, 610, 610, 4] column blocks, 245 chunks of at most 10 blocks."""
    layout = _width16_layout()
    bl, L = layout.block_layer, layout.num_layers
    assert np.bincount(bl).tolist() == [6, 39, 39, 39, 153, 153, 153, 610, 610, 610, 4]
    chunks, layers = plan_chunks(bl, L)
    _check_plan(bl, L, chunks, layers, CHUNK_BLOCKS)
    assert layers[:, 1].tolist() == [1, 4, 4, 4, 16, 16, 16, 61, 61, 61, 1]
    assert len(chunks) == 245


@pytest.mark.parametrize("sizes,chunk_blocks", [([1], 10), ([1, 610, 5], 10), ([0, 3, 0, 0, 21], 10),
                                                ([7, 7], 1), ([11, 20, 9], 4)])
def test_plan_tiles_every_layer(sizes, chunk_blocks):
    """A layer of one block and one of 610; empty layers get no chunk."""
    bl = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    chunks, layers = plan_chunks(bl, len(sizes), chunk_blocks)
    _check_plan(bl, len(sizes), chunks, layers, chunk_blocks)
    assert [int(c) for c in layers[:, 1]] == [-(-n // chunk_blocks) for n in sizes]


def test_plan_rejects_maps_the_kernels_cannot_take():
    with pytest.raises(ValueError, match="non-decreasing"):
        plan_chunks(np.array([0, 1, 0], np.int32), 2)
    with pytest.raises(ValueError, match="lie in"):
        plan_chunks(np.array([0, 2], np.int32), 2)
    with pytest.raises(ValueError, match="at least one block"):
        plan_chunks(np.zeros(0, np.int32), 2)


def test_chunk_plan_is_cached_per_map_tensor():
    """One host plan per block map tensor, made anew after it is written
    to; its tables lie on the map's device."""
    bl = torch.tensor([0, 0, 1, 1, 1], dtype=torch.int32)
    plan = chunk_plan(bl, 3)
    assert chunk_plan(bl, 3) is plan and chunk_plan(bl.clone(), 3) is not plan
    assert (plan.n_chunks, plan.n_busy) == (2, 2) and plan.chunks.device == bl.device
    assert plan.layers.tolist() == [[0, 1], [1, 1], [2, 0]]
    bl[2:] = 2
    again = chunk_plan(bl, 3)
    assert again is not plan and again.layers.tolist() == [[0, 1], [1, 0], [1, 1]]


def test_ticket_workspace_is_zeroed_and_grows_per_stream():
    dev = torch.device("cpu")
    t = layer_chunks.tickets(dev, 12345, 3)
    assert t.dtype == torch.int32 and t.numel() >= 3 and not t.any()
    assert layer_chunks.tickets(dev, 12345, 2) is t
    big = layer_chunks.tickets(dev, 12345, t.numel() + 1)
    assert big.numel() > t.numel() and not big.any()
    assert layer_chunks.tickets(dev, 54321, 2) is not big
