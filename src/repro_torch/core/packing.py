"""Flat-slab parameter representation for the consensus hot path.

Counterpart of the exact (no-codec) parts of ``repro.core.packing``.  An
agent-stacked parameter tree is packed ONCE per round-set into a contiguous
``(K, D)`` slab with a static per-DRT-layer segment layout; the per-layer
Gram matrices and the weighted combine run on it, and the tree is unpacked
once after the last round.

Layout (identical ``D``, ``layer_slices`` and ``block_layer`` to the
reference for the same template):

* plain group   -- all leaves flattened and concatenated, padded up to a lane
  multiple (128): ONE layer segment.
* stacked group -- per slot ``j``, the slot-``j`` slice of every leaf
  concatenated and padded to the lane multiple; slot segments are
  contiguous, so a group's columns view as ``(K, n_slots, s_pad)``.

Leaves sit in sorted-key order inside a segment, as in the reference.  The
element order INSIDE a leaf is torch's (a conv weight is OIHW here, HWIO
there): per-layer Grams and combines do not depend on it.

Padding columns are zero, and every operation here is linear in the slab
or reduces over whole layer segments, so they stay exactly zero.

Regions are the round-loop form: one ``(n_slots, K, s_pad)`` view per
group.  ``split`` returns views into the slab (no copy), so packing writes
the slab once and the Gram reads it in place.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.utils.pytree import LayerPartition, Tree, tree_items

LANES = 128  # layer segments are padded to a multiple of this many columns
F32 = torch.float32


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Placement of one template leaf inside its group's slot segment."""

    path: tuple  # key path below the group key
    shape: tuple[int, ...]  # single-agent leaf shape (includes the slot axis)
    dtype: torch.dtype
    col0: int  # start column within the slot segment
    width: int  # per-slot width (stacked group) or full width (plain)


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    key: str
    stacked: bool
    n_slots: int
    layer0: int  # first DRT layer index
    col0: int  # slab column where the group starts
    s: int  # unpadded per-slot width
    s_pad: int  # lane-padded per-slot width
    leaves: tuple[LeafPlan, ...]

    @property
    def width(self) -> int:
        return self.n_slots * self.s_pad


@dataclasses.dataclass(frozen=True, eq=False)
class SlabLayout:
    """Static packing plan: tree <-> ``(K, D)`` slab with layer segments."""

    groups: tuple[GroupPlan, ...]
    num_layers: int
    D: int
    layer_slices: tuple[tuple[int, int], ...]  # (start, stop) per DRT layer
    layer_sizes: tuple[int, ...]  # unpadded width per DRT layer
    lane: int = LANES

    @property
    def n_blocks(self) -> int:
        return self.D // self.lane

    @functools.cached_property
    def block_layer(self) -> np.ndarray:
        """(D // lane,) int32: the DRT layer owning each lane-wide column
        block.  Segments are lane-padded, so a block never straddles two
        layers; the combine kernel takes one (K, K) matrix per block."""
        out = np.empty(self.n_blocks, np.int32)
        for p, (s, e) in enumerate(self.layer_slices):
            out[s // self.lane : e // self.lane] = p
        return out

    def block_layer_on(self, device: torch.device) -> torch.Tensor:
        """``block_layer`` as an int64 index tensor on ``device`` (cached)."""
        cache = self.__dict__.setdefault("_block_layer_t", {})
        t = cache.get(device)
        if t is None:
            t = cache[device] = torch.as_tensor(
                self.block_layer, dtype=torch.int64, device=device
            )
        return t

    # -- tree <-> slab --------------------------------------------------------

    def pack(self, tree: Tree) -> torch.Tensor:
        """Pack an agent-stacked tree (leading K on every leaf) into a new
        contiguous ``(K, D)`` f32 slab with zero lane padding."""
        slab = None
        for grp in self.groups:
            for plan, leaf in zip(grp.leaves, _group_leaves(tree[grp.key])):
                if tuple(leaf.shape[1:]) != plan.shape:
                    raise ValueError(
                        f"leaf {grp.key!r}{list(plan.path)} has shape "
                        f"{tuple(leaf.shape)}; layout expects (K, *{plan.shape})"
                    )
                if slab is None:
                    slab = torch.zeros(
                        leaf.shape[0], self.D, dtype=F32, device=leaf.device
                    )
                view = self.group_view(slab, grp)
                n = grp.n_slots if grp.stacked else 1
                view[:, :, plan.col0 : plan.col0 + plan.width] = leaf.reshape(
                    leaf.shape[0], n, plan.width
                )
        return slab

    def unpack(self, slab: torch.Tensor, like: Tree) -> Tree:
        """Inverse of :meth:`pack` (see :meth:`unpack_regions`)."""
        return self.unpack_regions(self.split(slab), like)

    def unpack_regions(self, regions: tuple, like: Tree) -> Tree:
        """Slot-major regions (views or contiguous) -> a tree of contiguous
        leaves in ``like``'s dtypes, copied out of the regions; ``like``
        supplies the structure (its values are ignored)."""
        K = regions[0].shape[1]
        out = dict(like)
        for grp, region in zip(self.groups, regions):
            leaves = {}
            for plan in grp.leaves:
                piece = region[:, :, plan.col0 : plan.col0 + plan.width].transpose(0, 1)
                leaves[plan.path] = piece.reshape(K, *plan.shape).to(plan.dtype).contiguous()
            out[grp.key] = _rebuild(like[grp.key], leaves)
        return {k: out[k] for k in sorted(out)}

    def group_view(self, slab: torch.Tensor, grp: GroupPlan) -> torch.Tensor:
        """A group's columns of a ``(K, D)`` slab as a ``(K, n_slots, s_pad)``
        view (no copy)."""
        return slab[:, grp.col0 : grp.col0 + grp.width].view(
            slab.shape[0], grp.n_slots, grp.s_pad
        )

    def split(self, slab: torch.Tensor) -> tuple:
        """``(K, D)`` slab -> slot-major ``(n_slots, K, s_pad)`` region views."""
        return tuple(self.group_view(slab, g).transpose(0, 1) for g in self.groups)

    def join(self, regions: tuple) -> torch.Tensor:
        """Slot-major regions -> a new contiguous ``(K, D)`` slab."""
        return torch.cat(
            [r.transpose(0, 1).reshape(r.shape[1], g.width) for g, r in zip(self.groups, regions)],
            dim=1,
        )

    def pack_regions(self, tree: Tree) -> tuple:
        return self.split(self.pack(tree))

    # -- per-layer algebra ----------------------------------------------------

    def gram(self, regions: tuple) -> torch.Tensor:
        """Per-layer agent Gram matrices ``(L, K, K)`` f32: one batched matmul
        per group."""
        return torch.cat([torch.bmm(r, r.transpose(1, 2)) for r in regions], dim=0)

    def combine(self, A: torch.Tensor, regions: tuple) -> tuple:
        """Per-layer mixing ``new[p, k, c] = sum_l A[p, l, k] region[p, l, c]``
        with one batched matmul per group; new contiguous regions."""
        out = []
        for grp, region in zip(self.groups, regions):
            A_g = A[grp.layer0 : grp.layer0 + grp.n_slots].float()
            out.append(torch.bmm(A_g.transpose(1, 2), region))
        return tuple(out)


def _group_leaves(sub: Tree) -> list:
    return [leaf for _, leaf in tree_items(sub)]


def _rebuild(like: Tree, leaves: dict, prefix: tuple = ()) -> Tree:
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves, prefix + (k,)) for k in sorted(like)}
    return leaves[prefix]


def gram_sq_dists(gram: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``d2[p,l,k] = n2[p,l] + n2[p,k] - 2 gram[p,l,k]`` (clamped at 0) and
    ``n2`` from per-layer Gram matrices."""
    n2 = torch.diagonal(gram, dim1=1, dim2=2)
    d2 = n2[:, :, None] + n2[:, None, :] - 2.0 * gram
    return torch.clamp(d2, min=0.0), n2


def gram_update(gram: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Exact Gram recurrence of one combine round: ``psi' = A^T psi`` per
    layer implies ``G' = A^T G A``."""
    A = A.float()
    return torch.einsum("pia,pij,pjb->pab", A, gram, A)


def gram_disagreement(gram: torch.Tensor) -> torch.Tensor:
    """Network disagreement ``mean_k ||x_k - x_bar||^2`` (summed over
    layers) read off per-layer Gram matrices: per layer ``mean_k G[kk] -
    mean_{kl} G[kl]``."""
    diag = torch.diagonal(gram, dim1=1, dim2=2)
    return (diag.mean(-1) - gram.mean(dim=(-2, -1))).sum()


def build_slab_layout(
    partition: LayerPartition, template: Tree, lane: int = LANES
) -> SlabLayout:
    """The static packing plan for ``template`` (a single-agent tree of
    tensors, meta tensors included) under ``partition``'s layer assignment.
    The slab is f32; every leaf must be floating point."""
    if not isinstance(template, dict):
        raise TypeError("template must be a top-level dict")
    groups: list[GroupPlan] = []
    layer_slices: list[tuple[int, int]] = []
    layer_sizes: list[int] = []
    col = 0
    for g in partition.groups:
        plans = []
        s = 0
        for path, leaf in tree_items(template[g.key]):
            if not leaf.dtype.is_floating_point:
                raise ValueError(
                    f"leaf {g.key!r}{list(path)} has dtype {leaf.dtype}; the slab "
                    "path packs floating-point parameters only"
                )
            shape = tuple(int(d) for d in leaf.shape)
            width = int(np.prod(shape[1:] if g.stacked else shape, dtype=np.int64))
            plans.append(LeafPlan(path, shape, leaf.dtype, s, width))
            s += width
        s_pad = _round_up(s, lane)
        grp = GroupPlan(g.key, g.stacked, g.n_slots, g.offset, col, s, s_pad, tuple(plans))
        groups.append(grp)
        for j in range(g.n_slots):
            layer_slices.append((col + j * s_pad, col + (j + 1) * s_pad))
            layer_sizes.append(s)
        col += grp.width
    if not groups:
        raise ValueError("template has no leaves to pack")
    return SlabLayout(
        groups=tuple(groups),
        num_layers=partition.num_layers,
        D=col,
        layer_slices=tuple(layer_slices),
        layer_sizes=tuple(layer_sizes),
        lane=lane,
    )
