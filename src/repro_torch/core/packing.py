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
or reduces over whole layer segments, so they stay exactly zero.  A Gauss
or constant attack (``repro_torch.faults``) writes the published slab's
padding too, as the reference's regions; the exact and cast exchanges then
carry it into the Gram and the combine, as the reference does.

Regions are the round-loop form: one ``(n_slots, K, s_pad)`` view per
group.  ``split`` returns views into the slab (no copy), so packing writes
the slab once and the Gram reads it in place.

Coded exchange (counterpart of the reference's codec fast paths): the
layout also carries the int8 scale segments (per (leaf, slot) in groups
whose key ends in ``blocks``, per leaf otherwise) and two static per-column
maps for the counter RNG, ``col_leaf`` (the column's leaf in full-tree
flatten order) and ``col_idx`` (the element's row-major index in the
REFERENCE layout of its leaf, via ``repro_torch.utils.pytree.reference_index``),
so the int8 wire equals the reference's bit for bit although conv weights
sit here in OIHW order.  The top-k threshold samples the reference's
``flat[::stride]`` elements through a static per-leaf index of the port
columns that hold them.  The codec helpers here (scales, key words, the
int8 kernels' operands) take the whole ``(K, D)`` slab (the regions are
views of it); the wire encode itself, which launches the int8 kernel on a
CUDA slab, is ``repro_torch.core.consensus.slab_encode_batched``.

Sparse rounds (counterpart of the reference's edge and CSR methods): the
per-layer squared norms, per-edge distances and the scatter and
gather-only combines of ``path="edge"``, on the slab and its
``block_layer`` map.  They are the math of the edge kernels' plain
versions (``repro_torch.kernels.slab_segment``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.comm import prng
from repro_torch.comm.codec import Int8StochasticCodec, TopKCodec, topk_sample_plan
from repro_torch.kernels.combine import SegmentTable, segment_table
from repro_torch.kernels.drt_dist import SlotTable, slot_table
from repro_torch.utils.pytree import LayerPartition, Tree, reference_index, tree_items

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
    flat_idx: int  # position in the FULL tree's flatten order (rng key split)
    scale_per_slot: bool  # int8: one scale per scan slot vs one per leaf
    scale_seg0: int  # first int8 scale-segment id owned by this leaf


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
    n_tree_leaves: int  # leaf count of the full template (rng key split)
    col_scale_seg: np.ndarray  # (D,) int32: int8 scale segment per column
    n_scale_segs: int
    lane: int = LANES

    @property
    def n_blocks(self) -> int:
        return self.D // self.lane

    @functools.cached_property
    def _col_rng_maps(self) -> tuple[np.ndarray, np.ndarray]:
        leaf = np.empty(self.D, np.int32)
        idx = np.zeros(self.D, np.int32)
        for grp in self.groups:
            ref_idx = [
                reference_index(p.path, p.shape).reshape(-1, p.width) for p in grp.leaves
            ]
            for j in range(grp.n_slots):
                base = grp.col0 + j * grp.s_pad
                for plan, ri in zip(grp.leaves, ref_idx):
                    c0 = base + plan.col0
                    leaf[c0 : c0 + plan.width] = plan.flat_idx
                    idx[c0 : c0 + plan.width] = ri[j]
                leaf[base + grp.s : base + grp.s_pad] = grp.leaves[-1].flat_idx
        return leaf, idx

    @property
    def col_leaf(self) -> np.ndarray:
        """(D,) int32: full-tree flat leaf index owning each column (padding
        columns take their slot segment's last leaf)."""
        return self._col_rng_maps[0]

    @property
    def col_idx(self) -> np.ndarray:
        """(D,) int32: each column's row-major element index within its leaf
        in the reference's layout (0 on padding).  Column ``c``'s uniform is
        ``hash(leaf key words[col_leaf[c]], col_idx[c])``, the bits the
        reference draws for that element."""
        return self._col_rng_maps[1]

    def region_maps_on(self, device: torch.device) -> dict:
        """Each column's place in the reference's region of its group, as
        int64 tensors on ``device`` (cached), each (D,): ``group``, its
        group (the region's index); ``s_pad``, the group's slot width;
        ``slot``, its slot ``j``; ``col``, its column within the slot (a
        leaf's elements in the reference's order; lane padding where it
        lies).  Region element ``(j, k, c)`` is the reference's flat index
        ``(j K + k) s_pad + c`` (the Gauss attacks' noise)."""
        cache = self.__dict__.setdefault("_region_maps_t", {})
        maps = cache.get(device)
        if maps is None:
            group = np.empty(self.D, np.int64)
            s_pad = np.empty(self.D, np.int64)
            slot = np.empty(self.D, np.int64)
            col = np.empty(self.D, np.int64)
            for g, grp in enumerate(self.groups):
                group[grp.col0 : grp.col0 + grp.width] = g
                s_pad[grp.col0 : grp.col0 + grp.width] = grp.s_pad
                for j in range(grp.n_slots):
                    base = grp.col0 + j * grp.s_pad
                    slot[base : base + grp.s_pad] = j
                    col[base : base + grp.s_pad] = np.arange(grp.s_pad)
                    for plan in grp.leaves:
                        ri = reference_index(plan.path, plan.shape).reshape(-1, plan.width)[j]
                        c0 = base + plan.col0
                        col[c0 : c0 + plan.width] = plan.col0 + ri - j * plan.width
            maps = cache[device] = {k: torch.as_tensor(v, device=device)
                                    for k, v in dict(group=group, s_pad=s_pad, slot=slot, col=col).items()}
        return maps

    def pad_cols_on(self, device: torch.device) -> torch.Tensor:
        """The lane padding's columns as an int64 index tensor on ``device``
        (cached)."""
        cache = self.__dict__.setdefault("_pad_cols_t", {})
        t = cache.get(device)
        if t is None:
            pads = [np.arange(grp.col0 + j * grp.s_pad + grp.s, grp.col0 + (j + 1) * grp.s_pad)
                    for grp in self.groups for j in range(grp.n_slots)]
            t = cache[device] = torch.as_tensor(np.concatenate(pads).astype(np.int64), device=device)
        return t

    def maps_on(self, device: torch.device) -> dict:
        """The static column-block maps as int32 tensors on ``device``
        (cached): ``block_layer`` (n_blocks,), ``col_seg``, ``col_leaf``,
        ``col_idx`` (D,)."""
        cache = self.__dict__.setdefault("_maps_t", {})
        maps = cache.get(device)
        if maps is None:
            src = dict(block_layer=self.block_layer, col_seg=self.col_scale_seg,
                       col_leaf=self.col_leaf, col_idx=self.col_idx)
            maps = cache[device] = {
                k: torch.as_tensor(v, dtype=torch.int32, device=device) for k, v in src.items()
            }
        return maps

    def topk_plan(self, frac: float, sample: int, device: torch.device) -> list:
        """Per leaf (group order): ``(grp, plan, k, slots, cols)`` where
        ``slots``/``cols`` index, in a ``(K, n_slots, s_pad)`` group view,
        the elements the reference's threshold rule samples (``flat[::stride]``
        of the leaf in ITS layout), as int64 tensors on ``device`` (cached)."""
        cache = self.__dict__.setdefault("_topk_plans", {})
        key = (frac, sample, device)
        out = cache.get(key)
        if out is None:
            out = []
            for grp in self.groups:
                n = grp.n_slots if grp.stacked else 1
                for plan in grp.leaves:
                    n_el = n * plan.width
                    stride, k = topk_sample_plan(n_el, frac, sample)
                    port_pos = np.empty(n_el, np.int64)
                    port_pos[reference_index(plan.path, plan.shape).ravel()] = np.arange(n_el)
                    pos = port_pos[np.arange(0, n_el, stride)]
                    out.append((grp, plan, k,
                                torch.as_tensor(pos // plan.width, device=device),
                                torch.as_tensor(plan.col0 + pos % plan.width, device=device)))
            cache[key] = out
        return out

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

    def slot_table_on(self, device: torch.device) -> SlotTable:
        """The DRT layer slots as the ``drt_dist`` kernel's slot table, its
        chunk table on ``device`` (cached)."""
        cache = self.__dict__.setdefault("_slot_table", {})
        t = cache.get(device)
        if t is None:
            t = cache[device] = slot_table(self.layer_slices, device)
        return t

    def segment_table_on(self, kind: str, device: torch.device) -> SegmentTable:
        """The per-slot combines' segment table on ``device`` (cached).
        ``kind="slots"``: one segment per DRT layer slot, weights ``p`` its
        layer (they cover the slab); ``"leaves"``: one per (slot, leaf),
        weights its slot's layer, scale column its int8 scale segment (the
        lane padding lies in no segment)."""
        cache = self.__dict__.setdefault("_segment_tables", {})
        t = cache.get((kind, device))
        if t is None:
            if kind == "slots":
                segs = [(s, e - s, p, 0) for p, (s, e) in enumerate(self.layer_slices)]
            elif kind == "leaves":
                segs = [(grp.col0 + j * grp.s_pad + plan.col0, plan.width, grp.layer0 + j,
                         plan.scale_seg0 + (j if plan.scale_per_slot else 0))
                        for grp in self.groups for j in range(grp.n_slots) for plan in grp.leaves]
            else:
                raise ValueError(f"unknown segment table {kind!r}; kinds: 'slots', 'leaves'")
            t = cache[(kind, device)] = segment_table(segs, self.D, device)
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

    def unpack(self, slab: torch.Tensor, like: Tree, dtype: "torch.dtype | None" = None) -> Tree:
        """Inverse of :meth:`pack` (see :meth:`unpack_regions`)."""
        return self.unpack_regions(self.split(slab), like, dtype)

    def unpack_regions(self, regions: tuple, like: Tree, dtype: "torch.dtype | None" = None) -> Tree:
        """Slot-major regions (views or contiguous) -> a tree of contiguous
        leaves in ``like``'s dtypes (or ``dtype``), copied out of the
        regions; ``like`` supplies the structure (its values are ignored)."""
        K = regions[0].shape[1]
        out = dict(like)
        for grp, region in zip(self.groups, regions):
            leaves = {}
            for plan in grp.leaves:
                piece = region[:, :, plan.col0 : plan.col0 + plan.width].transpose(0, 1)
                leaves[plan.path] = piece.reshape(K, *plan.shape).to(dtype or plan.dtype).contiguous()
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

    def combine_unpack(self, A: torch.Tensor, regions: tuple, like: Tree) -> Tree:
        """The final combine and the unpack in one: each output leaf is
        mixed straight from its columns of the regions (one read of the
        regions, one write per leaf, no combined regions in between), in
        ``like``'s dtypes."""
        out = dict(like)
        for grp, region in zip(self.groups, regions):
            A_g = A[grp.layer0 : grp.layer0 + grp.n_slots].float().transpose(1, 2)
            leaves = {}
            for plan in grp.leaves:
                mixed = torch.bmm(A_g, region[:, :, plan.col0 : plan.col0 + plan.width])  # (n, K, w)
                K = mixed.shape[1]
                leaves[plan.path] = mixed.transpose(0, 1).reshape(K, *plan.shape).to(plan.dtype)
            out[grp.key] = _rebuild(like[grp.key], leaves)
        return {k: out[k] for k in sorted(out)}

    def scale_by_layer(self, weights: torch.Tensor, regions: tuple) -> tuple:
        """Regions times per-layer weights: ``weights`` (..., L) with batch
        axes matching the regions' (e.g. (K, L) per-agent self weights for
        (n_slots, K, s_pad) regions)."""
        w_all = weights.float()
        return tuple(
            region * w_all[..., grp.layer0 : grp.layer0 + grp.n_slots].movedim(-1, 0)[..., None]
            for grp, region in zip(self.groups, regions)
        )


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
    flat_offsets, off = {}, 0
    for key in sorted(template):  # full-tree flatten offsets, for rng-split parity
        flat_offsets[key] = off
        off += len(list(tree_items(template[key])))
    groups: list[GroupPlan] = []
    layer_slices: list[tuple[int, int]] = []
    layer_sizes: list[int] = []
    col_scale: list[np.ndarray] = []
    n_scale = 0
    col = 0
    for g in partition.groups:
        plans = []
        s = 0
        for i, (path, leaf) in enumerate(tree_items(template[g.key])):
            if not leaf.dtype.is_floating_point:
                raise ValueError(
                    f"leaf {g.key!r}{list(path)} has dtype {leaf.dtype}; the slab "
                    "path packs floating-point parameters only"
                )
            shape = tuple(int(d) for d in leaf.shape)
            width = int(np.prod(shape[1:] if g.stacked else shape, dtype=np.int64))
            # int8 scale segments: per (leaf, slot) when the codec treats the
            # group as stacked (key ending in "blocks") and the leaf has a
            # per-slot extent, per leaf otherwise
            per_slot = g.key.endswith("blocks") and len(shape) >= 2
            plans.append(LeafPlan(path, shape, leaf.dtype, s, width,
                                  flat_offsets[g.key] + i, per_slot, n_scale))
            n_scale += g.n_slots if per_slot else 1
            s += width
        s_pad = _round_up(s, lane)
        grp = GroupPlan(g.key, g.stacked, g.n_slots, g.offset, col, s, s_pad, tuple(plans))
        groups.append(grp)
        for j in range(g.n_slots):
            layer_slices.append((col + j * s_pad, col + (j + 1) * s_pad))
            layer_sizes.append(s)
            seg = np.empty(s_pad, np.int32)
            for plan in plans:
                seg[plan.col0 : plan.col0 + plan.width] = plan.scale_seg0 + (
                    j if plan.scale_per_slot else 0
                )
            seg[s:] = seg[s - 1]  # padding takes the last leaf's segment
            col_scale.append(seg)
        col += grp.width
    if not groups:
        raise ValueError("template has no leaves to pack")
    return SlabLayout(
        groups=tuple(groups),
        num_layers=partition.num_layers,
        D=col,
        layer_slices=tuple(layer_slices),
        layer_sizes=tuple(layer_sizes),
        n_tree_leaves=off,
        col_scale_seg=np.concatenate(col_scale),
        n_scale_segs=n_scale,
        lane=lane,
    )


# -- coded exchange on the slab ---------------------------------------------------


def slab_quant_scales(codec: Int8StochasticCodec, layout: SlabLayout, slab: torch.Tensor):
    """Per-(leaf, slot) absmax int8 scales in segment-id order, ``(K,
    n_scale_segs)`` f32, 1 where a segment is all zero.  Bit-identical to
    the reference as it runs (under ``jax.jit``): the same f32 max
    reductions, and ``absmax / qmax`` as XLA compiles a division by a
    constant, ``absmax * f32(1 / qmax)``."""
    inv = float(np.float32(1.0) / np.float32(codec.qmax))
    scales = []
    for grp in layout.groups:
        view = layout.group_view(slab, grp)  # (K, n_slots, s_pad)
        for plan in grp.leaves:
            a = view[:, :, plan.col0 : plan.col0 + plan.width].abs()
            absmax = a.amax(dim=-1) if plan.scale_per_slot else a.amax(dim=(1, 2))[:, None]
            scales.append(torch.where(absmax > 0, absmax * inv, torch.ones_like(absmax)))
    return torch.cat(scales, dim=1)


def slab_init_state(codec, layout: SlabLayout, K: int, device) -> "torch.Tensor | tuple":
    """Codec state as a slab: top-k's zero (K, D) f32 residual, else ``()``."""
    if isinstance(codec, TopKCodec):
        return torch.zeros(K, layout.D, dtype=F32, device=device)
    return ()


def leaf_key_words(layout: SlabLayout, keys_K: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-(agent, leaf) counter-RNG key words ``(w0, w1)``, each ``(K,
    n_tree_leaves)`` uint32: ``split(agent_key, n_tree_leaves)`` per agent,
    as the reference's int8 codec splits its key over every tree leaf."""
    words = prng.split(keys_K, layout.n_tree_leaves)
    return words[..., 0], words[..., 1]


def int8_wire_operands(codec, layout: SlabLayout, slab: torch.Tensor, keys_K: np.ndarray):
    """``(scales, col_seg, col_leaf, col_idx, w0, w1)``: what the int8
    kernels take for one round, on the slab's device."""
    maps = layout.maps_on(slab.device)
    w0, w1 = leaf_key_words(layout, keys_K)
    return (
        slab_quant_scales(codec, layout, slab), maps["col_seg"], maps["col_leaf"],
        maps["col_idx"], prng.words_to_tensor(w0, slab.device), prng.words_to_tensor(w1, slab.device),
    )


def slab_disagreement(slab: torch.Tensor, layout: SlabLayout) -> torch.Tensor:
    """Network disagreement ``mean_k ||x_k - x_bar||^2`` of a (K, D) slab,
    summed group by group in f32 as the reference's ``region_disagreement``
    sums its regions.  Lane padding is zero for every agent and adds 0."""
    total = torch.zeros((), dtype=F32, device=slab.device)
    for grp in layout.groups:
        x = layout.group_view(slab, grp).float()
        total = total + (x - x.mean(dim=0, keepdim=True)).square().sum()
    return total / slab.shape[0]


# -- sparse (edge-list) round pieces on the slab ----------------------------------
#
# The reference works on per-group regions; here the (K, D) slab's
# 128-column blocks carry their layer in ``block_layer`` (a block never
# straddles two layers), so a per-layer sum is a per-block sum over the
# block's columns followed by a per-layer sum over its blocks: the same
# columns the reference's regions group.


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """A (rows, D) slab as (rows, n_blocks, LANES) f32."""
    return x.float().view(x.shape[0], -1, LANES)


def _per_layer(partial: torch.Tensor, block_layer: torch.Tensor, num_layers: int) -> torch.Tensor:
    """(rows, n_blocks) per-block sums -> (L, rows) per-layer sums."""
    out = torch.zeros(num_layers, partial.shape[0], dtype=F32, device=partial.device)
    return out.index_add_(0, block_layer.long(), partial.T)


def _block_cols(A: torch.Tensor, block_layer: torch.Tensor) -> torch.Tensor:
    """Per-layer factors (L, n) -> (n, n_blocks, 1): each block's layer's
    factor, broadcast over the block's columns."""
    return A.float()[block_layer.long()].T[:, :, None]


def layer_sq_norms(x: torch.Tensor, block_layer: torch.Tensor, num_layers: int) -> torch.Tensor:
    """Per-DRT-layer squared norms of each row of a (K, D) slab -> (L, K)."""
    return _per_layer(_blocks(x).square().sum(-1), block_layer, num_layers)


def edge_sq_dists(x, src, dst, block_layer, num_layers: int) -> torch.Tensor:
    """Per-edge, per-layer ``||x_src - x_dst||^2`` of a (K, D) slab over a
    padded directed edge list -> (L, E).  Direct differences, O(|E| D);
    padding edges (src = dst = 0) give exact zeros."""
    xb = _blocks(x)
    diff = xb[src.long()] - xb[dst.long()]
    return _per_layer(diff.square().sum(-1), block_layer, num_layers)


def edge_combine(A_self, A_e, src, dst, x_self, x_dec, block_layer) -> torch.Tensor:
    """Scatter combine ``new[k] = A_self[p, k] self[k] + sum_{e: dst[e]=k}
    A_e[p, e] dec[src[e]]`` per column of layer p: gather by source,
    scatter-add by destination in edge-list order.  Padding edges must
    carry ``A_e == 0``."""
    out = _blocks(x_self) * _block_cols(A_self, block_layer)
    gathered = _blocks(x_dec)[src.long()] * _block_cols(A_e, block_layer)
    return out.index_add_(0, dst.long(), gathered).view(x_self.shape[0], -1)


def csr_neighbor_rows(x: torch.Tensor, nbr: torch.Tensor) -> list:
    """One gathered neighbour slab per CSR in-slot: ``nbr`` (K_local, Dmax)
    source agents -> Dmax slabs (K_local, D) f32 (padded slots gather agent
    0; their weights are zero)."""
    xf = x.float()
    return [xf[nbr[:, j].long()] for j in range(nbr.shape[1])]


def csr_combine(A_self, a_csr, x_self, nbr_rows: list, block_layer) -> torch.Tensor:
    """Gather-only combine ``new[k] = A_self[p, k] self[k] + sum_j
    a_csr[p, k, j] nbr_rows[j][k]``, slot by slot in the reference's order
    (one rounded product and one rounded sum per slot).  ``A_self`` (L,
    K_local), ``a_csr`` (L, K_local, Dmax), zero on padded slots."""
    out = _blocks(x_self) * _block_cols(A_self, block_layer)
    for j, rows in enumerate(nbr_rows):
        out = out + _block_cols(a_csr[:, :, j], block_layer) * _blocks(rows)
    return out.view(x_self.shape[0], -1)
