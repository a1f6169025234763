"""Fault plans: the host-side bundle a trainer owns, and the per-round-set
realization the consensus engines consume.

Counterpart of ``repro.faults.plan``.  A :class:`FaultPlan` holds the
seeded host tables; :meth:`FaultPlan.realize` slices one round-set's rows
into a :class:`FaultRealization`, keyed on the global round counter, so a
resumed run replays the same faults.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm import prng
from repro_torch.faults.mask import ByzantineMask
from repro_torch.faults.models import FaultModel, make_fault_model
from repro_torch.faults.wire import StaleMask

__all__ = ["FaultPlan", "FaultRealization", "make_fault_plan"]


@dataclasses.dataclass(frozen=True)
class FaultRealization:
    """One round-set's faults.  ``mask`` / ``stale``: ``(rounds, K)`` bool
    tensors on the engine's device (row ``r`` for round ``r``), ``None``
    when off; ``key``: the attack key, two uint32 words (``prng.key``),
    folded per round and per region or leaf.  ``mask_host``: the mask's
    rows on the host (a Gauss attack draws noise for the masked rows only);
    read off ``mask`` when not given."""

    model: FaultModel | None
    mask: torch.Tensor | None
    stale: torch.Tensor | None
    key: np.ndarray
    mask_host: np.ndarray | None = None


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Host-side fault configuration: attack model, membership, wire faults."""

    model: FaultModel | None = None
    mask: ByzantineMask | None = None
    stale: StaleMask | None = None
    seed: int = 0

    def __post_init__(self):
        if (self.model is None) != (self.mask is None):
            raise ValueError(
                "FaultPlan needs model and mask together: a fault model without "
                "Byzantine membership (or vice versa) is underspecified"
            )

    @property
    def enabled(self) -> bool:
        return self.mask is not None or self.stale is not None

    def realize(self, start_round: int, rounds: int, device=None) -> FaultRealization | None:
        """The realization of rounds ``start_round .. start_round + rounds -
        1`` on ``device``, or ``None`` when nothing is enabled (the engines
        then run their fault-free paths)."""
        if not self.enabled:
            return None
        host = None if self.mask is None else self.mask.host_stacks(start_round, rounds)
        return FaultRealization(
            model=self.model,
            mask=None if host is None else torch.as_tensor(host, device=device),
            stale=None if self.stale is None else self.stale.mask_stacks(start_round, rounds, device),
            key=prng.key(self.seed),
            mask_host=host,
        )


def make_fault_plan(K: int, *, byzantine: float = 0.0, fault_model=None, stale: float = 0.0,
                    seed: int = 0) -> FaultPlan | None:
    """A :class:`FaultPlan` from trainer-level knobs (``None`` if all off).
    ``byzantine > 0`` needs a ``fault_model`` spec and the other way round:
    there is no silent default attack."""
    if byzantine <= 0.0 and stale <= 0.0 and fault_model is None:
        return None
    if byzantine > 0.0 and fault_model is None:
        raise ValueError("byzantine > 0 needs a fault model (e.g. fault_model='sign_flip')")
    if fault_model is not None and byzantine <= 0.0:
        raise ValueError(f"fault model {fault_model!r} needs byzantine > 0 to select victims")
    return FaultPlan(
        model=make_fault_model(fault_model) if fault_model is not None else None,
        mask=ByzantineMask(K, byzantine, seed=seed) if byzantine > 0.0 else None,
        stale=StaleMask(K, stale, seed=seed) if stale > 0.0 else None,
        seed=seed,
    )
