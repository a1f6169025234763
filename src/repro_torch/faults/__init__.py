"""Byzantine fault injection and trust-robust consensus.

Counterpart of ``repro.faults``:

- :mod:`repro_torch.faults.models` -- attack models (``FaultModel``:
  sign_flip / gauss / cgauss / scale / constant)
- :mod:`repro_torch.faults.mask` -- seeded Byzantine-membership tables
- :mod:`repro_torch.faults.wire` -- wire faults (message drop as a
  ``TopologySchedule`` wrapper, stale-iterate delivery)
- :mod:`repro_torch.faults.robust` -- trust clipping and temperature on the
  mixing weights (dense, edge-factorized and per-rank), trimmed-mean and
  median combines
- :mod:`repro_torch.faults.plan` -- ``FaultPlan`` (host) ->
  ``FaultRealization`` (one round-set) for the consensus engines
"""
from repro_torch.faults.mask import ByzantineMask
from repro_torch.faults.models import (
    ConstantFault,
    FaultModel,
    GaussFault,
    ScaleFault,
    SignFlip,
    apply_fault_regions,
    apply_fault_tree,
    make_fault_model,
)
from repro_torch.faults.plan import FaultPlan, FaultRealization, make_fault_plan
from repro_torch.faults.robust import (
    parse_combine,
    reweight_dense,
    reweight_edge,
    reweight_local,
    robust_combine,
    support_uniform,
    validate_trust_knobs,
)
from repro_torch.faults.wire import DropSchedule, StaleMask

__all__ = [
    "ByzantineMask",
    "ConstantFault",
    "DropSchedule",
    "FaultModel",
    "FaultPlan",
    "FaultRealization",
    "GaussFault",
    "ScaleFault",
    "SignFlip",
    "StaleMask",
    "apply_fault_regions",
    "apply_fault_tree",
    "make_fault_model",
    "make_fault_plan",
    "parse_combine",
    "reweight_dense",
    "reweight_edge",
    "reweight_local",
    "robust_combine",
    "support_uniform",
    "validate_trust_knobs",
]
