"""Device policy of the PyTorch port.

Every entry point takes an explicit ``device`` that defaults to CUDA.  A
caller who wants the CPU says so (``device="cpu"``, as the tests do); asking
for CUDA on a machine without a GPU raises instead of carrying on quietly on
the CPU.  There is no environment switch: which device runs is visible at
the call site.

Kernel wrappers do not consult this module: they dispatch on the device of
the tensors they are given (a CPU tensor takes the plain PyTorch version, a
CUDA tensor launches the kernel or raises).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device: "torch.device | str | None" = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA.

    Raises ``RuntimeError`` when the resolved device is CUDA and no GPU is
    visible — never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is False; "
                'pass device="cpu" to run on the CPU'
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so a host
    clock read afterwards measures the work and not its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
