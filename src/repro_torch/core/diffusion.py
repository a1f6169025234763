"""Classical diffusion baseline (paper eqs. 3a/3b with Metropolis weights).

Counterpart of ``repro.core.diffusion``: the static (K, K) Metropolis matrix
applied uniformly to every DRT layer, broadcast to (L, K, K) so classical
and DRT diffusion share the per-layer combine.
"""
from __future__ import annotations

import torch

from repro_torch.core.topology import Topology


def classical_mixing_matrices(
    topology: Topology, num_layers: int, device: "torch.device | str" = "cpu"
) -> torch.Tensor:
    """Static Metropolis A broadcast over DRT layers: (L, K, K) f32."""
    A = torch.as_tensor(topology.metropolis(), dtype=torch.float32, device=device)
    return A.expand(num_layers, *A.shape)
