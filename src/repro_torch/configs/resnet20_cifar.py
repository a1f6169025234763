"""resnet20_cifar — the paper's own experiment config (§IV):

16 agents, ResNet-20, CIFAR-10-like data, non-IID shards (5-8 classes,
1500-2000 samples per agent), batch 128, one local epoch per round, 3
consensus steps, N = 2K.  Real CIFAR-10 is not available offline; the data
module provides a synthetic CIFAR-like task (see repro_torch.data.cifar_like).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperExperimentConfig:
    num_agents: int = 16
    width: int = 16  # resnet-20 base width
    num_classes: int = 10
    image_size: int = 32
    batch_size: int = 128
    min_classes_per_agent: int = 5
    max_classes_per_agent: int = 8
    min_samples_per_agent: int = 1500
    max_samples_per_agent: int = 2000
    consensus_steps: int = 3
    lr: float = 0.05
    momentum: float = 0.9
    # N = 2K per §IV.A
    @property
    def drt_N(self) -> float:
        return 2.0 * self.num_agents


PAPER = PaperExperimentConfig()
TOPOLOGIES = ("ring", "erdos_renyi", "hypercube")
