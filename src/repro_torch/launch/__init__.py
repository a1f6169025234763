"""Entry points of the LM zoo: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train`` (decentralized training, gather
engine)."""
from repro_torch.launch.train import (
    TrainState,
    build_partition,
    init_train_state,
    make_train_many_steps,
    make_train_step,
    state_to,
)

__all__ = ["TrainState", "build_partition", "init_train_state", "make_train_many_steps", "make_train_step",
           "state_to"]
