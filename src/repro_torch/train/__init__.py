"""Train and eval step builders of the port (``repro.train``)."""
from repro_torch.train.step import (
    TrainState, init_state, make_eval_step, make_train_step, value_and_grad,
)

__all__ = ["TrainState", "init_state", "make_eval_step", "make_train_step",
           "value_and_grad"]
