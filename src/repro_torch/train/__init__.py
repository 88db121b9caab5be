"""Training loop substrate."""

from .train_loop import TrainState, make_train_step, train_state_specs

__all__ = ["TrainState", "make_train_step", "train_state_specs"]
