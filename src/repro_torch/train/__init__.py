"""Training loop substrate."""

from .train_loop import TrainState, make_train_step

__all__ = ["TrainState", "make_train_step"]
