from .losses import chunked_cross_entropy
from .train_step import (TrainState, build_loss_fn, build_train_step,
                         make_train_state)

__all__ = ["chunked_cross_entropy", "TrainState", "make_train_state",
           "build_train_step", "build_loss_fn"]
