"""Training substrate of the port (PyTorch counterpart of `repro.train`):
the train state, the mixed-precision train step and the fault-tolerant
trainer (`train.trainer`)."""
from .step import TrainState, init_train_state, make_train_step

__all__ = ["TrainState", "init_train_state", "make_train_step"]
