"""Launches a training step: the kernels the traced window ran (each one
launch of the runtime or driver API: eager PyTorch, cuDNN, cuBLAS and the
port's own) over the SFPL steps it held, FedAvg's share included.

Layer: the round engine and host dispatch (``core/round.py::sfpl_round``,
``core/engine.py``, eager PyTorch). Moves ``train_samples_per_s``."""


def read(trace):
    return trace.launches_per_step()
