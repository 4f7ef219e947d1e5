"""Launches a training step in a cell that host dispatch paces: the
kernels the traced window ran (each one launch of the runtime or driver
API: eager PyTorch, cuDNN, cuBLAS and the port's own) over the SFPL steps
it held, FedAvg's share included. The count ``train.launches_per_step``
takes, where it moves ``host_paced_samples_per_s``.

Layer: the round engine and host dispatch (``core/round.py::sfpl_round``,
``core/engine.py``, eager PyTorch). Moves ``host_paced_samples_per_s``."""


def read(trace):
    return trace.launches_per_step()
