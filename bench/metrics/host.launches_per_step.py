"""Launches a training step in a cell that host dispatch paces: the
kernels the traced window ran (each one launch of the runtime or driver
API: eager PyTorch, cuDNN, cuBLAS and the port's own) over the SFPL steps
it held, FedAvg's share included. The count ``train.launches_per_step``
takes; ``host.samples_per_s`` is the rate it bears on.

Layer: the round engine and host dispatch (``core/round.py::sfpl_round``,
``core/engine.py``, eager PyTorch). Moves ``peak_mem_gib``, the cell's
end-to-end metric besides ``setup_s``."""


def read(trace):
    return trace.launches_per_step()
