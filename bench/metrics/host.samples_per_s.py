"""The training rate in a cell that host dispatch paces: client samples
the untraced window's whole SFPL epochs consumed (FedAvg included), over
its seconds on the host's clock, which end in a synchronise. The rate
``train_samples_per_s`` takes; here a layer's reading, since the host's
speed moves it by more than an end-to-end bound may hold.

Layer: the round engine and host dispatch (``core/round.py::sfpl_round``,
eager PyTorch). Moves ``peak_mem_gib``, the cell's end-to-end metric
besides ``setup_s``."""


def read(trace):
    return getattr(trace, "window_rate", None)
