"""The BatchNorm statistics' share of the device time: as
``train.bn_device_pct``, for the ``bn.stats`` span alone (the f32 copy
``x.float()``, the batch moments, the running update and their backward).
Left out where the program records no such span.

Layer: the model (``nn/norm.py::_stats``). Moves ``train_samples_per_s``."""
from bench import spans


def read(trace):
    return spans.device_pct(trace, ("bn.stats",))
