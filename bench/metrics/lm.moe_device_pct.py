"""The MoE layers' share of the device time: the device time of the
kernels charged to the program's ``moe.route``, ``moe.dispatch``,
``moe.experts`` and ``moe.combine`` spans (forward and recompute kernels
by their launch, backward kernels through their forward operator,
``bench/spans.py``), over the time of every kernel of the full pass.
Left out where the program records no such span.

Layer: the model (``nn/moe.py``'s dropless top-k MoE). Moves
``train_samples_per_s``."""
from bench import spans


def read(trace):
    return spans.device_pct(trace, ("moe.",))
