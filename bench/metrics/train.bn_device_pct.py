"""The BatchNorms' share of the device time: the device time of the
kernels charged to the program's ``bn.stats`` and ``bn.act`` spans, over
the time of every kernel of the full pass. A forward kernel is charged to
the span on its launch call's stack; a backward kernel to the span around
the forward operator whose ``Sequence number`` its autograd node carries
(``bench/spans.py``). Left out where the program records no such span.

Layer: the model (``nn/norm.py``: f32 batch moments, the folded affine,
K2 or its plain version, and their backward). Moves
``train_samples_per_s``."""
from bench import spans


def read(trace):
    return spans.device_pct(trace, ("bn.stats", "bn.act"))
