"""The attention cores' share of the device time: the device time of the
kernels charged to the program's ``attn.core`` span (the scores, softmax
and values' sum of every layer, forward, recompute and backward), over
the time of every kernel of the full pass. Left out where the program
records no such span.

Layer: the model (``nn/attention.py``'s ``flex`` path). Moves
``train_samples_per_s``."""
from bench import spans


def read(trace):
    return spans.device_pct(trace, ("attn.core",))
