"""The device's idle share: the part of the device pass's window (the
CUDA activity alone, so the profiler slows the host little) that no
device operation (kernel, copy or fill) covers.

Layer: the device (H100). Moves ``train_samples_per_s``."""


def read(trace):
    return None if trace.busy is None else trace.busy.idle_pct()
