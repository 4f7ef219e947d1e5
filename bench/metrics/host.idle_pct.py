"""The device's idle share in a cell that host dispatch paces: the part
of the device pass's window (the CUDA activity alone, so the profiler
slows the host little) that no device operation covers; the share
``train.idle_pct`` takes; ``host.samples_per_s`` is the rate it bears
on.

Layer: the device (H100). Moves ``peak_mem_gib``, the cell's end-to-end
metric besides ``setup_s``."""


def read(trace):
    return None if trace.busy is None else trace.busy.idle_pct()
