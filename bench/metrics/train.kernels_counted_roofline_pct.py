"""The port's SFPL kernels' share of their roofline, from the bytes the
program counted where it launched them: ``COUNTERS["bytes"]`` of K1
``collector_permute``, K2 ``bn_act``, K3f / K3b ``softmax_xent`` (every
operand byte read once, every output byte written once) over
``COUNTERS["sfpl"]["steps"]``, times the traced pass's steps, over the
bandwidth, over the device time of those kernels in the pass (found by
the frozen symbol table). The counters run over every step of the
process, the checked steps and the window included; the ratio holds
because every step of a cell does the same work. No launch count has to
match a yardstick. Left out where the program keeps no such counters.

Layer: ``kernels/`` (K1, K2, K3f, K3b). Moves ``train_samples_per_s``."""
from bench import spans
from bench import yardstick as Y


def read(trace):
    c = spans.counters()
    if c is None or not c["sfpl"].get("steps"):
        return None
    fams = Y.KERNEL_SYMBOLS
    if not all(f in c["bytes"] for f in fams):
        return None
    device = sum(secs for _, secs in trace.family_time(fams).values())
    if device <= 0:
        return None
    nbytes = sum(c["bytes"][f] for f in fams) / c["sfpl"]["steps"] \
        * trace.steps
    return 100.0 * nbytes / Y.HBM_BYTES_PER_S / device
