"""The BatchNorm training op's kernels' share of their roofline, from the
bytes the program counted where it launched them: ``COUNTERS["bytes"]``
of ``bn_moments`` (the moments, fold and running update) and ``bn_grad``
(the backward's reduction and dx pass; every operand byte read once,
every output byte written once, partials included) over
``COUNTERS["sfpl"]["steps"]``, times the traced pass's steps, over the
bandwidth, over the device time of the kernels whose names hold the
symbols below. The counters run over every step of the process; the
ratio holds because every step of a cell does the same work. Left out
where the program keeps no such counters or launched no such kernel.

Layer: ``kernels/`` (``kernels/bn_act``). Moves ``train_samples_per_s``."""
from bench import spans
from bench import yardstick as Y

# kernel family -> substring of its device symbols in a profile
SYMBOLS = {"bn_moments": "bn_moments_kernel", "bn_grad": "bn_grad_"}


def read(trace):
    c = spans.counters()
    if c is None or not c["sfpl"].get("steps"):
        return None
    if not all(f in c["bytes"] for f in SYMBOLS):
        return None
    device = sum(secs for _, secs in trace.family_time(SYMBOLS).values())
    if device <= 0:
        return None
    nbytes = sum(c["bytes"][f] for f in SYMBOLS) / c["sfpl"]["steps"] \
        * trace.steps
    return 100.0 * nbytes / Y.HBM_BYTES_PER_S / device
