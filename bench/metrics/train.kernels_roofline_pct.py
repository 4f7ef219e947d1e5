"""The port's SFPL kernels' share of their roofline: K1
``collector_permute``, K2 ``bn_act``, K3f / K3b ``softmax_xent``. Their
bytes a step from the cell's shapes (``yardstick.kernel_step_bytes``:
every input byte read once, every output byte written once) over the
bandwidth, over their device time in the traced window, the kernels found
by the frozen symbol table. Where a kernel's launches in the window are
not the count those shapes give, the yardstick no longer describes the
program, and the metric is left out.

Layer: ``kernels/`` (K1, K2, K3f, K3b). Moves ``train_samples_per_s``."""
from bench import yardstick as Y


def read(trace):
    cfg, dep = trace.cell.config["model"], trace.cell.config["deployment"]
    pool = dep["clients"] * trace.cell.traffic["client_batch"]
    want = Y.kernel_step_bytes(cfg, pool, dep["clients"])
    got = trace.family_time(Y.KERNEL_SYMBOLS)
    if not any(n for n, _ in got.values()):
        return None
    bound = device = 0.0
    for fam, (launches, nbytes) in want.items():
        n, secs = got[fam]
        if n != launches * trace.steps:
            return None
        bound += trace.steps * nbytes / Y.HBM_BYTES_PER_S
        device += secs
    return 100.0 * bound / device
