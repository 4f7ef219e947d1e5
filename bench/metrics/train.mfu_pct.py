"""The whole SFPL step's share of the card's bf16 peak while the card is
busy: the model FLOPs of the samples of the device pass
(``yardstick.model_flops_per_sample``: conv and classifier forward times
three, less the stem's data-grad, no recompute) over that pass's device
busy seconds times 989e12. It moves with the device's work and not with
the host's dispatch, which ``train.idle_pct`` reads; the share of the
whole window is this times one less the idle share.

Layer: the whole SFPL step. Moves ``train_samples_per_s``."""
from bench import yardstick as Y


def read(trace):
    busy = trace.busy
    if busy is None or busy.busy_s <= 0:
        return None
    flops = busy.samples * Y.model_flops_per_sample(trace.cell.config["model"])
    return 100.0 * flops / (busy.busy_s * Y.PEAK_FLOPS["bfloat16"])
