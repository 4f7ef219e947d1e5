"""The whole split-LM SFPL step's share of the card's bf16 peak while the
card is busy: the model FLOPs of the device pass's steps
(``lm_yardstick.step_model_flops``: forward times three, no recompute;
the windows counted; the held experts' rows as the full pass's forward
ran them, ``lm_yardstick.forward_held_rows``) over that pass's device
busy seconds times 989e12. Left out where the trace records no grouped
product.

Layer: the whole SFPL step. Moves ``train_samples_per_s``."""
from bench import lm_yardstick as L


def read(trace):
    busy = trace.busy
    held = L.forward_held_rows(trace)
    if busy is None or busy.busy_s <= 0 or held is None or not trace.steps:
        return None
    cell = trace.cell
    flops = trace.steps * L.step_model_flops(cell.config, cell.traffic, held)
    return 100.0 * flops / (busy.busy_s * L.PEAK)
