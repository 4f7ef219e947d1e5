"""The held experts' grouped products against the bf16 peak: the FLOPs
of their SwiGLU over the rows routed to them in the traced steps
(``lm_yardstick.expert_kernel_flops``: the forward, the recompute and
the backward; the rows as the forward ran them,
``lm_yardstick.forward_held_rows``), over the device time of the kernels
charged to ``moe.experts`` times 989e12.
These products are bound by compute (1,024 and 2,048 wide, thousands of
rows an expert), so the peak is their roofline. Left out where the
program records no such span or product.

Layer: the kernels (``torch._grouped_mm`` under ``nn/moe.py``). Moves
``train_samples_per_s``."""
from bench import lm_yardstick as L


def read(trace):
    held = L.forward_held_rows(trace)
    secs = L.charged_seconds(trace, "moe.experts")
    if held is None or not secs or not trace.steps:
        return None
    flops = trace.steps * L.expert_kernel_flops(trace.cell.config, held)
    return 100.0 * flops / (secs * L.PEAK)
