"""The attention cores against the bf16 peak: their FLOPs in the traced
steps (``lm_yardstick.attn_kernel_flops``: the keys the causal mask and
the windows let through; the forward, the recompute, and the backward
counted as 2.5 forwards), over the device time of the kernels charged to
``attn.core`` times 989e12. At 8,192 positions and head dim 128 these
are bound by compute, so the peak is their roofline. Left out where the
program records no such span.

Layer: the kernels (the compiled ``flex_attention`` of
``nn/attention.py``). Moves ``train_samples_per_s``."""
from bench import lm_yardstick as L


def read(trace):
    secs = L.charged_seconds(trace, "attn.core")
    if not secs or not trace.steps:
        return None
    cell = trace.cell
    flops = trace.steps * L.attn_kernel_flops(cell.config, cell.traffic)
    return 100.0 * flops / (secs * L.PEAK)
