"""The convolutions' share of their roofline: the least time of every
convolution call in the traced window (the larger of its operations over
the compute peak and its bytes over the memory bandwidth, forward or
data-grad and weight-grad as the call computes them, from the shapes the
profile recorded), over the device time of the kernels launched under the
``aten::convolution`` and ``aten::convolution_backward`` rows.

Layer: the model (``models/resnet.py``, ``nn/conv.py``, ``nn/norm.py``:
cuDNN convolutions). Moves ``train_samples_per_s``."""
from bench import tracing


def read(trace):
    calls = trace.conv_calls()
    device_s = sum(c[4] for c in calls)
    if not calls or device_s <= 0:
        return None
    peak = tracing.cuda_peak_for(trace.tf32)
    least = [tracing.conv_least_seconds(c, peak) for c in calls]
    if any(t is None for t in least):
        return None
    return 100.0 * sum(least) / device_s
