"""The benchmark's fixed arithmetic: peaks of the card, the operations and
bytes of the SFPL step's convolutions and kernels, and the symbols by
which a profile names the port's kernels.

Frozen copies, so that a change to the program cannot move the yardstick:

* ``PEAK_FLOPS`` and ``HBM_BYTES_PER_S`` are NVIDIA's published H100 SXM
  rates (data sheet, dense, at the 700 W limit), as ``chip_smoke.py``
  (``PEAK_FLOPS``, ``HBM_BYTES_PER_S``) and ``PERF.md``'s ``HW`` table have
  them.
* ``KERNEL_SYMBOLS`` is ``chip_smoke.py``'s ``SYMBOL`` table for the
  kernels of the single-device SFPL step (K1, K2, K3f, K3b).
* The byte counts of the kernels follow the operands of their launchers
  (``src/repro_torch/kernels/*/kernel.py``): every input byte read once,
  every output byte written once.
"""
from __future__ import annotations

import math

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

# kernel family -> substring of its device symbol in a profile
KERNEL_SYMBOLS = {"collector_permute": "permute_rows",
                  "bn_act": "bn_act_kernel",
                  "xent_fwd": "xent_fwd_kernel",
                  "xent_bwd": "xent_bwd_kernel"}


def least_seconds(flops, nbytes, peak_flops):
    """The least time a call can take: the larger of its operations over
    the compute peak and its bytes over the memory bandwidth."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)


def conv_out(size, k, stride, pad_lo, pad_hi, dilation=1):
    return (size + pad_lo + pad_hi - dilation * (k - 1) - 1) // stride + 1


def conv_macs(batch, cin, cout, hout, wout, kh, kw, groups=1):
    """Multiply-adds of one 2-D convolution (each of forward, data-grad
    and weight-grad does this many)."""
    return batch * cout * hout * wout * (cin // groups) * kh * kw


def conv_call_cost(x_shape, w_shape, y_shape, elem_bytes, *, fwd=True,
                   dgrad=False, wgrad=False):
    """(flops, bytes) of one convolution call, NCHW shapes: the forward
    reads x and w and writes y; the data-grad reads dy and w and writes dx;
    the weight-grad reads dy and x and writes dw."""
    b, cin, _, _ = x_shape
    cout, cin_g, kh, kw = w_shape
    _, _, ho, wo = y_shape
    groups = cin // cin_g
    flops_one = 2 * conv_macs(b, cin, cout, ho, wo, kh, kw, groups)
    nx, nw, ny = (math.prod(s) * elem_bytes for s in (x_shape, w_shape,
                                                      y_shape))
    flops = nbytes = 0
    for on, moved in ((fwd, nx + nw + ny), (dgrad, ny + nw + nx),
                      (wgrad, ny + nx + nw)):
        if on:
            flops += flops_one
            nbytes += moved
    return flops, nbytes


# --------------------------------------------------------------------------
# the split CIFAR ResNet of a configuration

def resnet_convs(cfg):
    """Every convolution of the split ResNet, in forward order: ``(name, cin, cout, k, stride, hw_in)``; the stem (the
    clients' conv) first. ``cfg`` is a configuration file's ``model``."""
    w, hw, n = cfg["width"], cfg["image_hw"], (cfg["depth"] - 2) // 6
    out = [("stem", cfg["in_channels"], w, 3, 1, hw)]
    cin, size = w, hw
    for stage, cout in enumerate((w, 2 * w, 4 * w)):
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            out.append((f"s{stage}b{b}.conv1", cin, cout, 3, stride, size))
            nsize = -(-size // stride)
            out.append((f"s{stage}b{b}.conv2", cout, cout, 3, 1, nsize))
            if stride != 1 or cin != cout:
                out.append((f"s{stage}b{b}.proj", cin, cout, 1, stride,
                            size))
            cin, size = cout, nsize
    return out


def model_flops_per_sample(cfg):
    """Model FLOPs of one training sample: the forward of every conv and
    of the classifier, times three (forward, data-grad, weight-grad), less
    the stem's data-grad (the images need none); no recompute counted."""
    total = 0
    for name, cin, cout, k, stride, hw in resnet_convs(cfg):
        ho = -(-hw // stride)
        fwd = 2 * conv_macs(1, cin, cout, ho, ho, k, k)
        total += fwd * (2 if name == "stem" else 3)
    total += 3 * 2 * (4 * cfg["width"]) * cfg["num_classes"]
    return total


def bn_sizes(cfg):
    """Elements a sample of each BatchNorm + activation sweeps, in forward
    order, the clients' first: one entry per batch-norm layer."""
    out = []
    for name, cin, cout, k, stride, hw in resnet_convs(cfg):
        ho = -(-hw // stride)
        out.append(ho * ho * cout)
    return out


def kernel_step_bytes(cfg, pool_rows, clients, elem_bytes=2):
    """(launches, bytes) a training step of the single-device SFPL round
    gives each of the port's kernels, for a pool of ``pool_rows`` rows
    from ``clients`` clients, in a compute dtype of ``elem_bytes``.

    K1 gathers the pool forward and its gradient back (2 launches: rows
    read and written, int64 indices read). K2 sweeps every BN's input and
    output, with the folded f32 affine (2 x C floats a group) read: the
    server's BNs once, the clients' twice (the forward and the client
    update's re-run of it). K3f reads the logits and int64 labels and
    writes f32 nll and lse a row; K3b reads logits, labels, lse and the
    f32 row scale and writes the logits' gradient."""
    width, classes = cfg["width"], cfg["num_classes"]
    hw = cfg["image_hw"]
    row = hw * hw * width * elem_bytes
    k1 = 2 * (2 * pool_rows * row + pool_rows * 8)
    sizes = bn_sizes(cfg)
    channels = [c for _, _, c, _, _, _ in resnet_convs(cfg)]
    k2_launch = [2 * pool_rows * s * elem_bytes for s in sizes]
    k2_affine = [2 * c * 4 for c in channels]
    k2_affine[0] *= clients
    k2 = [x + a for x, a in zip(k2_launch, k2_affine)]
    k2_total = sum(k2) + k2[0]          # the clients' BN runs twice
    logits = pool_rows * classes * elem_bytes
    k3f = logits + pool_rows * 8 + 2 * pool_rows * 4
    k3b = 2 * logits + pool_rows * 8 + 2 * pool_rows * 4
    return {"collector_permute": (2, k1),
            "bn_act": (len(k2) + 1, k2_total),
            "xent_fwd": (1, k3f),
            "xent_bwd": (1, k3b)}
