"""Hand-written Hopper kernels of the port, one package per TPU kernel family.

Each package keeps the JAX package's split: ``ref.py`` holds the plain
PyTorch version, ``kernel.py`` launches the CUDA C++ (``csrc/``) or Triton
kernel, and ``ops.py`` is the wrapper with the ``torch.autograd.Function``.
A wrapper runs the plain version for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.

``LAUNCHES`` counts kernel launches by family. Each launching function
adds one right after its launch and nowhere else, so a caller can zero
the counts, drive a path, and read which kernels that path went through
(``bn_grad``'s launcher enqueues two kernels and counts one).
``BYTES`` counts the bytes that the SFPL step's kernels (K1
``collector_permute``, K2 ``bn_act``, K3f ``xent_fwd``, K3b ``xent_bwd``,
and the BatchNorm training op's ``bn_moments`` and ``bn_grad``) moved:
every operand byte read once, every output byte written once, from the
launch's own operands, by a pure function beside each launcher, which
calls ``count`` in place of the plain increment. Both are groups of
the port's one counter registry (``repro_torch.trace.COUNTERS["launches"]``
and ``["bytes"]``, the same dict objects).
"""
from repro_torch.trace import COUNTERS

LAUNCHES = COUNTERS["launches"]
LAUNCHES.update({"collector_permute": 0, "bn_act": 0, "bn_moments": 0,
                 "bn_grad": 0, "xent_fwd": 0, "xent_bwd": 0,
                 "bucket_permute": 0, "unbucket_permute": 0,
                 "quant_bucket_permute": 0, "dequant_unbucket_permute": 0,
                 "rmsnorm": 0, "flash_attention": 0, "slstm_scan": 0})
BYTES = COUNTERS["bytes"]
BYTES.update({"collector_permute": 0, "bn_act": 0, "bn_moments": 0,
              "bn_grad": 0, "xent_fwd": 0, "xent_bwd": 0})


def count(family, nbytes):
    """One launch of ``family`` that moved ``nbytes``."""
    LAUNCHES[family] += 1
    BYTES[family] += nbytes


def reset_launches():
    """Zero the kernels' launch and byte counts."""
    for group in (LAUNCHES, BYTES):
        for name in group:
            group[name] = 0
