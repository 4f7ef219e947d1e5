"""Hand-written Hopper kernels of the port, one package per TPU kernel family.

Each package keeps the JAX package's split: ``ref.py`` holds the plain
PyTorch version, ``kernel.py`` launches the CUDA C++ (``csrc/``) or Triton
kernel, and ``ops.py`` is the wrapper with the ``torch.autograd.Function``.
A wrapper runs the plain version for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.

``LAUNCHES`` counts kernel launches by name. Each launching function adds
one right after its launch and nowhere else, so a caller can zero the
counts, drive a path, and read which kernels that path went through.
"""

LAUNCHES = {"collector_permute": 0, "bn_act": 0, "xent_fwd": 0,
            "xent_bwd": 0, "bucket_permute": 0, "unbucket_permute": 0,
            "quant_bucket_permute": 0, "dequant_unbucket_permute": 0,
            "rmsnorm": 0, "flash_attention": 0, "slstm_scan": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
