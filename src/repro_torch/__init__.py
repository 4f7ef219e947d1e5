"""PyTorch port of the SFPL system for one NVIDIA H100.

Mirrors the layout of the JAX package ``repro`` (``nn/``, ``models/``,
``optim/``, ``core/``, ``data/``, ``metrics/``, ``configs/``,
``kernels/``, ``launch/``) and imports nothing from it. Public functions
keep the JAX package's NHWC activation layout and parameter-tree keys, so
the two can be compared on the same inputs (``repro_torch.convert``
carries weights and state across). Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""
