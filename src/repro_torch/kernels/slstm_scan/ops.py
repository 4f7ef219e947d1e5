"""The sLSTM scan wrapper, forward only.

``src/repro/kernels/slstm_scan/ops.py`` is a plain ``jax.jit`` with no VJP,
so the JAX package cannot differentiate through its kernel; the port's
wrapper keeps that: its backward raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.slstm_scan import kernel, ref


class _SlstmScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre_i, pre_f, pre_z, pre_o, R):
        if pre_i.is_cuda:
            return kernel.slstm_scan(pre_i, pre_f, pre_z, pre_o, R)
        B, _, H, Dh = pre_i.shape
        hs, _ = ref.slstm_scan_ref(pre_i, pre_f, pre_z, pre_o, R,
                                   ref.initial_state(B, H, Dh, pre_i.device))
        return hs

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the sLSTM scan is forward-only: the JAX package's "
            "kernels/slstm_scan/ops.py defines no VJP for its kernel; "
            "train on the xla sLSTM path")


def slstm_scan(pre_i, pre_f, pre_z, pre_o, R):
    """pre_*: (B, S, H, Dh); R: (4, H, Dh, Dh). Returns h (B, S, H, Dh) in
    f32 from the initial state (c 0, n 1e-6, m -1e30, h 0): the kernel on
    CUDA tensors, :func:`ref.slstm_scan_ref` on CPU ones."""
    f32 = [t.float() for t in (pre_i, pre_f, pre_z, pre_o, R)]
    return _SlstmScan.apply(*f32)
