"""Plain PyTorch version of the fused sLSTM scan: a loop over time."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def initial_state(batch, heads, dh, device=None):
    """(c, n, m, h) at time 0, each (B, H, Dh) f32: c 0, n 1e-6, m -1e30,
    h 0."""
    zero = torch.zeros((batch, heads, dh), dtype=torch.float32,
                       device=device)
    return zero, zero + 1e-6, zero - 1e30, zero


def slstm_scan_ref(pre_i, pre_f, pre_z, pre_o, R, state0):
    """Stabilized sLSTM recurrence (xLSTM eqs.), block-diagonal per head.

    pre_*: (B, S, H, Dh) f32 input-side gate preactivations.
    R: (4, H, Dh, Dh) recurrent matrices in gate order (i, f, z, o).
    state0: (c, n, m, h) each (B, H, Dh) f32.
    Returns h_seq (B, S, H, Dh) and the final state tuple.
    """
    c, n, m, h = state0
    hs = []
    for t in range(pre_i.shape[1]):
        rec = torch.einsum("bhd,ghde->gbhe", h, R)
        i_pre = pre_i[:, t] + rec[0]
        f_pre = pre_f[:, t] + rec[1]
        z = torch.tanh(pre_z[:, t] + rec[2])
        o = torch.sigmoid(pre_o[:, t] + rec[3])
        logf = F.logsigmoid(f_pre)
        m_new = torch.maximum(logf + m, i_pre)
        i_s = torch.exp(i_pre - m_new)
        f_s = torch.exp(logf + m - m_new)
        c = f_s * c + i_s * z
        n = torch.clamp_min(f_s * n + i_s, 1e-6)
        m = m_new
        h = o * (c / n)
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, m, h)
