"""xlstm-1.3b [ssm] — [arXiv:2405.04517].

48 blocks, d_model 2048, 4 heads, vocab 50304, no separate FFN (the
capacity lives in the blocks' up/down projections). 7:1 mLSTM:sLSTM ratio
(one sLSTM per 8 blocks, 6 in all). Sub-quadratic: the recurrent decode
state is O(1) in the sequence length.
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.xlstm import XLSTMConfig


def make_config(**kw):
    base = dict(
        name="xlstm-1.3b", num_layers=48, d_model=2048, num_heads=4,
        vocab_size=50304, proj_factor=2.0, slstm_every=8, conv_kernel=4,
        chunk_len=256)
    base.update(kw)
    return XLSTMConfig(**base)


def make_smoke_config(**kw):
    return make_config(num_layers=2, d_model=128, num_heads=2,
                       vocab_size=512, slstm_every=2, chunk_len=8, **kw)


ARCH = register(ArchSpec(
    arch_id="xlstm-1.3b", family="xlstm",
    citation="arXiv:2405.04517",
    make_config=make_config, make_smoke_config=make_smoke_config,
    supports_long_context=True,
    notes="sLSTM sequential scan + mLSTM chunkwise-parallel"))
