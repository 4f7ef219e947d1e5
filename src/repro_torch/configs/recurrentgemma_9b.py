"""recurrentgemma-9b [hybrid] — [arXiv:2402.19427].

38L, d_model 4096, 16 heads local-MQA (kv=1), head_dim 256, d_ff 12288,
vocab 256000. Griffin pattern (rec, rec, attn) — 12 triples + 2 trailing
recurrent blocks. RG-LRU via associative scan; local attention window 2048.
Sub-quadratic: runs long_500k (state = O(window) + O(rnn_width)).
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.rglru import RGLRUConfig


def make_config(**kw):
    base = dict(
        name="recurrentgemma-9b", num_layers=38, d_model=4096,
        num_heads=16, num_kv_heads=1, head_dim=256, d_ff=12288,
        vocab_size=256000, window=2048, conv_kernel=4)
    base.update(kw)
    return RGLRUConfig(**base)


def make_smoke_config(**kw):
    return make_config(num_layers=5, d_model=128, num_heads=2,
                       num_kv_heads=1, head_dim=64, d_ff=256,
                       vocab_size=512, window=8, remat=False, **kw)


ARCH = register(ArchSpec(
    arch_id="recurrentgemma-9b", family="rglru",
    citation="arXiv:2402.19427",
    make_config=make_config, make_smoke_config=make_smoke_config,
    supports_long_context=True,
    notes="RG-LRU + local attention 1:2; MQA kv=1"))
