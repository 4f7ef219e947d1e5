"""qwen3-8b [dense] — [hf:Qwen/Qwen3-8B].

36L, d_model 4096, 32 heads (GQA kv=8), d_ff 12288, vocab 151936.
QK-RMSNorm on per-head q/k, SwiGLU, RoPE theta 1e6, untied embeddings.
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.common import TransformerConfig


def make_config(**kw):
    base = dict(
        name="qwen3-8b", num_layers=36, d_model=4096, num_heads=32,
        num_kv_heads=8, head_dim=128, d_ff=12288, vocab_size=151936,
        act="silu", qk_norm=True, rope_theta=1_000_000.0,
        tie_embeddings=False)
    base.update(kw)
    return TransformerConfig(**base)


def make_smoke_config(**kw):
    return make_config(num_layers=2, d_model=256, num_heads=4,
                       num_kv_heads=2, head_dim=64, d_ff=512,
                       vocab_size=512, remat=False, **kw)


ARCH = register(ArchSpec(
    arch_id="qwen3-8b", family="transformer",
    citation="hf:Qwen/Qwen3-8B",
    make_config=make_config, make_smoke_config=make_smoke_config,
    supports_long_context=False, notes="qk_norm + GQA"))
