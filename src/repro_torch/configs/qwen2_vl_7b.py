"""qwen2-vl-7b [vlm] — [arXiv:2409.12191].

28L, d_model 3584, 28 heads (GQA kv=4), d_ff 18944, vocab 152064.
M-RoPE (temporal/height/width sections 16/24/24), qkv bias, SwiGLU.
Vision frontend is a STUB per the harness carve-out: the caller supplies
precomputed patch embeddings (B, vision_tokens, d_model) as
``vision_embeds``, merged after BOS.
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.common import TransformerConfig


def make_config(**kw):
    base = dict(
        name="qwen2-vl-7b", num_layers=28, d_model=3584, num_heads=28,
        num_kv_heads=4, head_dim=128, d_ff=18944, vocab_size=152064,
        act="silu", attn_bias=True, rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24), vision_tokens=1024,
        tie_embeddings=False)
    base.update(kw)
    return TransformerConfig(**base)


def make_smoke_config(**kw):
    return make_config(num_layers=2, d_model=256, num_heads=4,
                       num_kv_heads=2, head_dim=64, d_ff=512,
                       vocab_size=512, mrope_sections=(16, 8, 8),
                       vision_tokens=16, remat=False, **kw)


ARCH = register(ArchSpec(
    arch_id="qwen2-vl-7b", family="transformer",
    citation="arXiv:2409.12191",
    make_config=make_config, make_smoke_config=make_smoke_config,
    supports_long_context=False,
    notes="M-RoPE + dynamic-resolution vision (stub frontend)"))
