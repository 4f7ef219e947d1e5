"""llama4-scout-17b-a16e [moe] — [hf:meta-llama/Llama-4-Scout-17B-16E].

48L, d_model 5120, 40 heads (GQA kv=8), expert d_ff 8192, vocab 202048.
MoE: 16 experts, top-1 + shared expert, on EVERY layer. Same iRoPE
3-local:1-global attention pattern as maverick.
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.common import TransformerConfig


def make_config(**kw):
    base = dict(
        name="llama4-scout-17b-a16e", num_layers=48, d_model=5120,
        num_heads=40, num_kv_heads=8, head_dim=128, d_ff=8192,
        vocab_size=202048, act="silu", rope_theta=500_000.0,
        tie_embeddings=False, num_experts=16, moe_layer_period=1,
        moe_shared_expert=True, sliding_window=8192, global_attn_period=4)
    base.update(kw)
    return TransformerConfig(**base)


def make_smoke_config(**kw):
    return make_config(num_layers=2, d_model=256, num_heads=4,
                       num_kv_heads=2, head_dim=64, d_ff=512,
                       vocab_size=512, num_experts=4, sliding_window=8,
                       global_attn_period=2, remat=False, **kw)


ARCH = register(ArchSpec(
    arch_id="llama4-scout-17b-a16e", family="transformer",
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    make_config=make_config, make_smoke_config=make_smoke_config,
    supports_long_context=True,
    notes="MoE 16e top-1 every layer; iRoPE 3-local:1-global"))
