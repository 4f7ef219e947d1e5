"""trinity-mini [afmoe] — [hf:arcee-ai/Trinity-Mini], 26B-A3B.

32L, d_model 2048, 32 heads (GQA kv=4) of 128, vocab 200192, untied
embeddings scaled by sqrt(d_model) (muP). Layers 0-1 dense SwiGLU of
6144; layers 2-31 MoE: sigmoid scores over 128 experts of 1024, top-8
by score plus a non-gradient expert bias (aux-loss-free balancing at
rate 0.001), the weights normalised to sum 1 and scaled by 2.826,
dropless, and one shared expert. Layer i is full attention without RoPE
where (i + 1) % 4 == 0, else a 2048-key window with RoPE (theta 1e4);
qk-norm, a sigmoid gate on the attention's output, and RMSNorms before
and after both the attention and the FFN (eps 1e-5).

``experts_held`` is expert parallelism's share: a device holds and
computes the experts ``[offset, offset + count)`` and routes over all
128 (``nn.moe.moe_dropless_apply``).
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.common import AfmoeConfig


def make_config(**kw):
    base = dict(
        name="trinity-mini", num_layers=32, d_model=2048, num_heads=32,
        num_kv_heads=4, head_dim=128, d_ff=1024, d_ff_dense=6144,
        vocab_size=200192, act="silu", qk_norm=True, rope_theta=10_000.0,
        norm_eps=1e-5, embed_scale=True, tie_embeddings=False,
        num_experts=128, num_dense_layers=2, moe_shared_expert=True,
        router_aux_coef=0.0, moe_top_k=8, route_scale=2.826,
        expert_bias_rate=0.001, sliding_window=2048, global_attn_period=4)
    base.update(kw)
    return AfmoeConfig(**base)


def make_smoke_config(**kw):
    base = dict(num_layers=6, d_model=64, num_heads=4, num_kv_heads=2,
                head_dim=16, d_ff=32, d_ff_dense=96, vocab_size=256,
                num_experts=8, moe_top_k=2, sliding_window=4, remat=False)
    base.update(kw)
    return make_config(**base)


ARCH = register(ArchSpec(
    arch_id="trinity-mini", family="transformer",
    citation="hf:arcee-ai/Trinity-Mini",
    make_config=make_config, make_smoke_config=make_smoke_config,
    supports_long_context=True,
    notes="afmoe: 2 dense + MoE 128e top-8 sigmoid dropless + shared; "
          "3 window (RoPE) : 1 full (no RoPE); gated attention; "
          "sandwich norms"), own=True)
