"""gemma-7b [dense] — [arXiv:2403.08295].

28L, d_model 3072, 16 heads (kv=16, i.e. MHA at 7B; MQA is the 2B variant),
head_dim 256 (qkv dim 4096 > d_model — gemma's unusual wide-head layout),
d_ff 24576, GeGLU, vocab 256000, tied embeddings, sqrt(d) embedding scaling,
(1+scale) RMSNorm convention.
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.common import TransformerConfig


def make_config(**kw):
    base = dict(
        name="gemma-7b", num_layers=28, d_model=3072, num_heads=16,
        num_kv_heads=16, head_dim=256, d_ff=24576, vocab_size=256000,
        act="gelu", rope_theta=10000.0, tie_embeddings=True,
        embed_scale=True, norm_scale_offset=1.0)
    base.update(kw)
    return TransformerConfig(**base)


def make_smoke_config(**kw):
    return make_config(num_layers=2, d_model=256, num_heads=4,
                       num_kv_heads=4, head_dim=64, d_ff=512,
                       vocab_size=512, remat=False, **kw)


ARCH = register(ArchSpec(
    arch_id="gemma-7b", family="transformer",
    citation="arXiv:2403.08295",
    make_config=make_config, make_smoke_config=make_smoke_config,
    supports_long_context=False,
    notes="GeGLU, head_dim=256, tied embeddings, embed scaling"))
