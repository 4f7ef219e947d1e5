"""phi3-medium-14b [dense] — [arXiv:2404.14219].

40L, d_model 5120, 40 heads (GQA kv=10), d_ff 17920, vocab 100352.
RoPE, SwiGLU, GQA, untied embeddings.
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.common import TransformerConfig


def make_config(**kw):
    base = dict(
        name="phi3-medium-14b", num_layers=40, d_model=5120, num_heads=40,
        num_kv_heads=10, head_dim=128, d_ff=17920, vocab_size=100352,
        act="silu", rope_theta=10000.0, tie_embeddings=False)
    base.update(kw)
    return TransformerConfig(**base)


def make_smoke_config(**kw):
    return make_config(num_layers=2, d_model=256, num_heads=4,
                       num_kv_heads=2, head_dim=64, d_ff=512,
                       vocab_size=512, remat=False, **kw)


ARCH = register(ArchSpec(
    arch_id="phi3-medium-14b", family="transformer",
    citation="arXiv:2404.14219",
    make_config=make_config, make_smoke_config=make_smoke_config,
    supports_long_context=False, notes="RoPE SwiGLU GQA"))
