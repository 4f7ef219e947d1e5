"""minitron-8b [dense] — pruned Nemotron-4 [arXiv:2407.14679].

32L, d_model 4096, 32 heads (GQA kv=8), d_ff 16384, vocab 256000.
Nemotron family: squared-ReLU MLP (ungated), RoPE, untied embeddings.
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.common import TransformerConfig


def make_config(**kw):
    base = dict(
        name="minitron-8b", num_layers=32, d_model=4096, num_heads=32,
        num_kv_heads=8, head_dim=128, d_ff=16384, vocab_size=256000,
        act="relu2", rope_theta=10000.0, tie_embeddings=False)
    base.update(kw)
    return TransformerConfig(**base)


def make_smoke_config(**kw):
    return make_config(num_layers=2, d_model=256, num_heads=4,
                       num_kv_heads=2, head_dim=64, d_ff=512,
                       vocab_size=512, remat=False, **kw)


ARCH = register(ArchSpec(
    arch_id="minitron-8b", family="transformer",
    citation="arXiv:2407.14679",
    make_config=make_config, make_smoke_config=make_smoke_config,
    supports_long_context=False,
    notes="squared-ReLU ungated MLP (width-pruned nemotron)"))
