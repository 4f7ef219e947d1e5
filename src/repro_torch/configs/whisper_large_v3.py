"""whisper-large-v3 [audio] — [arXiv:2212.04356].

32 layers per side (encoder + decoder), d_model 1280, 20 heads, d_ff 5120,
vocab 51866. Conv/mel frontend is a STUB: frame embeddings stand in for
its output. The decoder's learned positions end at max_target_positions
(448); the port raises past them. long_500k is skipped (30s-audio
decoder, architecturally meaningless).
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.whisper import WhisperConfig


def make_config(**kw):
    base = dict(
        name="whisper-large-v3", num_layers=32, d_model=1280, num_heads=20,
        num_kv_heads=20, head_dim=64, d_ff=5120, vocab_size=51866,
        max_source_positions=1500, max_target_positions=448)
    base.update(kw)
    return WhisperConfig(**base)


def make_smoke_config(**kw):
    return make_config(num_layers=2, d_model=128, num_heads=4,
                       num_kv_heads=4, head_dim=32, d_ff=256,
                       vocab_size=512, max_source_positions=32,
                       max_target_positions=32, remat=False, **kw)


ARCH = register(ArchSpec(
    arch_id="whisper-large-v3", family="whisper",
    citation="arXiv:2212.04356",
    make_config=make_config, make_smoke_config=make_smoke_config,
    supports_long_context=False,
    notes="enc-dec; conv frontend stubbed to frame embeddings"))
