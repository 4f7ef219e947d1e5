"""Serving entry point of the port: batched decode with a KV cache
(transformer family), per-block recurrent states (xLSTM), recurrent
states and a local-attention ring cache (recurrentgemma), or a decoder
cache beside precomputed cross-attention K / V (whisper), the prompt
teacher-forced through the decode step token by token, then greedy or
temperature sampling.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        [--arch qwen3-8b | gemma-7b | minitron-8b | phi3-medium-14b |
         llama4-scout-17b-a16e | llama4-maverick-400b-a17b | qwen2-vl-7b |
         xlstm-1.3b | recurrentgemma-9b | whisper-large-v3] [--batch 4] \
        [--prompt-len 16] [--gen 16] [--full] [--device cpu]

The smoke config by default, the architecture's full width with
``--full`` (the llama4 models' 107.8 B and 400.7 B parameters fit no
single card). The prompt is text: qwen2-vl-7b decodes without vision
embeddings, as the JAX package's serve does; whisper first encodes
``WHISPER_FRAMES`` frame embeddings drawn from the seed and fills each
layer's cross-attention K / V from them, and its prompt and generated
tokens together must fit its learned positions. Parameters are drawn
from ``--seed`` on the device itself (no weights are loaded), prompts,
frames and samples from a ``torch.Generator`` of the same seed. It runs
on CUDA unless ``--device cpu`` is given, and raises when CUDA is absent
and no device was asked for.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step

# frames whisper encodes before decoding, as the JAX package's serve does
WHISPER_FRAMES = 8


def sample(logits, temperature, gen):
    """Next tokens (B, 1) from last-position logits (B, V): argmax at
    temperature 0, else a draw from ``softmax(logits / temperature)``."""
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)
    return logits.argmax(dim=-1, keepdim=True)


def serve(arch_id, *, batch=4, prompt_len=16, gen=16, smoke=True,
          temperature=0.0, seed=0, device=None):
    """Decode ``gen`` tokens after random prompts of ``prompt_len`` for a
    batch of ``batch``. Returns the generated tokens (batch, gen) int64."""
    dev = resolve_device(device)
    spec = get_arch(arch_id)
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    model = spec.model
    rng = torch.Generator(device=dev).manual_seed(seed)
    max_len = prompt_len + gen
    with torch.inference_mode():
        params = model.init(rng, cfg)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                generator=rng, device=dev)
        if spec.family == "whisper":
            frames = torch.randn((batch, WHISPER_FRAMES, cfg.d_model),
                                 generator=rng, device=dev)
            state = model.init_decode_state(cfg, batch, max_len,
                                            dtype=torch.float32,
                                            enc_frames=WHISPER_FRAMES,
                                            device=dev)
            state = model.prefill_cross(params, model.encode(
                params, frames, cfg), state, cfg)
        else:
            # the xLSTM's recurrent state ignores max_len and dtype
            state = model.init_decode_state(cfg, batch, max_len,
                                            dtype=torch.float32, device=dev)
        decode = make_decode_step(spec, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = []
        for t in range(max_len - 1):
            cur = prompts[:, t:t + 1] if t < prompt_len else out[-1]
            logits, state = decode(params, state, cur, t)
            if t >= prompt_len - 1:
                out.append(sample(logits[:, -1], temperature, rng))
        gen_toks = torch.cat(out, dim=1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{arch_id} ({'smoke' if smoke else 'full'} config): decoded "
          f"{tuple(gen_toks.shape)} in {dt:.2f}s "
          f"({batch * gen / dt:.1f} tok/s, {max_len - 1} decode steps, "
          f"{dt / (max_len - 1) * 1e3:.1f} ms/step, on {where})")
    return gen_toks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="the architecture's full width, not the smoke "
                         "config")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default the card")
    args = ap.parse_args(argv)
    serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
          gen=args.gen, smoke=not args.full, temperature=args.temperature,
          seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
