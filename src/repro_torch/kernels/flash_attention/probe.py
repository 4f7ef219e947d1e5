"""K7's device time at the LM paths' shapes, for comparing two builds of it
on one card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.probe

Times ``kernel.flash_attention`` (bf16, causal) at qwen3-8b's prefill
attention (B 4 and B 1 x S 4096, 32 over 8 heads, D 128), the same at
D 64, gemma-7b's (B 4 and B 1 x S 4096, 16/16 heads, D 256) and
recurrentgemma-9b's (B 1 x S 4096, 16 over 1 head, D 256, window 2048):
for each, a CUDA graph of 10 calls replayed 5 times, each replay between
CUDA events; prints one JSON line a shape with the fastest and the median
replay in microseconds a call, then the card's name and power limit.
Only the public ``flash_attention`` is called, so the script times any
tree's kernel: with ``PYTHONPATH=<other tree>/src python
<this tree>/src/repro_torch/kernels/flash_attention/probe.py``, run two
trees in turns (A, B, B, A) in one command to compare them. Needs one
card.
"""
from __future__ import annotations

import json
import statistics
import subprocess

import torch

from repro_torch.kernels.flash_attention import kernel as flash_k

# (name, B, S, H, K, D, window)
SHAPES = (("qwen3-8b prefill", 4, 4096, 32, 8, 128, None),
          ("qwen3-8b B 1", 1, 4096, 32, 8, 128, None),
          ("D 64", 4, 4096, 32, 8, 64, None),
          ("gemma-7b prefill", 4, 4096, 16, 16, 256, None),
          ("gemma-7b B 1", 1, 4096, 16, 16, 256, None),
          ("recurrentgemma-9b window 2048", 1, 4096, 16, 1, 256, 2048))


def replays_us(fn, calls=10, reps=5):
    """Microseconds a call of each of ``reps`` replays of a CUDA graph of
    ``calls`` calls, after 3 warm calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    out = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) * 1e3 / calls)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, b, s, h, kh, d, window in SHAPES:
        q, k, v = (torch.randn(b, s, n, d, device=dev, generator=gen)
                   .to(torch.bfloat16) for n in (h, kh, kh))
        us = replays_us(lambda: flash_k.flash_attention(
            q, k, v, causal=True, window=window))
        print(json.dumps(dict(shape=name, b=b, s=s, h=h, kh=kh, d=d,
                              window=window, us_min=min(us),
                              us_median=statistics.median(us))),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
