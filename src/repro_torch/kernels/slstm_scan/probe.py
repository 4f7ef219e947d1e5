"""What each part of K8's step costs, measured on the card.

    PYTHONPATH=src python -m repro_torch.kernels.slstm_scan.probe

Builds ``csrc/slstm_scan.cu`` as shipped and once for each measurement
variant below (its ``SFPL_SLSTM_*`` macros; one ``nvcc`` each, all at
once), then times every build at xlstm-1.3b's prefill shape (B 4, S 4096,
H 4, Dh 512, f32) on the plan the card gives that build: a CUDA graph of 2
calls replayed twice, the builds in turn, twice over. Prints, for each,
microseconds a step (time / S), registers, dynamic shared memory, units a
slice and the max error against the plain version. The variants that drop
a part of the step (no products, no wait, no exchange) give wrong answers
by design: they time what is left. Needs one card.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys

import torch

from repro_torch.kernels import build
from repro_torch.kernels.slstm_scan import kernel as slstm_k
from repro_torch.kernels.slstm_scan import ref as slstm_ref

SHAPE = (4, 4096, 4, 512)
VARIANTS = {
    "as built": {},
    "no products": {"SFPL_SLSTM_PROBE": 1},
    "reads h once, no wait": {"SFPL_SLSTM_PROBE": 2},
    "no exchange": {"SFPL_SLSTM_PROBE": 8},
    "no products, no exchange": {"SFPL_SLSTM_PROBE": 9},
    "counter exchange": {"SFPL_SLSTM_PROBE": 4},
    "R in shared memory alone": {"SFPL_SLSTM_REG_ROWS": 0},
    "32 register rows": {"SFPL_SLSTM_REG_ROWS": 32},
    "64 register rows, none ahead": {"SFPL_SLSTM_REG_ROWS": 64,
                                     "SFPL_SLSTM_AHEAD": 0},
    "64 register rows, 1 ahead": {"SFPL_SLSTM_REG_ROWS": 64,
                                  "SFPL_SLSTM_AHEAD": 1},
}


def graph_ms(fn, calls=2, reps=2):
    """Device time of one call: ``calls`` calls captured in a CUDA graph,
    replayed ``reps`` times between CUDA events, after 3 warm calls."""
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
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * reps)


def spills(log):
    """Spill stores of the sliced kernel in each build's ptxas report,
    keyed by the build's extra flags ('' for the default build)."""
    out = {}
    for part in log.split("== slstm_scan.cu")[1:]:
        head, _, body = part.partition("\n")
        m = re.search(r"slstm_scan_sliced\S*\n\s*(\d+) bytes stack frame, "
                      r"(\d+) bytes spill stores", body)
        if m:
            out[head.strip()] = int(m.group(2))
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("probe: needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    libs, log = build.variants("slstm_scan", list(VARIANTS.values()))
    libs = [slstm_k.bind(lib) for lib in libs]
    spilled = spills(log)
    b, s, h, dh = SHAPE
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    pres = [torch.randn(b, s, h, dh, device=dev, generator=gen)
            for _ in range(4)]
    R = torch.randn(4, h, dh, dh, device=dev, generator=gen) * dh ** -0.5
    want, _ = slstm_ref.slstm_scan_ref(*pres, R, slstm_ref.initial_state(
        b, h, dh, dev))
    rows = {}
    for name, lib in zip(VARIANTS, libs):
        got = slstm_k.slstm_scan(*pres, R, lib=lib)
        pl = slstm_k.card_plan(b, h, dh, 0, lib)
        res = slstm_k.resources(pl.smem, 0, lib)
        extra = " ".join(f"-D{k}={v}" for k, v in VARIANTS[name].items())
        rows[name] = dict(
            defines=VARIANTS[name],
            max_abs_err=(got - want).abs().max().item(),
            registers=res["registers"], spill_bytes=spilled.get(extra),
            smem=pl.smem, units=pl.units, launches=len(pl.launches),
            us_a_step=[])
    for _ in range(2):
        for name, lib in zip(VARIANTS, libs):
            ms = graph_ms(lambda: slstm_k.slstm_scan(*pres, R, lib=lib))
            rows[name]["us_a_step"].append(ms / s * 1e3)
    base = min(rows["as built"]["us_a_step"])
    for name, row in rows.items():
        us = min(row["us_a_step"])
        print(f"{name:32s} {us:7.3f} us a step ({us - base:+.3f}), "
              f"err {row['max_abs_err']:.2e}, {row['registers']} registers, "
              f"{row['spill_bytes']} B spilled, {row['smem']} B shared, "
              f"{row['units']} units")
    print(json.dumps({"shape": SHAPE, "variants": rows}))


if __name__ == "__main__":
    main()
