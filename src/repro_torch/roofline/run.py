"""Roofline runner: for each (arch x shape), dry-run the 1-unit and
2-unit depths, extrapolate, and emit the roofline table's rows as JSON
and markdown.

Usage:
  PYTHONPATH=src python -m repro_torch.roofline.run --all --out roofline.json
  PYTHONPATH=src python -m repro_torch.roofline.run --arch qwen3-8b \\
      --shape train_4k [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import traceback

from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import lower_one
from repro_torch.roofline.analysis import (
    _family_units, roofline_terms, RECOMMENDATIONS)


def roofline_pair(arch_id, shape_name, *, multi_pod=False, sfpl=False,
                  cfg_overrides=None, fsdp=True, device="cuda"):
    spec = get_arch(arch_id)
    shape = SHAPES[shape_name]
    skip = spec.skip_reason(shape)
    if skip:
        return {"arch": arch_id, "shape": shape_name, "skipped": skip}
    cfg_full = spec.make_config(**(cfg_overrides or {}))
    n_units, ov1, ov2 = _family_units(spec, cfg_full)
    base_ov = dict(cfg_overrides or {})    # the port has no scan_layers
    r1 = lower_one(arch_id, shape_name, multi_pod=multi_pod, sfpl=sfpl,
                   cfg_overrides=dict(base_ov, **ov1), fsdp=fsdp,
                   device=device)
    r2 = lower_one(arch_id, shape_name, multi_pod=multi_pod, sfpl=sfpl,
                   cfg_overrides=dict(base_ov, **ov2), fsdp=fsdp,
                   device=device)
    devices = r1["devices"]
    terms = roofline_terms(r1, r2, n_units, devices=devices, shape=shape,
                           spec=spec, cfg=cfg_full)
    out = {
        "arch": arch_id, "shape": shape_name,
        "mesh": r1["mesh"], "devices": devices, "sfpl": sfpl,
        "num_units": n_units,
        **{k: v for k, v in terms.items() if k != "coll_breakdown"},
        "coll_breakdown": terms["coll_breakdown"],
        "recommendation": RECOMMENDATIONS[terms["dominant"]],
    }
    return out


def row_md(r):
    if "skipped" in r:
        return (f"| {r['arch']} | {r['shape']} | — | — | — | — | skipped: "
                f"{r['skipped'][:40]}… | |")
    return ("| {arch} | {shape} | {c:.2e} | {m:.2e} | {l:.2e} | "
            "**{dom}** | {ratio:.2f} | {rec} |").format(
        arch=r["arch"], shape=r["shape"], c=r["compute_s"],
        m=r["memory_s"], l=r["collective_s"], dom=r["dominant"],
        ratio=r["useful_ratio"], rec=r["recommendation"][:60])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--sfpl", action="store_true")
    ap.add_argument("--out", default="roofline.json")
    ap.add_argument("--device", default="cuda",
                    help="the dry run's mesh device type (cpu without a "
                         "card)")
    args = ap.parse_args(argv)

    jobs = ([(a, s) for a in list_archs() for s in SHAPES]
            if args.all else [(args.arch, args.shape)])
    results = []
    for a, s in jobs:
        try:
            r = roofline_pair(a, s, sfpl=args.sfpl, device=args.device)
        except Exception as e:
            r = {"arch": a, "shape": s,
                 "error": f"{type(e).__name__}: {e}",
                 "traceback": traceback.format_exc()[-1500:]}
            print(f"FAIL {a} {s}: {e}", flush=True)
        results.append(r)
        if "error" not in r:
            print(row_md(r), flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
