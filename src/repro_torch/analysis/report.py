"""Render the dry run's tables (fit, then roofline) from its JSON rows.

    PYTHONPATH=src python -m repro_torch.analysis.report --dir experiments/dryrun

The reference's tables, row for row; the roofline header names the
H100 constants of `roofline`.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .roofline import HBM_BW, LINK_BW, PEAK_BF16

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_rows(directory: str, tag: str = "") -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        name = os.path.basename(path)
        if tag and not name.startswith(tag + "_"):
            continue
        if not tag and "__" in name and name.split("__")[0] not in ("single", "multi"):
            continue
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(rows: list[dict], mesh: str) -> str:
    lines = [
        f"### Roofline — {mesh}-pod mesh "
        f"({'512' if mesh == 'multi' else '256'} GPUs, H100 SXM: "
        f"{PEAK_BF16 / 1e12:.0f} TF bf16 / {HBM_BW / 1e12:.2f} TB/s HBM / "
        f"{LINK_BW / 1e9:.0f} GB/s link)",
        "",
        "| arch | shape | compute | memory | collective | dominant | "
        "HBM GiB/dev | MODEL/HLO FLOPs | note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    sel = [r for r in rows if r.get("mesh") == mesh]
    sel.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])))
    for r in sel:
        if r.get("status") == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | skipped | — | — | "
                f"{r['reason'][:60]}... |"
            )
            continue
        if r.get("status") != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | ERROR | — | — | "
                f"{r.get('error', '')[:60]} |"
            )
            continue
        rl = r["roofline"]
        mem = r.get("memory", {}).get("total_per_device_gib", float("nan"))
        note = _improvement_note(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(rl['compute_s'])} | "
            f"{_fmt_s(rl['memory_s'])} | {_fmt_s(rl['collective_s'])} | "
            f"**{rl['dominant']}** | {mem:.1f} | {rl['useful_ratio']:.2f} | {note} |"
        )
    return "\n".join(lines)


def _improvement_note(r: dict) -> str:
    rl = r["roofline"]
    dom = rl["dominant"]
    kinds = r["costs"]["coll_by_kind"]
    if dom == "collective":
        top = max(kinds, key=kinds.get)
        return f"cut {top} bytes (sharding/overlap)"
    if dom == "memory":
        if r["shape"].startswith("decode") or r["shape"].startswith("long"):
            return "KV/weight reads dominate: quantize cache or widen batch"
        return "activation re-reads: fuse / better remat policy"
    return "compute-bound: near roofline already"


def dryrun_table(rows: list[dict], mesh: str) -> str:
    lines = [
        f"### Dry-run — {mesh}-pod mesh: compile + fit",
        "",
        "| arch | shape | status | compile s | args GiB/dev | temp GiB/dev | "
        "collectives (scan graph) |",
        "|---|---|---|---|---|---|---|",
    ]
    sel = [r for r in rows if r.get("mesh") == mesh]
    sel.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])))
    for r in sel:
        if r.get("status") == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | skipped | — | — | — | — |")
            continue
        if r.get("status") != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | ERROR | — | — | — | "
                f"{r.get('error','')[:50]} |"
            )
            continue
        m = r.get("memory", {})
        counts = r.get("scan_graph_costs", {}).get("coll_counts", {})
        cstr = " ".join(f"{k}:{v}" for k, v in counts.items() if v)
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r.get('compile_s','—')} | "
            f"{m.get('args_bytes', 0)/2**30:.2f} | "
            f"{m.get('temp_bytes', 0)/2**30:.2f} | {cstr or '—'} |"
        )
    return "\n".join(lines)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default="experiments/dryrun")
    p.add_argument("--tag", default="")
    args = p.parse_args()
    rows = load_rows(args.dir, args.tag)
    for mesh in ("single", "multi"):
        print(dryrun_table(rows, mesh))
        print()
    for mesh in ("single", "multi"):
        print(roofline_table(rows, mesh))
        print()


if __name__ == "__main__":
    main()
