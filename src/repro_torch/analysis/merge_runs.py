"""Merge delta-only cost rows into full dry-run rows.

Production-graph artifacts (compile check, memory analysis, collective
schedule) are invariant to the cost-extraction method; this script takes
the corrected delta costs/roofline from a `--skip-production --tag delta`
run and grafts them onto the rows that carry the production fields.

    PYTHONPATH=src python -m repro_torch.analysis.merge_runs \
        --full experiments/dryrun --delta experiments/dryrun_delta --tag delta
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--full", default="experiments/dryrun")
    p.add_argument("--delta", default="experiments/dryrun_delta")
    p.add_argument("--tag", default="delta")
    args = p.parse_args()
    merged = 0
    for path in sorted(glob.glob(os.path.join(args.delta, f"{args.tag}_*.json"))):
        name = os.path.basename(path)[len(args.tag) + 1 :]
        full_path = os.path.join(args.full, name)
        with open(path) as f:
            delta = json.load(f)
        if delta.get("status") != "ok":
            continue
        full = {}
        if os.path.exists(full_path):
            with open(full_path) as f:
                full = json.load(f)
        out = dict(full) if full.get("status") == "ok" else {}
        out.update(delta)  # corrected costs/roofline win
        for key in ("memory", "compile_s", "scan_graph_costs"):
            if key in full:
                out[key] = full[key]
        with open(full_path, "w") as f:
            json.dump(out, f, indent=1)
        merged += 1
    print(f"merged {merged} rows into {args.full}")


if __name__ == "__main__":
    main()
