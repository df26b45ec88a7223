"""Render the dry run's roofline tables from its JSON records (the
reference's `repro/roofline/report.py`, on the port's records:
launch/dryrun.py writes the reference's record format).

  PYTHONPATH=src python -m repro_torch.roofline.report dryrun_all.json
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List


def fmt(x, digits=3):
    if x is None:
        return "-"
    if isinstance(x, str):
        return x
    if x == 0:
        return "0"
    return f"{x:.{digits}g}"


def roofline_table(records: List[Dict], multi_pod: bool = False) -> str:
    rows = []
    head = ("| arch | shape | compute s | memory s | collective s | bound | "
            "model GFLOPs/chip | useful/HLO | roofline frac | note |")
    sep = "|" + "---|" * 10
    rows.append(head)
    rows.append(sep)
    for r in records:
        if r.get("multi_pod", False) != multi_pod:
            continue
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | - | - | - | - | - "
                        f"| - | - | SKIP: {r['reason'][:60]} |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | - | - | - | - | - "
                        f"| - | - | ERROR |")
            continue
        ro = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt(ro['compute_s'])} | "
            f"{fmt(ro['memory_s'])} | {fmt(ro['collective_s'])} | "
            f"{ro['bound']} | "
            f"{fmt(ro.get('model_flops_per_chip', 0) / 1e9)} | "
            f"{fmt(ro.get('useful_flops_frac'))} | "
            f"{fmt(ro.get('roofline_frac'))} | |")
    return "\n".join(rows)


def compile_table(records: List[Dict]) -> str:
    rows = ["| arch | shape | 16x16 | 2x16x16 |", "|---|---|---|---|"]
    by_cell: Dict = {}
    for r in records:
        key = (r["arch"], r["shape"])
        by_cell.setdefault(key, {})[r.get("multi_pod", False)] = r
    for (a, s), d in by_cell.items():
        def st(mp):
            r = d.get(mp)
            if r is None:
                return "-"
            if r["status"] == "ok":
                return f"ok ({r.get('compile_s', 0):.0f}s)"
            if r["status"] == "skipped":
                return "skip"
            return "ERROR"
        rows.append(f"| {a} | {s} | {st(False)} | {st(True)} |")
    return "\n".join(rows)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "dryrun_all.json"
    with open(path) as f:
        records = json.load(f)
    print("## Single-pod (16x16) roofline\n")
    print(roofline_table(records, multi_pod=False))
    print("\n## Compile matrix\n")
    print(compile_table(records))


if __name__ == "__main__":
    main()
