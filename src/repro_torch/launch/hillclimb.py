"""Re-run a dry-run cell under named sets of optimization levers and
record the roofline terms of each (the reference's
`repro/launch/hillclimb.py`).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \
      --cell gemma3-4b:train_4k --variants baseline,remat_none,cp \
      [--device meta] [--out hillclimb.json]

A variant is a comma-separated entry; "+" composes levers left to right.
The levers are the reference's. Those that change the port's program:
remat, fused_xent, context_parallel_attn and the AltUp ones (_altup,
_recycled). banded_local_attn and moe_out_pin are read by neither
package, and mla_attn_pins is a sharding hint of the reference's XLA
program that the port does not read: their variants count the
baseline's program.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Sequence

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

# named lever sets (hypothesis -> config delta); composed left to right
LEVERS = {
    "baseline": {},
    "remat_dots": {"remat": "dots"},
    "remat_none": {"remat": "none"},
    "fused_xent": {"fused_xent": True},
    "banded": {"banded_local_attn": True},
    "cp": {"context_parallel_attn": True},
    "moe_out_pin": {"moe_out_pin": True},
    "mla_pins": {"mla_attn_pins": True},
    "altup2": {"_altup": 2},
    "altup2_recycled": {"_altup": 2, "_recycled": True},
    "altup2_full_emb": {"_altup": 2, "_recycled": False},
}


def lever_config(arch: str, levers: Sequence[str], *, smoke: bool = False):
    """(config, altup K, remat) of `arch` with `levers` applied, left to
    right. smoke: the architecture's SMOKE config."""
    altup_k, recycled, remat, cfg_kw = 0, None, "full", {}
    for lv in levers:
        for k, v in LEVERS[lv].items():
            if k == "_altup":
                altup_k = v
            elif k == "_recycled":
                recycled = v
            elif k == "remat":
                remat = v
            else:
                cfg_kw[k] = v
    cfg = get_config(arch, smoke=smoke, altup_k=altup_k, recycled=recycled)
    return (cfg.replace(**cfg_kw) if cfg_kw else cfg), altup_k, remat


def run_variant(arch: str, shape_name: str, levers: Sequence[str], *,
                multi_pod: bool = False, device="meta",
                smoke: bool = False) -> Dict:
    """The dry-run record of the cell with `levers` applied: memory, the
    solved totals and bodies, the roofline terms (and the card's memory
    with device "cuda"). smoke: the architecture's SMOKE config at the
    shape's full batch and sequence (quick on meta). Raises when the
    cell does not count."""
    cfg, altup_k, remat = lever_config(arch, levers, smoke=smoke)
    rec = dryrun.run_cell(arch, shape_name, multi_pod=multi_pod,
                          altup_k=altup_k, remat=remat, device=device,
                          cfg=cfg, verbose=False)
    if rec["status"] != "ok":
        raise RuntimeError(rec.get("error") or rec.get("reason"))
    out = {"arch": arch, "shape": shape_name, "levers": list(levers),
           "remat": remat, "compile_s": rec["compile_s"],
           "memory": rec["memory"], "cost": rec["cost"]["totals"],
           "bodies": rec["cost"]["bodies"], "roofline": rec["roofline"]}
    for k in ("status_card", "memory_card", "error_card"):
        if k in rec:
            out[k] = rec[k]
    r = out["roofline"]
    print(f"[{arch} x {shape_name}] {'+'.join(levers):30s} "
          f"compute={r['compute_s']:.3e} memory={r['memory_s']:.3e} "
          f"collective={r['collective_s']:.3e} bound={r['bound']} "
          f"frac={r.get('roofline_frac', 0):.4f}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variants", required=True,
                    help="comma list; '+' composes levers")
    ap.add_argument("--device", default="cuda", choices=("cuda", "meta"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    resolve_device(args.device)         # no card: raises before any cell
    arch, shape = args.cell.split(":")
    results, failed = [], 0
    for var in args.variants.split(","):
        levers = var.split("+")
        try:
            results.append(run_variant(arch, shape, levers,
                                       device=args.device))
        except Exception as e:  # noqa: BLE001 — record it, keep going
            import traceback
            failed += 1
            print(f"[ERR] {var}: {e}", flush=True)
            results.append({"levers": levers, "status": "error",
                            "error": str(e),
                            "traceback": traceback.format_exc()[-1500:]})
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
