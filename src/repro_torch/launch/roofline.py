"""Roofline analysis (``repro/launch/roofline.py``, ported): a three-term
roofline per (arch x shape) record.

    compute    = FLOPs / (chips x PEAK_FLOPS)
    memory     = HBM bytes / (chips x HBM_BW)
    collective = per-device link bytes / LINK_BW

Only the constants differ from the reference, which holds a 256-chip
v5e pod: here the peaks are one NVIDIA H100 SXM5's from its data sheet
(the card the port runs on, H100 80GB HBM3 at 700 W): 989 TFLOP/s
dense bf16, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s each way; and the chip
count comes from the record's ``chips`` (default 1) instead of a
constant.  FLOPs and bytes come from the analytic cost model
(``launch/costs.py``) under the record's ``analytic``; the collective
term reads ``collectives.total`` (0 on one card).  The record keys are
the reference's.

Emits the markdown table of the records in a directory:

    python -m repro_torch.launch.roofline [--dir DIR] [--md out.md] \
        [--mesh NAME]
"""

from __future__ import annotations

import argparse
import json
import pathlib

PEAK_FLOPS = 989e12  # dense bf16 per card (H100 SXM5 data sheet)
HBM_BW = 3.35e12  # bytes/s per card (HBM3)
LINK_BW = 450e9  # bytes/s per card each way (NVLink 4)

NOTES = {
    "compute": ("compute-bound: raise per-chip math utilization "
                "(larger per-chip tiles, fewer pad/replica FLOPs)"),
    "memory": ("HBM-bound: cut bytes/step (compressed/smaller KV cache, "
               "fused reads, lower-precision cache)"),
    "collective": ("collective-bound: reshard to remove per-layer "
                   "gathers (group-local MoE dispatch, head-sharded "
                   "attention, batch-only activations)"),
}


def analyze(rec: dict) -> dict:
    a = rec["analytic"]
    coll = rec.get("collectives", {}).get("total",
                                          rec["collectives_full"]["total"])
    chips = rec.get("chips", 1)
    t_comp = a["flops"] / (chips * PEAK_FLOPS)
    t_mem = a["hbm_bytes"] / (chips * HBM_BW)
    t_coll = coll / LINK_BW  # already per-device traffic
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "objective": rec.get("objective"),
        "compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll,
        "dominant": dom,
        "roofline_fraction": t_comp / bound if bound else 0.0,
        "model_flops": a["model_flops"],
        "useful_ratio": a["model_flops"] / a["flops"] if a["flops"] else 0.0,
        "xla_flops": rec.get("xla_cost", {}).get("flops"),
        "note": NOTES[dom],
        "peak_bytes_per_dev": rec.get("memory", {}).get(
            "peak_memory_in_bytes"),
        "temp_bytes_per_dev": rec.get("memory", {}).get(
            "temp_size_in_bytes"),
    }


def fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--md", default=None)
    ap.add_argument("--mesh", default="pod16x16")
    args = ap.parse_args()

    rows, skips, errs = [], [], []
    for p in sorted(pathlib.Path(args.dir).glob(f"*__{args.mesh}.json")):
        rec = json.loads(p.read_text())
        if rec.get("status") == "skipped":
            skips.append((rec["arch"], rec["shape"], rec["reason"]))
        elif rec.get("status") == "error":
            errs.append((rec["arch"], rec["shape"], rec.get("error")))
        else:
            rows.append(analyze(rec))

    lines = [
        "| arch | shape | objective | compute | memory | collective |"
        " dominant | MODEL/HLO | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['objective']} "
            f"| {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} "
            f"| {fmt_s(r['collective_s'])} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.2%} |")
    if skips:
        lines.append("")
        lines.append("Skipped (per spec):")
        for a, s, why in skips:
            lines.append(f"* {a} × {s} — {why}")
    if errs:
        lines.append("")
        for a, s, e in errs:
            lines.append(f"* ERROR {a} × {s}: {e}")

    out = "\n".join(lines)
    print(out)
    if args.md:
        pathlib.Path(args.md).write_text(out + "\n")

    # hillclimb candidates
    if rows:
        worst = min(rows, key=lambda r: r["roofline_fraction"])
        collb = max(rows, key=lambda r: r["collective_s"])
        print(f"\nworst roofline fraction: {worst['arch']} × {worst['shape']}"
              f" ({worst['roofline_fraction']:.1%})")
        print(f"most collective-bound:   {collb['arch']} × {collb['shape']}"
              f" ({fmt_s(collb['collective_s'])})")


if __name__ == "__main__":
    main()
