"""Render the dry-run JSON cache into roofline tables (the reference's
``launch/report.py``), over the two H100 meshes.

The tables model cards the repo does not run: datasheet link
bandwidths, no tensor-parallel collectives, and temporaries estimated at
``model`` = 1 (``dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_h100]
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD

ARCH_ORDER = ("gemma2-27b", "minicpm3-4b", "granite-20b", "nemotron-4-15b",
              "granite-moe-3b-a800m", "arctic-480b", "rwkv6-3b",
              "zamba2-2.7b", "internvl2-1b", "musicgen-large")
SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def load_cells(dryrun_dir: str, mesh: str) -> Dict[str, dict]:
    out = {}
    for f in glob.glob(os.path.join(dryrun_dir, mesh, "*.json")):
        with open(f) as fh:
            d = json.load(fh)
        out[f"{d['arch']}__{d['shape']}"] = d
    return out


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(cells: Dict[str, dict]) -> str:
    hdr = ("| arch | shape | t_compute | t_memory | t_collective | bound | "
           "useful-FLOPs | roofline-frac | peak GB/card | note |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            d = cells.get(f"{arch}__{shape}")
            if d is None:
                continue
            if d["status"] == "skipped":
                rows.append(f"| {arch} | {shape} | — | — | — | — | — | — | — "
                            f"| {d['skip_reason']} |")
                continue
            if d["status"] == "failed":
                rows.append(f"| {arch} | {shape} | — | — | — | — | — | — | — "
                            f"| failed: {d['error'][:80]} |")
                continue
            r = d["roofline"]
            note = []
            if d.get("num_waves", 1) > 1:
                note.append(f"prefill waves×{d['num_waves']}")
            if not d["memory"]["fits_80gb"]:
                note.append("OVER H100 HBM")
            rows.append(
                f"| {arch} | {shape} | {_fmt_s(r['t_compute_s'])} | "
                f"{_fmt_s(r['t_memory_s'])} | {_fmt_s(r['t_collective_s'])} | "
                f"{r['bottleneck']} | {r['useful_flops_fraction']:.2f} | "
                f"{r['roofline_fraction']:.3f} | "
                f"{d['memory']['peak_bytes']/1e9:.1f} | {';'.join(note)} |")
    return hdr + "\n".join(rows) + "\n"


def fit_table(cells: Dict[str, dict]) -> str:
    """One row an arch, one column a shape: peak GB a card (over 80:
    OVER), the bottleneck and its bound time."""
    hdr = ("| arch | " + " | ".join(SHAPE_ORDER) + " |\n|---|"
           + "---|" * len(SHAPE_ORDER) + "\n")
    rows = []
    for arch in ARCH_ORDER:
        cols = []
        for shape in SHAPE_ORDER:
            d = cells.get(f"{arch}__{shape}")
            if d is None or d["status"] != "ok":
                cols.append("—" if d is None or d["status"] == "skipped"
                            else "failed")
                continue
            r, m = d["roofline"], d["memory"]
            t = max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])
            cols.append(f"{m['peak_bytes'] / 1e9:.1f} GB"
                        + ("" if m["fits_80gb"] else " OVER")
                        + f", {r['bottleneck']} {_fmt_s(t)}")
        rows.append(f"| {arch} | " + " | ".join(cols) + " |")
    return hdr + "\n".join(rows) + "\n"


def summary(cells: Dict[str, dict]) -> dict:
    ok = [d for d in cells.values() if d["status"] == "ok"]
    skipped = [d for d in cells.values() if d["status"] == "skipped"]
    failed = [d for d in cells.values() if d["status"] == "failed"]
    bounds: Dict[str, int] = {}
    for d in ok:
        bounds[d["roofline"]["bottleneck"]] = bounds.get(
            d["roofline"]["bottleneck"], 0) + 1
    return {"ok": len(ok), "skipped": len(skipped), "failed": len(failed),
            "bounds": bounds,
            "fits": sum(1 for d in ok if d["memory"]["fits_80gb"]),
            "trace_s": sum(d["t_lower_s"] + d["t_compile_s"] for d in ok)}


def worst_cells(cells: Dict[str, dict], n: int = 5) -> List[str]:
    ok = [d for d in cells.values() if d["status"] == "ok"]
    ok.sort(key=lambda d: d["roofline"]["roofline_fraction"])
    return [f"{d['arch']}__{d['shape']}"
            f" (frac={d['roofline']['roofline_fraction']:.3f},"
            f" bound={d['roofline']['bottleneck']})" for d in ok[:n]]


def most_collective_bound(cells: Dict[str, dict], n: int = 5) -> List[str]:
    ok = [d for d in cells.values() if d["status"] == "ok"]

    def coll_share(d):
        r = d["roofline"]
        tot = r["t_compute_s"] + r["t_memory_s"] + r["t_collective_s"]
        return r["t_collective_s"] / tot if tot else 0

    ok.sort(key=coll_share, reverse=True)
    return [f"{d['arch']}__{d['shape']} (coll_share={coll_share(d):.2f})"
            for d in ok[:n]]


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_h100")
    args = ap.parse_args(argv)
    for mesh in (SINGLE_POD, MULTI_POD):
        cells = load_cells(args.dir, mesh)
        print(f"\n## {mesh}: {summary(cells)}")
        print(roofline_table(cells))
        print(fit_table(cells))
        print("worst roofline:", worst_cells(cells))
        print("most collective-bound:", most_collective_bound(cells))


if __name__ == "__main__":
    main()
