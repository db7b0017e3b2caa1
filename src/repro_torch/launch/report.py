"""Tables of dry-run records (port of `repro.launch.report`): the roofline
terms of each cell per mesh, predicted from the H100 constants of
`launch.roofline` (no card runs in a dry run).

Usage: PYTHONPATH=src python -m repro_torch.launch.report dryrun.jsonl [...]
"""
from __future__ import annotations

import json
import sys

from .roofline import HBM_BYTES


def load(paths) -> dict:
    """Later files win per (arch, shape, mesh)."""
    rows = {}
    for p in paths:
        with open(p) as f:
            for line in f:
                r = json.loads(line)
                rows[(r["arch"], r["shape"], r["mesh"])] = r
    return rows


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def hbm_fit(r) -> str:
    """Arguments + temp per device, in GB; '!' above the card's 80 GB."""
    m = r.get("memory_analysis") or {}
    tot = (m.get("argument_size_in_bytes") or 0) + (m.get("temp_size_in_bytes") or 0)
    return f"{tot / 1e9:.1f}GB{'!' if tot > HBM_BYTES else ''}"


def table(rows: dict, mesh: str) -> str:
    hdr = (
        "| arch | shape | compute s | memory s | collective s | bottleneck | "
        "useful (6ND/FLOPs) | args+temp/dev |\n"
        "|---|---|---|---|---|---|---|---|\n"
    )
    out = [hdr]
    for (arch, shape, m), r in sorted(rows.items()):
        if m != mesh:
            continue
        if r["status"] in ("skipped", "not_ported"):
            out.append(f"| {arch} | {shape} | - | - | - | {r['status']} | - | - |\n")
            continue
        if r["status"] != "ok":
            out.append(f"| {arch} | {shape} | - | - | - | ERROR | - | - |\n")
            continue
        t = r["roofline"]
        out.append(
            f"| {arch} | {shape} | {t['compute_s']:.3f} | {t['memory_s']:.3f} | "
            f"{t['collective_s']:.3f} | {t['bottleneck']} | "
            f"{r['useful_flops_ratio']:.2f} | {hbm_fit(r)} |\n"
        )
    return "".join(out)


def compact(rows: dict, meshes=("16x16", "pod2x16x16")) -> str:
    """One row a cell that ran on every mesh in `meshes`: each mesh's
    compute / memory / collective seconds, bottleneck and arguments + temp;
    then one line naming the cells that did not run."""
    heads = " | ".join(f"{m}: c / m / x s, bound, GB" for m in meshes)
    out = [f"| arch | shape | {heads} |\n", "|---|---|" + "---|" * len(meshes) + "\n"]
    others = []
    for arch, shape in sorted({(a, s) for a, s, _ in rows}):
        recs = [rows.get((arch, shape, m)) for m in meshes]
        if any(r is None or r["status"] != "ok" for r in recs):
            status = {r["status"] for r in recs if r is not None}
            others.append(f"{arch} x {shape} ({'/'.join(sorted(status))})")
            continue
        cols = []
        for r in recs:
            t = r["roofline"]
            cols.append(f"{t['compute_s']:.3f} / {t['memory_s']:.3f} / {t['collective_s']:.3f}, "
                        f"{t['bottleneck']}, {hbm_fit(r)}")
        out.append(f"| {arch} | {shape} | {' | '.join(cols)} |\n")
    if others:
        out.append(f"\nNot run: {'; '.join(others)}.\n")
    return "".join(out)


def summary(rows: dict) -> dict:
    counts = {"ok": 0, "skipped": 0, "not_ported": 0, "error": 0}
    for r in rows.values():
        counts[r["status"] if r["status"] in counts else "error"] += 1
    return {**counts, "total": len(rows)}


def interesting_cells(rows: dict, mesh: str = "16x16"):
    """Rank cells for tuning: worst compute fraction, most collective-bound."""
    scored = []
    for (arch, shape, m), r in rows.items():
        if m != mesh or r["status"] != "ok":
            continue
        t = r["roofline"]
        scored.append({"cell": (arch, shape), "compute_fraction": t["compute_fraction_of_bound"],
                       "collective_s": t["collective_s"], "bottleneck": t["bottleneck"],
                       "bound_s": t["roofline_bound_s"]})
    worst = sorted(scored, key=lambda s: s["compute_fraction"])[:8]
    most_coll = sorted(scored, key=lambda s: -s["collective_s"])[:8]
    return {"worst_compute_fraction": worst, "most_collective": most_coll}


def main(paths: list[str]) -> None:
    import pprint

    rows = load(paths)
    print("summary:", summary(rows))
    for mesh in ("16x16", "pod2x16x16"):
        print(f"\n## mesh {mesh} (predicted from H100 constants, no card run)\n")
        print(table(rows, mesh))
    print("\n## both meshes\n")
    print(compact(rows))
    pprint.pprint(interesting_cells(rows))


if __name__ == "__main__":
    main(sys.argv[1:] or ["dryrun.jsonl"])
