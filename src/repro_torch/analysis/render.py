"""Render the dry run's JSON rows (:mod:`repro_torch.launch.dryrun`) as a
markdown table: the port of ``repro.analysis.render``.

    PYTHONPATH=src python -m repro_torch.analysis.render dryrun.json

Each row: the roofline's three terms, the dominant one, the share of the
counted FLOPs that is model math, the traced per-device peak and whether
it fits the H100's 80 GB (``memory.fits_hbm``), the analytic model's
total beside it, the collective that moves the most bytes, and each
kernel's launches. A row that failed shows the port's error.
"""
from __future__ import annotations

import json
import sys

__all__ = ["fmt_row", "table", "main"]

HEADER = ("| arch | shape | mesh | compute s | memory s | collective s | "
          "dominant | useful | peak GB/dev | fits 80 GB | analytic GB | "
          "top collective | kernel launches |")
COLUMNS = HEADER.count("|") - 1


def fmt_row(r: dict) -> str:
    t = r["roofline"]
    m = r["memory"]
    coll = r["collectives"]["bytes_by_kind"]
    top_coll = max(coll, key=coll.get) if any(coll.values()) else "-"
    kern = ", ".join(f"{k} {v['launches']}"
                     for k, v in sorted(r.get("kernels", {}).items())) or "-"
    return (
        f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
        f"{t['compute_s']:.3f} | {t['memory_s']:.3f} | "
        f"{t['collective_s']:.3f} | **{t['dominant']}** | "
        f"{t['useful_flop_ratio']:.2f} | {m['peak_gb']:.1f} | "
        f"{'yes' if m['fits_hbm'] else 'NO'} | "
        f"{r['analytic_memory']['total_gb']:.1f} | {top_coll} | {kern} |"
    )


def table(recs: list[dict]) -> str:
    lines = [HEADER, "|" + "---|" * COLUMNS]
    for r in recs:
        if r.get("ok"):
            lines.append(fmt_row(r))
        else:
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"FAIL: {r['error'][:80]} |" + " |" * (COLUMNS - 4))
    return "\n".join(lines)


def main(argv=None) -> None:
    path = (argv or sys.argv[1:])[0]
    with open(path) as f:
        recs = json.load(f)
    print(table(recs))


if __name__ == "__main__":
    main()
