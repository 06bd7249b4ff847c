"""Emit the dry-run and roofline markdown tables from the port's dry-run JSON.

Counterpart of `repro/tools/report_md.py`, over `reports/dryrun_torch.json`
(`repro_torch.launch.dryrun`) and the card's peaks (`tools/roofline.py`).

Usage: PYTHONPATH=src python -m repro_torch.tools.report_md [report.json] > tables.md
"""

from __future__ import annotations

import sys

from repro_torch.configs import get_config
from repro_torch.tools.roofline import HBM_BW, PEAK_FLOPS, generate_report, param_counts

DEFAULT_REPORT = "reports/dryrun_torch.json"


def fmt_s(x):
    return f"{x:.3g}"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else DEFAULT_REPORT
    rows = generate_report(path)["rows"]

    print("### Dry-run matrix (abstract run on one card: status, resident bytes, "
          "exchanges per step)\n")
    print("| arch | shape | mesh | status | trace (s) | resident GiB | collectives per step |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        if r["status"] == "SKIP":
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP ({r['reason'][:48]}…) "
                  "| — | — | — |")
        elif r["status"] == "OK":
            coll = r.get("collectives") or {}
            cstr = ", ".join(f"{k}×{v}" for k, v in coll.items()) or "—"
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | OK | {r['t_compile_s']} | "
                  f"{r['peak_gib']:.2f} | {cstr} |")
        else:
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | **FAIL** | — | — | — |")

    print(f"\n### Roofline terms (seconds per step on one card; NVIDIA H100 SXM at 700 W: "
          f"{PEAK_FLOPS / 1e12:.0f} TF/s bf16, {HBM_BW / 1e12:.2f} TB/s HBM3)\n")
    print("| arch | shape | mesh | compute | memory | collective | dominant | "
          "MODEL/counted flops | note |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        if r["status"] != "OK":
            continue
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {fmt_s(r['compute_s'])} | "
              f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | {r['dominant']} | "
              f"{r['useful_ratio']:.2f} | {r['note']} |")

    print("\n### Parameter counts\n")
    print("| arch | total params | active/token |")
    print("|---|---|---|")
    seen = set()
    for r in rows:
        if r["arch"] in seen:
            continue
        seen.add(r["arch"])
        t, a = param_counts(get_config(r["arch"]))
        print(f"| {r['arch']} | {t / 1e9:.2f}B | {a / 1e9:.2f}B |")


if __name__ == "__main__":
    main()
