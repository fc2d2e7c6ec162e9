"""Dry-run and roofline tables of the port from its artifacts: the twin of
``benchmarks/report.py`` over ``artifacts/dryrun_torch``, the "fits" test
against one H100's 80 GB.  Every figure is a count from the traced step
(``repro_torch.launch.dryrun``) or a count over the H100's data-sheet
peaks, not a measured time.

Run:  PYTHONPATH=src python -m benchmarks.report_torch > artifacts/roofline_tables_torch.md
"""
import argparse
import os

from benchmarks.bench_roofline_torch import ART, load_cells

HBM_GB = 80.0    # one H100 SXM
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def dryrun_table(mesh: str, art: str = ART) -> str:
    rows = [f"### Mesh `{mesh}`",
            "",
            "| arch | shape | trace s | peak GB/dev | fits H100 | "
            "FLOPs/dev | HBM bytes/dev | collective bytes/dev | "
            "ag / ar / rs / a2a / cp (count) |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in load_cells(mesh, art=art):
        if r.get("status") == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — | — "
                        f"| skipped: sub-quadratic required |")
            continue
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | |")
            continue
        peak = r["memory"]["peak_bytes"] / 1e9
        fits = "yes" if peak <= HBM_GB else f"**no** ({peak:.0f} GB)"
        c = r["collectives"]["counts"]
        counts = "/".join(str(int(c.get(k, 0))) for k in KINDS)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['trace_s']:.1f} "
            f"| {peak:.2f} | {fits} "
            f"| {r['flops_per_device']:.3g} | {r['bytes_per_device']:.3g} "
            f"| {r['collective_bytes_per_device']:.3g} | {counts} |")
    return "\n".join(rows)


def roofline_table(mesh: str, art: str = ART) -> str:
    rows = ["| arch | shape | T_compute ms | T_memory ms | T_collective ms | "
            "dominant | MODEL_FLOPS | useful ratio | roofline frac | "
            "one-line bottleneck note |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    notes = {
        "compute": "tensor-core-bound; raise arithmetic intensity via larger "
                   "tiles / fewer recomputes",
        "memory": "HBM-bound; cut activation traffic (fusion, remat policy, "
                  "bf16 accumulators)",
        "collective": "network-bound; reshard to cut gathers or compress "
                      "the cross-pod push",
    }
    for r in load_cells(mesh, art=art):
        if r.get("status") != "ok":
            continue
        rf = r["roofline"]
        dom = rf["dominant"]
        rows.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {rf['t_compute_s'] * 1e3:.2f} "
            f"| {rf['t_memory_s'] * 1e3:.2f} "
            f"| {rf['t_collective_s'] * 1e3:.2f} | {dom} "
            f"| {rf['model_flops']:.3g} | {rf['useful_flops_ratio']:.3f} "
            f"| {rf['roofline_fraction']:.3f} | {notes.get(dom, '')} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--art", default=ART, help="artifacts directory")
    art = ap.parse_args(argv).art
    print("<!-- generated by benchmarks/report_torch.py -->")
    for mesh in ("pod16x16", "pod2x16x16"):
        if not os.path.isdir(os.path.join(art, mesh)):
            continue
        print(f"\n## Dry-run — {mesh}\n")
        print(dryrun_table(mesh, art))
    print("\n## Roofline — single pod (pod16x16)\n")
    print(roofline_table("pod16x16", art))


if __name__ == "__main__":
    main()
