"""Roofline report of the port: reads the port's dry-run artifacts
(``artifacts/dryrun_torch``, written by ``python -m
repro_torch.launch.dryrun``) and prints the per-cell table (compute /
memory / collective terms at the H100's constants, dominant bottleneck,
useful FLOPs).  The twin of ``benchmarks/bench_roofline.py``; the terms
are counts over the card's peaks, not measured times."""
import glob
import json
import os

from benchmarks.common import emit

ART = "artifacts/dryrun_torch"


def load_cells(mesh: str = "pod16x16", tag: str | None = None, art: str = ART):
    """The records of ``mesh``; perf variants (``__<tag>`` names) only
    when ``tag`` names them."""
    cells = []
    for path in sorted(glob.glob(os.path.join(art, mesh, "*.json"))):
        name = os.path.basename(path)[:-5]
        if tag is None and name.count("__") >= 2:
            continue                      # skip perf-variant artifacts
        if tag is not None and not name.endswith("__" + tag):
            continue
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def main(art: str = ART) -> None:
    cells = load_cells("pod16x16", art=art)
    if not cells:
        print("# no dry-run artifacts found; run: "
              "PYTHONPATH=src python -m repro_torch.launch.dryrun")
        return
    for rec in cells:
        if rec.get("status") != "ok":
            continue
        r = rec["roofline"]
        dom_time = max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])
        emit(f"roofline/{rec['arch']}/{rec['shape']}", dom_time * 1e6,
             f"dom={r['dominant']} frac={r['roofline_fraction']:.3f} "
             f"useful={r['useful_flops_ratio']:.3f} "
             f"peakGiB={rec['memory']['peak_bytes'] / 2**30:.1f}")


if __name__ == "__main__":
    main()
