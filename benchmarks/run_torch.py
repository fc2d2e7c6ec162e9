"""Benchmark runner of the PyTorch port: one function per paper table or
figure, the twin of ``benchmarks/run.py``.  Every table runs on the card
unless ``--device cpu`` is given.

Prints ``name,us_per_call,derived`` CSV rows.

Run:  PYTHONPATH=src:. python -m benchmarks.run_torch [table ...] [--device cpu]
      (tables: fig6 fig7 fig8 fig9 tab3 dispatch roofline; default: all.
      ``roofline`` reads the port's dry-run artifacts,
      ``artifacts/dryrun_torch``, written by ``python -m
      repro_torch.launch.dryrun``; it runs on no device)
"""
import argparse
import traceback

from benchmarks import (bench_coldstart_torch, bench_dispatch_torch,
                        bench_inference_torch, bench_matmul_torch,
                        bench_micro_torch, bench_roofline_torch,
                        bench_sgd_training_torch)
from repro_torch.kernels.common import resolve_device

TABLES = {
    "fig6": lambda d: bench_sgd_training_torch.main(["--device", d.type]),
    "fig7": lambda d: bench_inference_torch.main(["--device", d.type]),
    "fig8": lambda d: bench_matmul_torch.main(["--device", d.type]),
    "fig9": lambda d: bench_micro_torch.main(["--device", d.type]),
    "tab3": lambda d: bench_coldstart_torch.main(d),
    "dispatch": lambda d: bench_dispatch_torch.main(device=d),
    "roofline": lambda d: bench_roofline_torch.main(),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("tables", nargs="*",
                    help=f"any of {' '.join(TABLES)} (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    unknown = [t for t in args.tables if t not in TABLES]
    if unknown:
        ap.error(f"unknown tables {unknown}; choose from {list(TABLES)}")
    device = resolve_device(args.device)
    print("name,us_per_call,derived")
    failures = []
    for name in args.tables or list(TABLES):
        try:
            TABLES[name](device)
        except Exception as e:
            failures.append((name, e))
            traceback.print_exc()
    if failures:
        raise SystemExit(f"benchmark failures: {[n for n, _ in failures]}")


if __name__ == "__main__":
    main()
