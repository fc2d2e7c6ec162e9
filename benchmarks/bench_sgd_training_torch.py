"""Paper Fig. 6 on the PyTorch port: HOGWILD SGD training — time / network /
billable memory, Faaslet runtime vs container-sim baseline, across
parallelism levels.  Twin of ``benchmarks/bench_sgd_training.py`` (the
same sizes, worker counts and modes, rows named ``fig6_sgd_torch/...``),
on the card unless ``--device cpu``.

Run:  PYTHONPATH=src:. python benchmarks/bench_sgd_training_torch.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

from benchmarks.common import emit
from repro_torch.data import make_sparse_dataset
from repro_torch.kernels.common import resolve_device


def main(argv=None) -> None:
    from sgd_hogwild_torch import run_mode
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    X, y, _ = make_sparse_dataset(96, 384, density=0.1, seed=0)
    for workers in (2, 4):
        for mode in ("faaslet", "container"):
            r = run_mode(mode, X, y, workers, n_epochs=2, n_hosts=2,
                         device=device)
            emit(f"fig6_sgd_torch/{mode}/w{workers}/wall", r["wall_s"] * 1e6,
                 f"acc={r['acc']:.3f}")
            emit(f"fig6_sgd_torch/{mode}/w{workers}/transfer_mb",
                 r["transfer_mb"] * 1e6, "network transfer (MB scaled 1e6)")
            emit(f"fig6_sgd_torch/{mode}/w{workers}/billable_gbs",
                 r["billable_gbs"] * 1e6, "billable GB-s (scaled 1e6)")


if __name__ == "__main__":
    main()
