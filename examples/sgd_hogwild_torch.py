"""Distributed HOGWILD! SGD through FAASM (paper Listing 1 / Fig. 6), on the
PyTorch port.

Twin of ``examples/sgd_hogwild.py``: a sparse linear classifier trained by
chained ``weight_update`` Faaslets sharing the weight vector through the
two-tier state (VectorAsync), the Faaslet runtime against the container-sim
baseline on the paper's three axes: training time, network transfer,
billable memory.  The runtime and its state tiers are the port's, on the
card unless ``--device cpu`` is given: there an int8 push encodes through
the fused quantise kernel (K1), its codes bitwise the host codec's.

Run:  PYTHONPATH=src python examples/sgd_hogwild_torch.py \
          [--workers 4] [--epochs 4] [--wire auto|exact|int8] [--device cuda|cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core import FaasmRuntime, FunctionDef
from repro_torch.data import accuracy, hinge_loss, make_sparse_dataset
from repro_torch.kernels.common import resolve_device
from repro_torch.state.ddo import SparseMatrixReadOnly, VectorAsync


def build_functions(n_features: int, n_cols: int, n_workers: int,
                    n_epochs: int, lr: float = 0.05, wire: str = "exact"):
    def weight_update(api):
        lo, hi = np.frombuffer(api.read_call_input(), np.int32)
        mat = SparseMatrixReadOnly(api, "train_x")       # pulls only its columns
        labels = np.frombuffer(bytes(api.get_state("labels", writable=False)),
                               np.float32)
        w = VectorAsync(api, "weights")
        if api.host.isolation == "faaslet":
            w.subscribe()        # peer pushes land in the warm replica:
        w.pull(track_delta=True)  # this pull then moves (near) zero bytes
        for c, rows, vals in mat.columns(int(lo), int(hi)):
            margin = float(labels[c] * (w.values[rows] * vals).sum())
            if margin < 1.0:
                w.add(rows, lr * labels[c] * vals)       # lock-free shared write
        w.push_delta(wire=wire)                           # sporadic global push
        return 0

    def sgd_main(api):
        per = n_cols // n_workers
        for _ in range(n_epochs):
            args = [np.asarray([w * per, (w + 1) * per], np.int32).tobytes()
                    for w in range(n_workers)]
            # batch fan-out: one submission + one shared completion latch;
            # the state hint steers placement onto hosts already holding
            # warm replicas of the shared weight vector
            cids = api.chain_call_many("weight_update", args,
                                       state_hint=["weights"])
            rcs = api.await_all(cids)
            assert all(r == 0 for r in rcs), rcs
        return 0

    return weight_update, sgd_main


def run_mode(mode: str, X, y, n_workers: int, n_epochs: int, n_hosts: int,
             wire: str = "exact", device="cuda"):
    """The reference's ``run_mode`` on the port's runtime; beside its keys
    the dict holds ``weights``, the final weight vector."""
    rt = FaasmRuntime(n_hosts=n_hosts, capacity=max(2, n_workers),
                      isolation=mode, device=device)
    try:
        SparseMatrixReadOnly.create(rt.global_tier, "train_x", X)
        rt.global_tier.set("labels", y.astype(np.float32).tobytes(), host="up")
        VectorAsync.create(rt.global_tier, "weights",
                           np.zeros(X.shape[0], np.float32))
        weight_update, sgd_main = build_functions(
            X.shape[0], X.shape[1], n_workers, n_epochs, wire=wire)
        rt.upload(FunctionDef("weight_update", weight_update))
        rt.upload(FunctionDef("sgd_main", sgd_main))
        rt.global_tier.reset_metrics()
        t0 = time.perf_counter()
        cid = rt.invoke("sgd_main")
        rc = rt.wait(cid, timeout=600)
        wall = time.perf_counter() - t0
        assert rc == 0, rt.call(cid).error
        w = np.frombuffer(rt.global_tier.get("weights", host="eval"),
                          np.float32)
        return {
            "mode": mode,
            "wall_s": wall,
            "transfer_mb": rt.transfer_bytes() / 1e6,
            "billable_gbs": rt.billable_gb_seconds(),
            "hinge": hinge_loss(w, X, y),
            "acc": accuracy(w, X, y),
            "weights": w,
        }
    finally:
        rt.shutdown()


def main(argv=None) -> list:
    """Runs both isolation modes; returns their ``run_mode`` dicts."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--features", type=int, default=128)
    ap.add_argument("--examples", type=int, default=512)
    ap.add_argument("--wire", choices=("auto", "exact", "int8"),
                    default="auto",
                    help="delta wire format: auto (default) lets the "
                         "per-key WirePolicy pick int8 vs exact from the "
                         "observed deltas; int8 forces the quantised "
                         "kernels/state_push path (~4x fewer push bytes)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    X, y, _ = make_sparse_dataset(args.features, args.examples,
                                  density=0.1, seed=0)
    print(f"dataset: {args.features}x{args.examples} sparse, "
          f"{args.workers} workers x {args.epochs} epochs, "
          f"wire={args.wire}\n")
    results = []
    for mode in ("faaslet", "container"):
        r = run_mode(mode, X, y, args.workers, args.epochs, args.hosts,
                     wire=args.wire, device=device)
        print(f"[{r['mode']:9s}] wall={r['wall_s']:.2f}s "
              f"transfer={r['transfer_mb']:.2f}MB "
              f"billable={r['billable_gbs']:.2e}GB-s "
              f"hinge={r['hinge']:.3f} acc={r['acc']:.3f}")
        results.append(r)
    print("\n(faaslet mode: shared local tier + delta pushes; container mode: "
          "per-instance copies — the paper's Fig. 6 contrast)")
    return results


if __name__ == "__main__":
    main()
