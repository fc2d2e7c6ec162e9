"""Dispatch-path benchmark on the PyTorch port: event-driven call lifecycle
+ batch invocation.  Twin of ``benchmarks/bench_dispatch.py`` (the same
request count, trials, rows — named ``dispatch_torch/...`` — and floors),
on the card unless ``--device cpu``.

Measures, for both isolation modes (the paper's §6 faaslet/container
contrast):

  * warm per-call invoke→wait latency (p50/p99) — the event-driven wait()
    must show no 50 ms polling floor;
  * serial invoke/wait throughput vs ``invoke_many``/``wait_all`` batch
    throughput on the same no-op function — the batch path amortises
    submission and wakes its waiter once on a shared completion latch.

Both measure the host's threads: the no-op call runs no kernel.

Run:  PYTHONPATH=src:. python benchmarks/bench_dispatch_torch.py \
          [--requests 200] [--device cpu]
      (also wired into ``python -m benchmarks.run_torch dispatch``)
"""
import argparse
import time

import numpy as np

from benchmarks.common import emit
from repro_torch.core import FaasmRuntime, FunctionDef
from repro_torch.kernels.common import resolve_device

# the reference's acceptance floors (faaslet mode): warm p99 below this,
# no polling floor; invoke_many at least this many times serial
P99_FLOOR_MS = 10.0
BATCH_FLOOR = 5.0


def _noop(api):
    return 0


def _warm(rt, n):
    rt.wait_all(rt.invoke_many("noop", [b""] * n), timeout=60)


def bench_mode(mode: str, n_requests: int, n_hosts: int = 1,
               capacity: int = 8, trials: int = 3, device="cuda") -> dict:
    rt = FaasmRuntime(n_hosts=n_hosts, capacity=capacity, isolation=mode,
                      device=device)
    try:
        rt.upload(FunctionDef("noop", _noop))
        _warm(rt, capacity)

        best = None
        all_lats = []
        for _ in range(trials):
            # -- warm per-call latency (serial invoke -> wait) ---------------
            lats = []
            t_serial0 = time.perf_counter()
            for _ in range(n_requests):
                t0 = time.perf_counter()
                cid = rt.invoke("noop")
                rc = rt.wait(cid, timeout=30)
                assert rc == 0
                lats.append(time.perf_counter() - t0)
            serial_wall = time.perf_counter() - t_serial0
            all_lats.extend(lats)

            # -- batch fan-out (invoke_many -> wait_all) ---------------------
            t0 = time.perf_counter()
            cids = rt.invoke_many("noop", [b""] * n_requests)
            rcs = rt.wait_all(cids, timeout=60)
            batch_wall = time.perf_counter() - t0
            assert all(r == 0 for r in rcs)

            serial_rps = n_requests / serial_wall
            batch_rps = n_requests / batch_wall
            trial = {"serial_rps": serial_rps, "batch_rps": batch_rps,
                     "speedup": batch_rps / serial_rps}
            if best is None or trial["speedup"] > best["speedup"]:
                best = trial

        lat_ms = np.asarray(all_lats) * 1e3
        p50, p99 = (float(np.percentile(lat_ms, q)) for q in (50, 99))
        return {"mode": mode, "p50_ms": p50, "p99_ms": p99, **best}
    finally:
        rt.shutdown()


def floors(r: dict) -> dict:
    """Each acceptance floor of a faaslet-mode result: met or not."""
    return {"p99": r["p99_ms"] < P99_FLOOR_MS,
            "batch": r["speedup"] >= BATCH_FLOOR}


def main(n_requests: int = 200, device="cuda",
         hold_floors: bool = True) -> list:
    """Both modes' rows; returns their results.  ``hold_floors=False``
    reports the faaslet floors (:func:`floors`) without asserting them."""
    device = resolve_device(device)
    results = []
    for mode in ("faaslet", "container"):
        r = bench_mode(mode, n_requests, device=device)
        emit(f"dispatch_torch/{mode}/warm_latency_p50", r["p50_ms"] * 1e3,
             f"p99={r['p99_ms']:.2f}ms")
        emit(f"dispatch_torch/{mode}/serial_throughput",
             1e6 / r["serial_rps"], f"{r['serial_rps']:.0f} req/s")
        emit(f"dispatch_torch/{mode}/batch_throughput",
             1e6 / r["batch_rps"],
             f"{r['batch_rps']:.0f} req/s ({r['speedup']:.1f}x serial)")
        results.append(r)
        if mode == "faaslet" and hold_floors:
            # acceptance floor: event-driven wait + batch latch
            assert r["p99_ms"] < P99_FLOOR_MS, \
                f"warm p99 {r['p99_ms']:.2f}ms — polling floor regression"
            assert r["speedup"] >= BATCH_FLOOR, \
                f"invoke_many only {r['speedup']:.1f}x serial throughput"
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    main(args.requests, args.device)
