"""The readings that a cell's output limits are set from.

    python3 bench/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6

For each of ``--seeds`` the program's set-up and the path the window
times, compared with the plain reference as a run compares them; for
each of ``--control-seeds`` the control, the reference computed in the
lower precision (``fp8``), put in the program's place; for each of
``--half-batch-seeds`` (training) the reference over half of each batch,
a planted fault, in the program's place.  One JSON line a
seed on standard output: every number the cell's driver compares, with
where it was read.  A run's limits lie above the program's largest
reading and below the control's smallest (``PERF.md`` gives both).  Not
a benchmark run: it prints no result line.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--half-batch-seeds", default="",
                    help="training: the reference over half of each "
                         "batch in the program's place (a planted fault)")
    args = ap.parse_args(argv)
    import torch
    from bench import harness
    from bench.drivers.common import Run
    if not torch.cuda.is_available():
        print("bench: readings are taken on the card", file=sys.stderr)
        return 2
    cell = harness.cell(harness.load_benchmark(ROOT), args.workload, ROOT)
    drv = harness.driver(cell)
    plan = [(int(s), "program") for s in args.seeds.split(",") if s] + \
        [(int(s), "control") for s in args.control_seeds.split(",") if s] \
        + [(int(s), "half_batch") for s in args.half_batch_seeds.split(",")
           if s]
    for seed, side in plan:
        run = Run(cell=cell, seed=seed, seconds=0.0, trace=False,
                  device=torch.device("cuda", 0), t_start=time.perf_counter())
        t0 = time.perf_counter()
        nums = (drv.readings(run, fault=side) if side == "half_batch" else
                drv.readings(run, control=side == "control"))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": side,
                          "numbers": {k: list(v) for k, v in nums.items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
