"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration and traffic (``bench/harness.py``), runs
its driver (set-up, a window of ``--seconds``, then the check of the
window's outputs against the plain reference) and prints, as its last
lines on standard error, each number compared beside its limit, and as
the last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``.  Exits with a code
other than 0, and prints no result, without the card the cell asks for,
or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def fail(msg: str, code: int = 2) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def device_info(count: int, peak: int, trace) -> dict:
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count, "memory_peak_bytes": int(peak)}
    if trace is not None:
        out["busy_s"] = trace.busy_s
        out["window_s"] = trace.window_s
    return out


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from bench import harness
    bench = harness.load_benchmark(ROOT)
    cell = harness.cell(bench, args.workload, ROOT)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card: this benchmark measures the port on the card")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} found")
    from bench.drivers.common import Run
    run = Run(cell=cell, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device=torch.device("cuda", 0),
              t_start=T_START)
    out = harness.driver(cell).run(run)
    loaded = harness.forbidden_modules()
    if loaded:
        fail(f"loaded in this process: {', '.join(loaded)}", 3)
    if args.trace:
        from types import SimpleNamespace
        ctx = SimpleNamespace(model=cell.model, traffic=cell.traffic,
                              trace=out.trace, window_s=out.window_s,
                              flops=out.flops, extra=out.extra)
        metrics = {}
        for m in cell.per_layer:
            value = harness.reader(m["name"], ROOT).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": [list(x) for x in out.trace.device_ops],
                     "idle_gaps": [list(x) for x in out.trace.idle_gaps]}
    else:
        values = dict(out.end_to_end, setup_s=out.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        breakdown = None
    line = harness.result_line(
        checks=out.checks, attempted=out.attempted, failed=out.failed,
        metrics=metrics, device=device_info(cell.chips, out.memory_peak_bytes,
                                            out.trace),
        breakdown=breakdown)
    units = sorted(out.unit_s)
    print(f"timing setup_s {out.setup_s!r} window_s {out.window_s!r} "
          f"check_s {out.check_s!r} units {len(units)} unit_s min "
          f"{units[0]!r} median {units[len(units) // 2]!r} max {units[-1]!r}",
          file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
