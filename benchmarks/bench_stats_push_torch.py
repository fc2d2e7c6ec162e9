"""The Faasm fan-out's serve/stats push alone, on the PyTorch port: the
pull, add and int8 push of the shared stats vector under a wave of 8
executors, with no model, on the card unless ``--device cpu``.

Each call runs what ``repro_torch/launch/serve.py``'s ``infer`` function
runs after its forward (``faasm_serve_call_stats_ms``): a ``VectorAsync``
handle on ``serve/stats`` and its pull with delta tracking (both pull:
the handle maps the replica), one add of 1.0 at the call's token, and a
push over the int8 wire (K1 on the card).  The call times the three on
the host clock; the wave reports their mean a call, beside the return
codes and the global value, which must equal the tokens' histogram
within the int8 residual: the port loses no count.

``stats_wave`` takes the runtime and state modules as arguments, so the
same wave runs through another package beside the port
(``tests/test_torch_runtime.py::test_stats_push_wave_in_both_packages``).

Run:  PYTHONPATH=src python benchmarks/bench_stats_push_torch.py \\
          [--device cpu]
"""
import argparse
import threading
import time

import numpy as np

INT8_STEP = 1.01 / 127        # the int8 bound on one unit push
VOCAB = 151_936               # serve/stats: qwen1.5-0.5b's vocabulary
CALLS = 64                    # the fan-out's requests
EXECUTORS = 8                 # its executors, one warm-up call each


def stats_wave(core, ddo, runtime_kw: dict = None) -> dict:
    """One warm-up call per executor, then ``CALLS`` calls as one wave,
    each pulling ``serve/stats``, adding 1.0 at its token and pushing
    over the int8 wire.  Returns the wave's mean ``pull_ms``, ``add_ms``,
    ``push_ms`` and ``stats_ms`` a call, its wall, the return codes, and
    the global value with the histogram it should hold."""
    rt = core.FaasmRuntime(n_hosts=1, capacity=EXECUTORS,
                           **(runtime_kw or {}))
    times, mu = [], threading.Lock()

    def stats(api):
        token = int.from_bytes(api.read_call_input(), "little")
        t0 = time.perf_counter()
        vec = ddo.VectorAsync(api, "serve/stats")
        vec.pull(track_delta=True)
        t1 = time.perf_counter()
        vec.add([token], 1.0)
        t2 = time.perf_counter()
        vec.push_delta(wire="int8")
        t3 = time.perf_counter()
        with mu:
            times.append((t1 - t0, t2 - t1, t3 - t2))
        return 0

    tokens = [(i * 7919) % VOCAB for i in range(EXECUTORS + CALLS)]
    payloads = [t.to_bytes(4, "little") for t in tokens]
    try:
        ddo.VectorAsync.create(rt.global_tier, "serve/stats",
                               np.zeros(VOCAB, np.float32))
        rt.upload(core.FunctionDef("stats", stats))
        hint = ["serve/stats"]
        warm = rt.wait_all(rt.invoke_many("stats", payloads[:EXECUTORS],
                                          state_hint=hint), timeout=300)
        with mu:
            del times[:]
        t0 = time.perf_counter()
        rcs = rt.wait_all(rt.invoke_many("stats", payloads[EXECUTORS:],
                                         state_hint=hint), timeout=600)
        wall = time.perf_counter() - t0
        got = np.frombuffer(rt.global_tier.get("serve/stats", host="main"),
                            np.float32).copy()
    finally:
        rt.shutdown()
    ms = np.asarray(times) * 1e3
    return {"pull_ms": float(ms[:, 0].mean()),
            "add_ms": float(ms[:, 1].mean()),
            "push_ms": float(ms[:, 2].mean()),
            "stats_ms": float(ms.sum(axis=1).mean()), "wall_s": wall,
            "rcs": warm + rcs, "stats": got,
            "want": np.bincount(tokens, minlength=VOCAB).astype(np.float32)}


def main(argv=None) -> dict:
    from repro_torch import core
    from repro_torch.kernels.common import resolve_device
    from repro_torch.state import ddo
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    r = stats_wave(core, ddo, runtime_kw={"device": device})
    calls = CALLS + EXECUTORS
    err = float(np.abs(r["stats"] - r["want"]).max())
    lost = calls - float(r["stats"].sum())
    print(f"stats push on {device}, {CALLS} calls on {EXECUTORS} "
          f"executors, {VOCAB} floats: pull {r['pull_ms']:.3f}ms + add "
          f"{r['add_ms']:.3f}ms + int8 push {r['push_ms']:.3f}ms = "
          f"{r['stats_ms']:.3f}ms a call; wave {r['wall_s'] * 1e3:.1f}ms; "
          f"max |err| {err:.3e}, counts less the sum {lost:.3e} (bound "
          f"{calls * INT8_STEP:.3e})")
    if r["rcs"] != [0] * calls or err > calls * INT8_STEP or \
            abs(lost) > calls * INT8_STEP:
        raise SystemExit(f"stats wave failed: return codes {r['rcs']}, "
                         f"max |err| {err}, lost {lost}")
    return r


if __name__ == "__main__":
    main()
