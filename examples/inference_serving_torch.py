"""ML inference serving with Proto-Faaslet warm starts (paper §6.3 / Fig. 7),
on the PyTorch port.

Twin of ``examples/inference_serving.py``: the same experiment, the same
random draws and cold-start rule and the same output lines, through the
port's runtime.  Each request classifies a token sequence with the
forward pass that the runtime keeps in its executable cache; on the card
that is a captured forward per executor slot
(``repro_torch/launch/call_graphs.py``), on the CPU the eager forward.  A
fraction of requests are forced onto fresh instances: a Faaslet cold
start restores the Proto-Faaslet (its leaves pinned once per decoded
snapshot) and reuses the cached graphs; a container cold start
re-initialises (pinning its own copy of the leaves) and, its cache entry
evicted, captures the forward again.

Run:  PYTHONPATH=src python examples/inference_serving_torch.py \
          [--requests 24] [--arch qwen1.5-0.5b] [--smoke] [--device cuda|cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import FaasmRuntime
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.serve import host_leaves, make_infer_function
from repro_torch.models import ExecConfig, build_model

CACHE_KEY = ("serve", "fwd")


def _token(rt, call_id) -> int:
    return int(np.frombuffer(rt.output(call_id), np.int32)[0])


def serve(mode: str, n_requests: int, cold_ratio: float, model, leaves,
          device="cuda") -> dict:
    """The reference's ``serve`` on the port's runtime; beside its keys the
    dict holds ``tokens`` and ``batch_tokens`` (each request's token),
    ``misses`` (the executable cache's builds), ``captures`` and
    ``capture_ms`` (every warm-up and capture of a slot's forward, and
    their host time), ``cold_starts`` (of the timed requests),
    ``cold_captures`` and ``cold_ms``: the captures each forced cold start
    made, and its latency."""
    rt = FaasmRuntime(n_hosts=1, capacity=4, isolation=mode, device=device)
    try:
        rt.upload(make_infer_function(model, leaves, prompt_len=16,
                                      device=rt.device))
        captures = rt.metrics.histogram("faasm_serve_call_capture_ms")
        rng = np.random.default_rng(0)
        latencies, tokens, cold_captures, cold_ms = [], [], [], []
        host = next(iter(rt.hosts.values()))
        for i in range(n_requests):
            forced = False
            if i and rng.random() < cold_ratio:
                host._warm.clear()                 # force a cold start
                if mode == "container":
                    host._container_tiers.clear()
                if mode == "container":
                    rt.exec_cache.evict(CACHE_KEY)
                forced = True
            tokens_in = rng.integers(0, 257, 16, dtype=np.int32)
            n0 = captures.count
            t0 = time.perf_counter()
            cid = rt.invoke("infer", tokens_in.tobytes())
            rc = rt.wait(cid, timeout=300)
            latencies.append(time.perf_counter() - t0)
            if rc != 0:
                raise RuntimeError(rt.call(cid).error)
            tokens.append(_token(rt, cid))
            if forced:
                cold_captures.append(captures.count - n0)
                cold_ms.append(latencies[-1] * 1e3)
        lat = np.asarray(latencies[1:]) * 1e3      # skip the first (build)
        stats = rt.cold_start_stats()

        # batch fan-out: submit the whole request wave at once and block on
        # one shared completion latch (invoke_many / wait_all)
        payloads = [rng.integers(0, 257, 16, dtype=np.int32).tobytes()
                    for _ in range(n_requests)]
        t0 = time.perf_counter()
        cids = rt.invoke_many("infer", payloads)
        rcs = rt.wait_all(cids, timeout=300)
        batch_wall = time.perf_counter() - t0
        if not all(r == 0 for r in rcs):
            raise RuntimeError(f"batch return codes {rcs}")
        return {"mode": mode, "cold_ratio": cold_ratio,
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)),
                "init_mean_ms": stats["init_mean_ms"],
                "throughput_rps": len(lat) / (lat.sum() / 1e3),
                "batch_rps": n_requests / batch_wall,
                "tokens": tokens, "batch_tokens": [_token(rt, c) for c in cids],
                "misses": rt.exec_cache.stats()["misses"],
                "captures": captures.count, "capture_ms": captures.sum,
                "cold_captures": cold_captures, "cold_ms": cold_ms,
                "cold_starts": stats["cold_starts"]}
    finally:
        rt.shutdown()


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, ExecConfig(backend="auto"))
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    leaves = host_leaves(params)
    del params                                     # the card keeps no copy

    print(f"serving {cfg.name} ({args.requests} requests)\n")
    results = []
    for mode in ("faaslet", "container"):
        for ratio in (0.0, 0.2):
            r = serve(mode, args.requests, ratio, model, leaves, device)
            print(f"[{r['mode']:9s} cold={r['cold_ratio']:.0%}] "
                  f"p50={r['p50_ms']:8.1f}ms p99={r['p99_ms']:8.1f}ms "
                  f"init={r['init_mean_ms']:8.2f}ms "
                  f"tput={r['throughput_rps']:6.1f} req/s "
                  f"batch={r['batch_rps']:6.1f} req/s")
            results.append(r)
    print("\n(container cold starts re-capture the forward; Faaslet cold "
          "starts restore the Proto-Faaslet + cached graphs — Fig. 7's "
          "contrast)")
    return results


if __name__ == "__main__":
    main()
