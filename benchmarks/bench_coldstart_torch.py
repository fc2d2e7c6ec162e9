"""Paper Tab. 3 + Fig. 10 on the PyTorch port: cold-start footprint and
churn — plus copy accounting for the O(dirty) restore/reset and zero-copy
state data plane.

Twin of ``benchmarks/bench_coldstart.py``: the same measurements and rows,
named ``<table>_torch/...``, over the port's ``Faaslet``, ``ProtoFaaslet``,
``GlobalTier`` and ``LocalTier``, whose wire codec runs on the card unless
``--device cpu`` is given (an int8 encode of a host buffer copies it to the
card, runs the fused quantise kernel K1 and brings the codes back).  Its JSON
files go to ``artifacts/bench_torch/`` (``--out-dir``), never to the
repository's root, where the reference's copies live.  Each wire section
also records the K1 and K2 launches it made (``launches``; zero on the CPU).

Measures initialisation latency and memory footprint of Faaslets vs
Proto-Faaslet restore vs the container-sim baseline, and sustained cold-start
churn (instances created per second).

Copy accounting (``state_copy_torch/*`` rows, also written to ``BENCH_state.json``):

  * ``reset_dirty_us``    — §5.2 post-call reset of a 16 MB-arena Faaslet with
                            one dirty page via ``reset_from_base``.  On the
                            mmap path the reset madvises the dirty page back
                            to the kernel (~5 µs, and RSS shrinks); the loop
                            here re-dirties the page each iteration, so this
                            row *includes* the ~64 KB refault the next call
                            pays — the reclaim policy's latency-for-RSS trade.
  * ``reset_full_us``     — the pre-CoW baseline: ``restore_arena`` memcpying
                            the whole snapshot back.  The ratio is the
                            O(dirty)-vs-O(arena) headline and grows with
                            arena size.  Under the madvise reclaim policy
                            expect ~4x at 16 MB/1 page (refault included, RSS
                            returned); the pure-memcpy reset was ~100x but
                            kept every touched page resident.
  * ``restore_cow_us``    — stamping out a fresh Faaslet by binding the base
                            MAP_PRIVATE (O(1) in arena size) vs
                            ``restore_copy_us`` paying the full memcpy +
                            ``pickle.loads``.
  * ``pull_push_copies``  — ``GlobalTier.total_copied()`` for a pull +
                            HOGWILD ``push_delta`` of a 4 MB key.  The
                            zero-copy plane (``readinto`` + in-place
                            ``add_inplace``) moves the value **once** end to
                            end; the old bytes-typed path copied it ≥ 2x per
                            direction (get→bytes→frombuffer→assign on pull;
                            get+copy+add+set under the write lock on push).

Push-wire accounting (``state_push_torch/*`` rows, written to ``BENCH_push.json``):
exact vs int8 ``push_delta`` of a 4 MB f32 key — wall time per push, bytes
moved per push (the int8 wire ships the quantised payload + per-row scales,
~26% of the f32 bytes), and the error-feedback residual cap across 10
consecutive pushes (bounded: quantisation error doesn't accumulate).

Pull-wire accounting (``state_pull_torch/*`` rows, written to ``BENCH_pull.json``):
the symmetric direction — a warm 4 MB f32 replica refreshing after a peer
push.  ``full`` re-pulls the whole value (the pre-fabric baseline);
``exact``/``int8`` are delta pulls through the retained window (int8
re-encodes with the fused quantise kernel, ~26% of the full-pull bytes);
``broadcast`` is the push-based path — a subscribed peer replica receives
the wire frame from the tier's fan-out pump.  The refresh here runs right
after the push, before the pump has delivered the frame, so it delta-pulls
one int8 frame (1,081,344 bytes for the 1 Mi-float key) and the late
broadcast is skipped as stale; the reference's row reads the same.  A
refresh after ``GlobalTier.flush_broadcasts()`` moves zero bytes.

Run:  PYTHONPATH=src:. python benchmarks/bench_coldstart_torch.py \
          [--faults | --overload | --trace] [--device cuda|cpu] [--out-dir DIR]
"""
import argparse
import json
import time
from pathlib import Path

import numpy as np

from benchmarks.common import emit
from repro_torch.core import (CONTAINER_OVERHEAD_BYTES, FAASLET_OVERHEAD_BYTES,
                        FaasmRuntime, Faaslet, FunctionDef, ProtoFaaslet)
from repro_torch.core.faaslet import WASM_PAGE
from repro_torch.state.kv import GlobalTier
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.state_push import ops as sp_ops
from repro_torch.state.local import LocalTier

OUT_DIR = Path(__file__).resolve().parents[1] / "artifacts" / "bench_torch"


def _write(out_dir, name: str, obj) -> Path:
    """Write ``obj`` as JSON to ``out_dir/name`` (the directory made)."""
    path = Path(out_dir) / name
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=2)
    return path


def _launches() -> dict:
    """K1's and K2's launch counts so far (they move only on the card)."""
    return {"quantize_delta": sp_ops.LAUNCHES["quantize_delta"].value,
            "apply_delta": sp_ops.LAUNCHES["apply_delta"].value}


def _since(before: dict) -> dict:
    now = _launches()
    return {k: now[k] - before[k] for k in now}


def _noop_init(f: Faaslet):
    f.brk(64 * 1024)
    f.write(0, b"x" * 1024)


def _time_us(fn, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def _bench_cow_reset() -> dict:
    """16 MB arena, one dirty page per call: O(dirty) vs O(arena) reset."""
    arena_mb = 16
    limit = arena_mb * (1 << 20)
    f = Faaslet("bench-cow", "h0", memory_limit=limit)
    f.brk(limit)
    f.write(0, bytes(range(256)) * 16)            # non-trivial snapshot content
    proto = ProtoFaaslet.capture(f, {"weights": list(range(8))})

    cow, _ = proto.restore("h0")                  # builds the shared base once
    n = 50

    def dirty_reset():
        cow.write(3 * WASM_PAGE + 17, b"scratch")   # 1 dirty page
        cow.reset_from_base()
    reset_dirty_us = _time_us(dirty_reset, n)

    full, _ = proto.restore_copy("h0")

    def full_reset():
        full.write(3 * WASM_PAGE + 17, b"scratch")
        full.restore_arena(proto.arena, proto.brk)
    reset_full_us = _time_us(full_reset, n)

    restore_cow_us = _time_us(lambda: proto.restore("h0"), 20)
    restore_copy_us = _time_us(lambda: proto.restore_copy("h0"), 20)

    return {
        "arena_mb": arena_mb,
        "dirty_pages_per_call": 1,
        "reset_dirty_us": reset_dirty_us,
        "reset_full_us": reset_full_us,
        "reset_speedup": reset_full_us / max(reset_dirty_us, 1e-9),
        "restore_cow_us": restore_cow_us,
        "restore_copy_us": restore_copy_us,
        "restore_speedup": restore_copy_us / max(restore_cow_us, 1e-9),
    }


def _bench_state_copies(device="cuda") -> dict:
    """Copy count for pull + push_delta of a 4 MB key: new zero-copy plane
    vs an emulation of the old bytes-typed path."""
    size = 4 << 20
    val = np.zeros(size // 4, np.float32)

    # -- new plane: readinto pull + in-place delta push ----------------------
    gt = GlobalTier(device=device)
    gt.set("w", val.tobytes(), host="up")
    lt = LocalTier("h0", gt)
    gt.reset_metrics()
    t0 = time.perf_counter()
    lt.pull("w")
    lt.snapshot_base("w")
    lt.replica("w").buf.view(np.float32)[123] += 1.0
    lt.push_delta("w")
    new_us = (time.perf_counter() - t0) * 1e6
    new_copied = gt.total_copied()

    # -- old path emulation: every transfer round-trips through bytes --------
    gt2 = GlobalTier(device=device)
    gt2.set("w", val.tobytes(), host="up")
    gt2.reset_metrics()
    extra = 0                                     # local-side copies the old
    t0 = time.perf_counter()                      # LocalTier performed
    buf = np.zeros(size, np.uint8)
    data = gt2.get("w", host="h0")                # tier copy (store -> bytes)
    buf[:] = np.frombuffer(data, np.uint8)        # local copy (bytes -> replica)
    extra += size
    base = buf.copy()                             # snapshot_base full copy
    extra += size
    buf.view(np.float32)[123] += 1.0
    local = buf.view(np.float32).copy()           # push_delta staging copy
    extra += size
    delta = local - base.view(np.float32)
    cur = np.frombuffer(gt2.get("w", host="h0"), np.float32).copy()  # tier+local
    extra += size
    cur[:delta.size] += delta
    gt2.set("w", cur.tobytes(), host="h0")        # tobytes + tier ingest copy
    extra += size
    old_us = (time.perf_counter() - t0) * 1e6
    old_copied = gt2.total_copied() + extra

    return {
        "value_mb": size >> 20,
        "new_bytes_copied": new_copied,
        "new_full_value_copies": new_copied / size,
        "new_wall_us": new_us,
        "old_bytes_copied": old_copied,
        "old_full_value_copies": old_copied / size,
        "old_wall_us": old_us,
    }


def _bench_push_wire(device="cuda") -> dict:
    """Exact vs int8 ``push_delta`` of a 4 MB f32 key: wall time and bytes
    moved per push, same update stream for both wires, residual cap across
    the int8 run."""
    size = 4 << 20
    n = size // 4
    n_pushes = 10
    rng = np.random.default_rng(0)
    updates = [(rng.normal(size=n) * 0.01).astype(np.float32)
               for _ in range(n_pushes)]
    rows = {}
    for wire in ("exact", "int8"):
        before = _launches()
        gt = GlobalTier(device=device)
        gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
        lt = LocalTier("h0", gt)
        lt.pull("w")
        lt.snapshot_base("w")
        view = lt.replica("w").buf.view(np.float32)
        view[:] += updates[0]
        lt.push_delta("w", wire=wire)             # warm the kernel/jit path
        gt.reset_metrics()
        t0 = time.perf_counter()
        for u in updates:
            view[:] += u
            lt.push_delta("w", wire=wire)
        wall = time.perf_counter() - t0
        r = lt.replica("w").residual
        rows[wire] = {
            "value_mb": size >> 20,
            "pushes": n_pushes,
            "push_ms": wall / n_pushes * 1e3,
            "bytes_moved_per_push": gt.bytes_pushed["h0"] / n_pushes,
            "residual_max": float(np.abs(r).max()) if r is not None else 0.0,
            "launches": _since(before),
        }
    rows["wire_ratio"] = (rows["int8"]["bytes_moved_per_push"]
                          / rows["exact"]["bytes_moved_per_push"])
    return rows


def _bench_pull_wire(device="cuda") -> dict:
    """Warm-replica refresh after a peer push, per wire: full re-pull vs
    delta pull (exact / int8) vs peer broadcast (zero-pull convergence)."""
    size = 4 << 20
    n = size // 4
    n_rounds = 10
    rng = np.random.default_rng(1)
    updates = [(rng.normal(size=n) * 0.01).astype(np.float32)
               for _ in range(n_rounds)]
    rows = {}
    for mode in ("full", "exact", "int8", "broadcast"):
        before = _launches()
        gt = GlobalTier(device=device)
        gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
        pusher = LocalTier("p", gt)
        pusher.pull("w")
        pusher.snapshot_base("w")
        view = pusher.replica("w").buf.view(np.float32)
        puller = LocalTier("q", gt)
        if mode == "broadcast":
            puller.subscribe("w")
        else:
            puller.pull("w")
        if mode == "full":
            # pre-fabric baseline: forget the replica each round
            def refresh():
                puller.drop("w")
                return puller.pull("w")
        else:
            def refresh():
                return puller.pull("w", wire=mode if mode != "broadcast"
                                   else None)
        view[:] += updates[0]
        pusher.push_delta("w", wire="int8")       # warm the codec paths
        refresh()
        gt.reset_metrics()
        moved = 0
        t0 = time.perf_counter()
        for u in updates:
            view[:] += u
            pusher.push_delta("w", wire="int8")
            moved += refresh()
        wall = time.perf_counter() - t0
        err = float(np.abs(
            puller.replica("w").buf.view(np.float32)
            - np.frombuffer(gt.get("w", host="check"), np.float32)).max())
        rows[mode] = {
            "value_mb": size >> 20,
            "rounds": n_rounds,
            "refresh_ms": wall / n_rounds * 1e3,
            "pull_bytes_per_refresh": moved / n_rounds,
            "broadcast_bytes": gt.total_broadcast(),
            "replica_vs_global_maxerr": err,
            "launches": _since(before),
        }
    rows["pull_ratio_int8_vs_full"] = (
        rows["int8"]["pull_bytes_per_refresh"]
        / max(rows["full"]["pull_bytes_per_refresh"], 1e-9))
    return rows


def _bench_codec_trace(device="cuda") -> dict:
    """``--trace``: arm the telemetry plane and derive the per-wire
    encode-cost curve per value size from the flight recorder — every row
    comes from ``wire.push`` span tags (``encode_ns``, ``nbytes``, span
    wall), not from ad-hoc timers around the push loop.

    Fixed-wire rows (exact/int8/int4/fp8) run with the :class:`WireCostModel`
    armed, so by the time the ``auto`` row runs the model has one bucket of
    evidence per wire at that size and ``WirePolicy`` argmin-picks instead of
    probing.  Each size also gets a ``crossover_mbps`` summary per quantised
    tier: the link bandwidth below which that tier's byte savings outrun its
    extra encode cost (``inf`` when it already wins on this host's
    in-process fabric).  Written to ``BENCH_codec.json`` — the same file
    ``WireCostModel.seed`` pre-loads at arm time."""
    from repro_torch import telemetry
    from repro_torch.state import wire as wire_mod

    sizes_kb = (64, 256, 1024, 4096)
    n_pushes = 8
    fixed = ["exact", "int8"] + [w for w in ("int4", "fp8")
                                 if w in wire_mod.available_wires()]
    quant_tiers = tuple(w for w in fixed if w != "exact")
    curve = {}
    t = telemetry.enable()
    cost = wire_mod.enable_cost_model()
    try:
        for kb in sizes_kb:
            n = (kb << 10) // 4
            rng = np.random.default_rng(kb)
            updates = [(rng.normal(size=n) * 0.01).astype(np.float32)
                       for _ in range(n_pushes)]
            row = {}
            for wire in fixed + ["auto"]:
                gt = GlobalTier(device=device)
                gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
                lt = LocalTier("h0", gt)
                lt.wire_tiers = quant_tiers        # candidates for "auto"
                lt.pull("w")
                lt.snapshot_base("w")
                LocalTier("q", gt).pull("w")       # wire interest: frame it
                view = lt.replica("w").buf.view(np.float32)
                view[:] += updates[0]
                lt.push_delta("w", wire=wire)     # warm the kernel/jit path
                t.drain()                          # discard warm-up spans
                for u in updates:
                    view[:] += u
                    lt.push_delta("w", wire=wire)
                pushes = [s for s in t.drain() if s.name == "wire.push"]
                assert len(pushes) == n_pushes, (wire, kb, len(pushes))
                if wire != "auto":
                    assert all(s.tags["wire"] == wire for s in pushes)
                enc_us = sorted(s.tags["encode_ns"] / 1e3 for s in pushes)
                wall_us = sorted(s.dur * 1e6 for s in pushes)
                row[wire] = {
                    "pushes": n_pushes,
                    "encode_us_p50": enc_us[n_pushes // 2],
                    "push_us_p50": wall_us[n_pushes // 2],
                    "bytes_per_push": sum(s.tags["nbytes"]
                                          for s in pushes) / n_pushes,
                }
                if wire == "auto":
                    row[wire]["wires_chosen"] = sorted(
                        {s.tags["wire"] for s in pushes})
            for w in quant_tiers:
                row[f"encode_ratio_{w}_vs_exact"] = (
                    row[w]["encode_us_p50"]
                    / max(row["exact"]["encode_us_p50"], 1e-9))
                row[f"bytes_ratio_{w}_vs_exact"] = (
                    row[w]["bytes_per_push"]
                    / max(row["exact"]["bytes_per_push"], 1e-9))
            # crossover: bytes saved per extra encode-us = the link MB/s
            # below which the quantised tier wins end-to-end wall-clock
            xover = {}
            for w in quant_tiers:
                saved = (row["exact"]["bytes_per_push"]
                         - row[w]["bytes_per_push"])
                extra_us = (row[w]["push_us_p50"]
                            - row["exact"]["push_us_p50"])
                xover[w] = ("inf" if extra_us <= 0.0
                            else round(saved / extra_us, 1))
            row["crossover_mbps"] = xover
            curve[f"{kb}kb"] = row
    finally:
        wire_mod.disable_cost_model()
        telemetry.disable()
    return {"value_kb": list(sizes_kb), "source": "wire.push spans",
            "cost_model_samples": cost.samples, **curve}


def run_trace(device="cuda", out_dir=OUT_DIR) -> dict:
    device = resolve_device(device)
    tr = _bench_codec_trace(device)
    for kb in tr["value_kb"]:
        row = tr[f"{kb}kb"]
        for w in ("int8", "int4", "fp8"):
            if w not in row:
                continue
            emit(f"codec_torch/encode_{w}_{kb}kb_us", row[w]["encode_us_p50"],
                 f"{row[f'encode_ratio_{w}_vs_exact']:.1f}x exact encode, "
                 f"{row[f'bytes_ratio_{w}_vs_exact'] * 100:.0f}% of exact "
                 f"bytes, wins below {row['crossover_mbps'][w]} MB/s")
        emit(f"codec_torch/encode_exact_{kb}kb_us", row["exact"]["encode_us_p50"],
             f"{row['exact']['bytes_per_push'] / 1e6:.2f}MB/push")
        emit(f"codec_torch/push_auto_{kb}kb_us", row["auto"]["push_us_p50"],
             f"cost model chose {'/'.join(row['auto']['wires_chosen'])}")
    _write(out_dir, "BENCH_codec.json", tr)
    big = tr[f"{tr['value_kb'][-1]}kb"]
    print(f"# codec curve written to {out_dir}/BENCH_codec.json (from "
          f"wire.push "
          f"spans): at {tr['value_kb'][-1]}KB int8 encode costs "
          f"{big['encode_ratio_int8_vs_exact']:.1f}x exact for "
          f"{big['bytes_ratio_int8_vs_exact'] * 100:.0f}% of the bytes; "
          f"auto picked {'/'.join(big['auto']['wires_chosen'])}")
    return tr


def _bench_faults(device="cuda") -> dict:
    """Failure recovery and degraded-mode throughput (docs/fault_model.md):
    latency from a host kill to the lost call's settle (detect -> requeue
    with backoff -> re-execute), and fan-out RPS as the cluster loses
    hosts."""
    # -- recovery latency: kill the host under a running call -----------------
    def napper(api):
        time.sleep(0.03)
        api.write_call_output(b"ok")
        return 0

    lat_ms = []
    for _ in range(5):
        rt = FaasmRuntime(n_hosts=2, capacity=1, backoff=0.001,
                         device=device)
        try:
            rt.upload(FunctionDef("nap", napper))
            cid = rt.invoke("nap")
            deadline = time.perf_counter() + 5.0
            victim = None
            while victim is None and time.perf_counter() < deadline:
                victim = next((h for h in rt.alive_hosts()
                               if h._inflight > 0), None)
            t0 = time.perf_counter()
            rt.fail_host(victim.id)
            assert rt.wait(cid, timeout=30) == 0
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            assert rt.call(cid).attempts >= 2
        finally:
            rt.shutdown()
    lat_ms.sort()
    rows = {"recovery": {
        "samples": len(lat_ms),
        "call_body_ms": 30.0,
        "kill_to_settle_ms_p50": lat_ms[len(lat_ms) // 2],
        "kill_to_settle_ms_max": lat_ms[-1],
    }}

    # -- degraded throughput: fan-out RPS as hosts die -------------------------
    # the call carries a fixed 10 ms body and each host only 2 executor
    # slots, so the cell measures serving *capacity* (slots × body) and not
    # dispatcher overhead — a zero-work echo on wide hosts made the curve
    # track per-host bookkeeping costs (which drop as hosts die) and come
    # out non-monotone
    def echo(api):
        time.sleep(0.01)
        api.write_call_output(api.read_call_input())
        return 0

    n_calls = 400
    degraded = {}
    for dead in (0, 1, 2, 4):
        # best-of-3 with a fresh cluster per repeat: a single cold repeat
        # mixes first-touch costs (proto capture, warm-pool registration,
        # allocator growth) into the steady-state RPS unevenly across cells,
        # which is what made the published curve non-monotone
        best = None
        for _rep in range(3):
            rt = FaasmRuntime(n_hosts=6, capacity=2, device=device)
            try:
                rt.upload(FunctionDef("echo", echo))
                for hid in list(rt.hosts)[:dead]:
                    rt.fail_host(hid)
                # warm every alive host's pool before timing (two rounds:
                # the first registers the warm set, the second exercises it)
                for _ in range(2):
                    rt.wait_all(rt.invoke_many("echo", [b"w"] * 64),
                                timeout=30)
                t0 = time.perf_counter()
                rcs = rt.wait_all(rt.invoke_many("echo", [b"x"] * n_calls),
                                  timeout=60)
                wall = time.perf_counter() - t0
                row = {
                    "alive_hosts": len(rt.alive_hosts()),
                    "calls": n_calls,
                    "ok": sum(1 for r in rcs if r == 0),
                    "rps": n_calls / wall,
                    "repeats": 3,
                }
                if best is None or row["rps"] > best["rps"]:
                    best = row
            finally:
                rt.shutdown()
        degraded[f"dead_{dead}"] = best
    base = degraded["dead_0"]["rps"]
    for row in degraded.values():
        row["rps_vs_healthy"] = row["rps"] / max(base, 1e-9)
    rows["degraded"] = degraded
    return rows


def run_faults(device="cuda", out_dir=OUT_DIR) -> dict:
    device = resolve_device(device)
    fr = _bench_faults(device)
    rec, deg = fr["recovery"], fr["degraded"]
    emit("faults_torch/recovery_ms_p50", rec["kill_to_settle_ms_p50"],
         f"kill->settle incl. {rec['call_body_ms']:.0f}ms re-run body")
    for name, row in deg.items():
        emit(f"faults_torch/rps_{name}", row["rps"],
             f"{row['alive_hosts']} alive, {row['ok']}/{row['calls']} ok, "
             f"{row['rps_vs_healthy'] * 100:.0f}% of healthy")
    _write(out_dir, "BENCH_faults.json", fr)
    print(f"# fault recovery written to {out_dir}/BENCH_faults.json: p50 "
          f"{rec['kill_to_settle_ms_p50']:.1f}ms kill->settle, "
          f"{deg['dead_4']['rps_vs_healthy'] * 100:.0f}% RPS at 4 dead hosts")
    return fr


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[i]


def _overload_cell(policy, rate, duration_s, deadline_s, body_s,
                   n_hosts, capacity, device="cuda"):
    """One open-loop cell: submit ``rate`` calls/s for ``duration_s``
    against a fresh cluster, then drain and classify every call.

    Open loop is the point — the submitter never waits for completions, so
    an overloaded cluster sees the full offered rate instead of the closed
    loop's self-throttling.  Pacing is batched on a 10 ms tick (fine enough
    for kHz rates without fighting sleep granularity)."""
    from repro_torch import overload as oload

    rt = FaasmRuntime(n_hosts=n_hosts, capacity=capacity, overload=policy,
                      device=device)
    try:
        def work(api):
            time.sleep(body_s)
            return 0

        rt.upload(FunctionDef("work", work))
        rt.wait_all(rt.invoke_many("work", [b""] * n_hosts * capacity),
                    timeout=30)                        # warm the pool
        tick = 0.01
        per_tick = max(1, int(rate * tick))
        cids = []
        t0 = time.perf_counter()
        i = 0
        while True:
            now = time.perf_counter() - t0
            if now >= duration_s:
                break
            target = min(int(rate * duration_s), int(rate * (now + tick)))
            burst = target - i
            if burst > 0:
                cids.extend(rt.invoke_many("work", [b""] * burst))
                i += burst
            time.sleep(max(0.0, (i / rate) - (time.perf_counter() - t0)))
        offered = len(cids)
        rt.wait_all(cids, timeout=120)
        served_lat, shed_lat, n_deadline, n_late = [], [], 0, 0
        for cid in cids:
            c = rt.call(cid)
            lat = (c.t_end - c.t_submit)
            if c.return_code == 0:
                # an unbounded baseline has no deadline enforcement: a call
                # that "succeeds" after the budget is still dead work, so
                # goodput counts only in-budget completions for both configs
                if lat <= deadline_s:
                    served_lat.append(lat * 1e3)
                else:
                    n_late += 1
            elif c.return_code == oload.DEADLINE_RC:
                n_deadline += 1
            elif c.return_code == oload.SHED_RC:
                shed_lat.append(lat * 1e3)
        served_lat.sort()
        shed_lat.sort()
        return {
            "offered_rps": offered / duration_s,
            "offered": offered,
            "served_in_deadline": len(served_lat),
            "late": n_late,
            "shed": len(shed_lat),
            "deadline_expired": n_deadline,
            "goodput_rps": len(served_lat) / duration_s,
            "served_ms_p50": _percentile(served_lat, 0.5),
            "served_ms_p99": _percentile(served_lat, 0.99),
            "shed_ms_p99": _percentile(shed_lat, 0.99),
        }
    finally:
        rt.shutdown()


def _bench_overload(device="cuda") -> dict:
    """Open-loop overload sweep (docs/fault_model.md "Overload model"):
    goodput and tail latency as offered load passes saturation, with the
    full control plane armed (bounded queues + shedding + end-to-end
    deadlines) vs the unbounded baseline.

    The defended cluster's contract: goodput at 2x saturation stays within
    ~80% of peak (load is refused in microseconds, served work still meets
    its deadline), and the p99 of *shed* calls sits orders of magnitude
    under the p99 of served ones — failing fast is the feature.  The
    baseline row shows the alternative: an unbounded queue accepts
    everything and converts overload into latency, collapsing goodput once
    queueing delay eats the deadline budget."""
    from repro_torch import overload as oload

    n_hosts, capacity, body_s, deadline_s = 4, 4, 0.008, 0.25
    # long enough for an unbounded queue to build real backlog at 2x (the
    # collapse only shows once queueing delay crosses the deadline budget)
    duration_s = 2.0
    # saturation: every executor slot busy with the call body
    sat_rps = n_hosts * capacity / body_s

    # queue depth = capacity: deep enough to ride out submission-tick
    # bursts at saturation, shallow enough that full-queue wait (~depth *
    # body) stays an order of magnitude under the deadline budget
    depth = capacity

    def defended():
        return oload.OverloadPolicy(
            max_queue_depth=depth,
            default_deadline_s=deadline_s,
            deadline_floor_s=body_s)

    sweep = {}
    for mult in (0.5, 1.0, 2.0, 4.0):
        sweep[f"x{mult:g}"] = _overload_cell(
            defended(), rate=mult * sat_rps, duration_s=duration_s,
            deadline_s=deadline_s, body_s=body_s,
            n_hosts=n_hosts, capacity=capacity, device=device)
    peak = max(c["goodput_rps"] for c in sweep.values())
    for c in sweep.values():
        c["goodput_vs_peak"] = c["goodput_rps"] / max(peak, 1e-9)

    # the collapse row: same cluster, no control plane, 2x offered load
    baseline = _overload_cell(
        None, rate=2.0 * sat_rps, duration_s=duration_s,
        deadline_s=deadline_s, body_s=body_s,
        n_hosts=n_hosts, capacity=capacity, device=device)
    baseline["goodput_vs_peak"] = baseline["goodput_rps"] / max(peak, 1e-9)

    return {
        "config": {"n_hosts": n_hosts, "capacity": capacity,
                   "body_ms": body_s * 1e3, "deadline_ms": deadline_s * 1e3,
                   "saturation_rps": sat_rps, "duration_s": duration_s,
                   "max_queue_depth": depth},
        "defended": sweep,
        "unbounded_baseline_x2": baseline,
        "peak_goodput_rps": peak,
    }


def run_overload(device="cuda", out_dir=OUT_DIR) -> dict:
    device = resolve_device(device)
    res = _bench_overload(device)
    sweep, base = res["defended"], res["unbounded_baseline_x2"]
    for name, c in sweep.items():
        emit(f"overload_torch/goodput_{name}", c["goodput_rps"],
             f"{c['goodput_vs_peak'] * 100:.0f}% of peak; "
             f"served p99 {c['served_ms_p99']:.1f}ms, "
             f"shed p99 {c['shed_ms_p99']:.2f}ms, "
             f"{c['shed']}/{c['offered']} shed")
    emit("overload_torch/goodput_baseline_x2", base["goodput_rps"],
         f"unbounded queue at 2x: {base['goodput_vs_peak'] * 100:.0f}% of "
         f"defended peak, {base['late']} late completions")
    _write(out_dir, "BENCH_overload.json", res)
    x2 = sweep["x2"]
    print(f"# overload sweep written to {out_dir}/BENCH_overload.json: "
          f"goodput at 2x "
          f"= {x2['goodput_vs_peak'] * 100:.0f}% of peak, shed p99 "
          f"{x2['shed_ms_p99']:.2f}ms vs served p99 "
          f"{x2['served_ms_p99']:.1f}ms; unbounded baseline "
          f"{base['goodput_vs_peak'] * 100:.0f}% of peak")
    return res


def main(device="cuda", out_dir=OUT_DIR) -> dict:
    """Every row of the reference's ``main``; returns the sections'
    results (``cow_reset``, ``state_plane``, ``push``, ``pull``,
    ``faults``)."""
    device = resolve_device(device)
    # --- init latency: fresh Faaslet vs Proto restore (Tab. 3) ------------------
    n = 200
    t0 = time.perf_counter()
    for _ in range(n):
        f = Faaslet("bench", "h0")
        _noop_init(f)
    fresh_us = (time.perf_counter() - t0) / n * 1e6

    f = Faaslet("bench", "h0")
    _noop_init(f)
    proto = ProtoFaaslet.capture(f)
    proto.restore("h0")                            # decode the base once
    t0 = time.perf_counter()
    for _ in range(n):
        proto.restore("h0")
    restore_us = (time.perf_counter() - t0) / n * 1e6

    # container-sim: full re-init incl. a fresh private state copy (data ship)
    state = np.zeros(1 << 20, np.uint8)            # 1 MB "image layer"
    t0 = time.perf_counter()
    for _ in range(n):
        g = Faaslet("bench", "h0")
        _noop_init(g)
        _ = state.copy()
    container_us = (time.perf_counter() - t0) / n * 1e6

    emit("tab3_init_torch/faaslet", fresh_us, "fresh faaslet init")
    emit("tab3_init_torch/proto_restore", restore_us,
         f"{fresh_us / max(restore_us, 1e-9):.1f}x faster than fresh")
    emit("tab3_init_torch/container_sim", container_us,
         f"{container_us / max(restore_us, 1e-9):.0f}x slower than proto")

    # --- memory footprint (Tab. 3) -------------------------------------------------
    emit("tab3_mem_torch/faaslet_kb", FAASLET_OVERHEAD_BYTES / 1024, "per instance")
    emit("tab3_mem_torch/container_kb", CONTAINER_OVERHEAD_BYTES / 1024,
         f"{CONTAINER_OVERHEAD_BYTES / FAASLET_OVERHEAD_BYTES:.0f}x faaslet")
    emit("tab3_mem_torch/proto_snapshot_kb", proto.size_bytes() / 1024,
         "snapshot transport size")

    # --- churn (Fig. 10): sustained instance creations per second ----------------
    t0 = time.perf_counter()
    count = 0
    while time.perf_counter() - t0 < 1.0:
        proto.restore("h0")
        count += 1
    emit("fig10_churn_torch/proto_per_s", 1e6 / count, f"{count} restores/s")
    t0 = time.perf_counter()
    count = 0
    while time.perf_counter() - t0 < 1.0:
        g = Faaslet("bench", "h0")
        _noop_init(g)
        count += 1
    emit("fig10_churn_torch/fresh_per_s", 1e6 / count, f"{count} inits/s")

    # --- copy accounting: O(dirty) reset + zero-copy state plane -----------------
    cow = _bench_cow_reset()
    emit("state_copy_torch/reset_dirty_us", cow["reset_dirty_us"],
         f"{cow['arena_mb']}MB arena, 1 dirty page")
    emit("state_copy_torch/reset_full_us", cow["reset_full_us"],
         f"{cow['reset_speedup']:.1f}x slower than dirty reset")
    emit("state_copy_torch/restore_cow_us", cow["restore_cow_us"],
         f"{cow['restore_speedup']:.1f}x faster than full-copy restore")

    st = _bench_state_copies(device)
    emit("state_copy_torch/pull_push_delta_copies", st["new_full_value_copies"],
         f"{st['value_mb']}MB key; old path {st['old_full_value_copies']:.1f} copies")
    emit("state_copy_torch/pull_push_delta_us", st["new_wall_us"],
         f"old path {st['old_wall_us']:.0f}us")

    results = {"cow_reset": cow, "state_plane": st}
    _write(out_dir, "BENCH_state.json", results)
    print(f"# copy accounting written to {out_dir}/BENCH_state.json: "
          f"reset {cow['reset_speedup']:.1f}x, "
          f"pull+push_delta {st['new_full_value_copies']:.2f} full-value copies")

    # --- push wire: exact vs int8 quantised delta (kernels/state_push) -----------
    pw = _bench_push_wire(device)
    emit("state_push_torch/exact_ms", pw["exact"]["push_ms"],
         f"{pw['exact']['value_mb']}MB key, "
         f"{pw['exact']['bytes_moved_per_push'] / 1e6:.2f}MB/push")
    emit("state_push_torch/int8_ms", pw["int8"]["push_ms"],
         f"{pw['int8']['bytes_moved_per_push'] / 1e6:.2f}MB/push "
         f"({pw['wire_ratio'] * 100:.0f}% of exact bytes)")
    emit("state_push_torch/int8_residual_max", pw["int8"]["residual_max"],
         f"error-feedback cap after {pw['int8']['pushes']} pushes")
    _write(out_dir, "BENCH_push.json", pw)
    print(f"# push wire written to {out_dir}/BENCH_push.json: int8 moves "
          f"{pw['wire_ratio'] * 100:.1f}% of exact bytes, residual "
          f"{pw['int8']['residual_max']:.2e}")

    # --- pull wire: warm-replica refresh through the symmetric fabric ------------
    pl = _bench_pull_wire(device)
    emit("state_pull_torch/full_ms", pl["full"]["refresh_ms"],
         f"{pl['full']['value_mb']}MB re-pull, "
         f"{pl['full']['pull_bytes_per_refresh'] / 1e6:.2f}MB/refresh")
    emit("state_pull_torch/exact_ms", pl["exact"]["refresh_ms"],
         f"{pl['exact']['pull_bytes_per_refresh'] / 1e6:.2f}MB/refresh "
         f"(delta pull)")
    emit("state_pull_torch/int8_ms", pl["int8"]["refresh_ms"],
         f"{pl['int8']['pull_bytes_per_refresh'] / 1e6:.2f}MB/refresh "
         f"({pl['pull_ratio_int8_vs_full'] * 100:.0f}% of full-pull bytes)")
    emit("state_pull_torch/broadcast_pull_bytes",
         pl["broadcast"]["pull_bytes_per_refresh"],
         f"subscribed peer; {pl['broadcast']['broadcast_bytes'] / 1e6:.2f}MB "
         f"fanned out push-side")
    _write(out_dir, "BENCH_pull.json", pl)
    print(f"# pull wire written to {out_dir}/BENCH_pull.json: int8 refresh "
          f"moves "
          f"{pl['pull_ratio_int8_vs_full'] * 100:.1f}% of full-pull bytes; "
          f"broadcast peer pulls "
          f"{pl['broadcast']['pull_bytes_per_refresh']:.0f} bytes")

    # --- failure recovery + degraded-mode throughput ------------------------------
    fr = run_faults(device, out_dir)
    return {"cow_reset": cow, "state_plane": st, "push": pw, "pull": pl,
            "faults": fr}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--faults", action="store_true",
                       help="just the failure rows")
    which.add_argument("--overload", action="store_true",
                       help="open-loop overload sweep")
    which.add_argument("--trace", action="store_true",
                       help="span-derived codec curve")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out-dir", default=str(OUT_DIR),
                    help="where the JSON files go (default "
                         "artifacts/bench_torch)")
    args = ap.parse_args()
    if args.faults:
        run_faults(args.device, args.out_dir)
    elif args.overload:
        run_overload(args.device, args.out_dir)
    elif args.trace:
        run_trace(args.device, args.out_dir)
    else:
        main(args.device, args.out_dir)
