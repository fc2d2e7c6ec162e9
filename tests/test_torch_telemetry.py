"""The telemetry plane of ``tests/test_telemetry.py`` through the port.

Every test of the reference's file, with the same names, parametrised
cases and markers, run through ``repro_torch.telemetry`` and the port's
runtime and state tiers on ``device="cpu"``: compile-out (disarmed hook
sites leave no ring-buffer writes), span trees (a speculation twin and a
retry after a crash as sibling spans of one logical call, fault-point
hits as instant spans), wire-span tags, histogram percentiles against
numpy, the registry's text and HTTP endpoint, the Chrome/Perfetto
export's schema, and the sanitizer integration.  ``test_traced_chaos_smoke``
runs the port's telemetry under the port's sanitizer.  Each twin asserts
what its reference test asserts.

The port's sanitizer is its own (``repro_torch.analysis.sanitizer``):
``tests/conftest.py`` drives the reference's, so the fixtures of
``tests/torch_twin_planes.py`` turn the port's on for ``sanitize``-marked
tests (and under ``FAASM_SANITIZE=1``), fail a test on any report it
did not take, and disarm the port's fault, telemetry and cost-model
planes after every test.
"""
import json
import threading
import time

import numpy as np
import pytest

from repro_torch import faults, telemetry
from repro_torch.core import FaasmRuntime as _FaasmRuntime
from repro_torch.core import FunctionDef
from repro_torch.state.ddo import VectorAsync
from repro_torch.state.kv import GlobalTier as _GlobalTier
from repro_torch.state.local import LocalTier
from repro_torch.telemetry import clock, metrics, spans, trace
from torch_twin_planes import port_planes_disarmed, port_sanitize  # noqa: F401


def GlobalTier(*args, **kwargs):
    """The port's global tier with its codec on the CPU."""
    return _GlobalTier(*args, device="cpu", **kwargs)


def FaasmRuntime(*args, **kwargs):
    """The port's runtime on the CPU."""
    return _FaasmRuntime(*args, device="cpu", **kwargs)


KEY = "w"


def _global(gt, key=KEY):
    return np.frombuffer(gt.get(key, host="check"), np.float32)


def _fabric(n_floats=256):
    gt = GlobalTier()
    gt.set(KEY, np.zeros(n_floats, np.float32).tobytes(), host="seed")
    t = LocalTier("push0", gt)
    t.pull(KEY)
    t.snapshot_base(KEY)
    return gt, t


def _spans_named(span_list, name):
    return [s for s in span_list if s.name == name]


# -- compile-out --------------------------------------------------------------

def test_disarmed_hooks_compile_out():
    """Disarmed, every hook slot is None and a full runtime + fabric
    workload performs zero ring-buffer writes."""
    from repro_torch.core import runtime as runtime_mod
    from repro_torch.state import kv as kv_mod
    from repro_torch.state import local as local_mod

    assert not telemetry.enabled()
    for mod in (runtime_mod, kv_mod, local_mod, faults):
        assert mod._TEL is None

    gt, t = _fabric()
    t.replica(KEY).buf.view(np.float32)[0] += 1.0
    t.push_delta(KEY, wire="exact")
    gt.pull_wire(KEY, 0, host="other")

    rt = FaasmRuntime(n_hosts=1)
    try:
        rt.upload(FunctionDef("echo", lambda api: 0))
        assert rt.wait(rt.invoke("echo"), timeout=10) == 0
    finally:
        rt.shutdown()

    # arming *after* the workload finds a tracer that never saw a write
    tr = telemetry.enable()
    assert tr.writes == 0
    assert tr.spans() == []


def test_enable_disable_installs_hooks():
    from repro_torch.core import runtime as runtime_mod
    from repro_torch.state import kv as kv_mod
    from repro_torch.state import local as local_mod

    t = telemetry.enable()
    assert telemetry.enable() is t               # idempotent
    for mod in (runtime_mod, kv_mod, local_mod, faults):
        assert mod._TEL is t
    telemetry.disable()
    for mod in (runtime_mod, kv_mod, local_mod, faults):
        assert mod._TEL is None


def test_ring_drop_oldest():
    tr = spans.Tracer()
    for i in range(spans._RING_CAPACITY + 100):
        tr.record("x", "call", float(i), float(i) + 0.5, idx=i)
    got = tr.take()
    assert tr.dropped == 100
    assert len(got) == spans._RING_CAPACITY
    # oldest 100 were dropped; survivors come back in t0 order
    assert got[0].tags["idx"] == 100
    assert [s.t0 for s in got] == sorted(s.t0 for s in got)


# -- the single clock ---------------------------------------------------------

def test_call_timing_single_clock():
    """Call.t_* all come from telemetry.clock; queue_wait/exec_wall are
    derived and sum to the settled latency."""
    rt = FaasmRuntime(n_hosts=1)
    try:
        rt.upload(FunctionDef("nap", lambda api: time.sleep(0.02) or 0))
        cid = rt.invoke("nap")
        assert rt.wait(cid, timeout=10) == 0
        c = rt.call(cid)
        assert c.queue_wait >= 0.0
        assert c.exec_wall >= 0.02
        assert abs(c.latency - (c.queue_wait + c.exec_wall)) < 1e-9
    finally:
        rt.shutdown()


# -- span trees ---------------------------------------------------------------

def test_call_lifecycle_spans():
    t = telemetry.enable()
    rt = FaasmRuntime(n_hosts=1)
    try:
        rt.upload(FunctionDef("echo", lambda api: 0))
        cid = rt.invoke("echo")
        assert rt.wait(cid, timeout=10) == 0
        rt.wait_all([rt.invoke("echo")], timeout=10)
        got = t.spans()
        for name in ("call.queue", "call.restore", "call.exec",
                     "call.reset", "call.settle"):
            assert _spans_named(got, name), name
        ex = _spans_named(got, "call.exec")
        assert any(s.call == cid for s in ex)
        s = next(s for s in ex if s.call == cid)
        assert s.fence == rt.call(cid).fence_id
        assert s.host is not None and s.t1 >= s.t0
        assert s.tags["status"] == "done" and s.tags["rc"] == 0
        settle = next(x for x in _spans_named(got, "call.settle")
                      if x.call == cid)
        assert settle.tags["queue_wait"] >= 0.0
        assert settle.tags["exec_wall"] > 0.0
    finally:
        rt.shutdown()
        telemetry.disable()


def test_speculation_twin_sibling_spans():
    """A straggler's speculative twin shares the primary's fence with a
    distinct epoch and call id — sibling spans of one logical call."""
    t = telemetry.enable()
    rt = FaasmRuntime(n_hosts=2, straggler_timeout=0.3)
    try:
        state = {"n": 0}

        def sometimes_slow(api):
            state["n"] += 1
            if state["n"] == 1:
                time.sleep(2.5)
            return 0

        rt.upload(FunctionDef("s", sometimes_slow))
        cid = rt.invoke("s")
        assert rt.wait(cid, timeout=30) == 0
        fence = rt.call(cid).fence_id
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            fam = [s for s in t.spans()
                   if s.fence == fence and s.name == "call.exec"]
            if len({s.epoch for s in fam}) >= 2:
                break
            time.sleep(0.1)
        assert len({s.epoch for s in fam}) >= 2, fam      # twin + primary
        assert len({s.call for s in fam}) >= 2, fam       # distinct attempts
    finally:
        rt.shutdown()
        telemetry.disable()


def test_retry_after_crash_sibling_spans():
    """A call requeued past a dead host re-runs under the same fence with
    a bumped epoch; both attempts' spans are visible."""
    t = telemetry.enable()
    rt = FaasmRuntime(n_hosts=2, capacity=1, backoff=0.001)
    try:
        release = threading.Event()

        def gated(api):
            release.wait(10.0)
            return 0

        rt.upload(FunctionDef("gated", gated))
        cid = rt.invoke("gated")
        deadline = time.monotonic() + 5.0
        victim = None
        while victim is None and time.monotonic() < deadline:
            victim = next((h for h in rt.alive_hosts()
                           if h._inflight > 0), None)
        assert victim is not None
        rt.fail_host(victim.id)
        release.set()
        assert rt.wait(cid, timeout=30) == 0
        got = t.spans()
        fence = rt.call(cid).fence_id
        fam = [s for s in got if s.fence == fence
               and s.name in ("call.queue", "call.exec")]
        assert len({s.epoch for s in fam}) >= 2, fam
        hosts = {s.host for s in fam if s.name == "call.exec"}
        assert victim.id in {s.host for s in fam} or len(hosts) >= 1
    finally:
        rt.shutdown()
        telemetry.disable()


def test_fault_hits_become_instant_spans():
    t = telemetry.enable()
    gt, tier = _fabric()
    sub = LocalTier("sub", gt)
    sub.pull(KEY)
    sub.subscribe(KEY)
    plan = faults.FaultPlan(0).add("wire-frame-drop", nth=1, times=1)
    with faults.armed(plan):
        tier.replica(KEY).buf.view(np.float32)[0] += 1.0
        tier.push_delta(KEY, wire="exact")
        gt.flush_broadcasts()            # the drop fires on the pump thread
    assert plan.fired("wire-frame-drop") == 1
    hits = _spans_named(t.spans(), "fault.wire-frame-drop")
    assert hits and hits[0].tags["action"] == "drop"
    assert hits[0].t0 == hits[0].t1                       # instant
    telemetry.disable()


# -- wire spans ---------------------------------------------------------------

def test_wire_span_tags():
    t = telemetry.enable()
    n = 64 * 1024                     # big enough for the int8 wire
    gt, tier = _fabric(n)
    sub = LocalTier("sub", gt)
    sub.pull(KEY)
    sub.subscribe(KEY)
    tier.replica(KEY).buf.view(np.float32)[:] += 1.0
    tier.push_delta(KEY, wire="int8")
    gt.flush_broadcasts()                # bcast spans record on the pump
    puller = LocalTier("puller", gt)
    puller.pull(KEY)
    got = t.spans()

    push = _spans_named(got, "wire.push")
    assert push, got
    p = push[-1]
    assert p.tags["key"] == KEY and p.tags["wire"] == "int8"
    assert p.tags["nbytes"] > 0 and p.tags["encode_ns"] > 0
    assert p.tags["version"] == p.tags["prev_version"] + 1

    bcast = _spans_named(got, "wire.bcast")
    assert bcast and bcast[-1].tags["applied"] is True
    assert bcast[-1].tags["subscriber"] == "sub"

    # the cold pull moved the full value
    full = _spans_named(got, "wire.full_pull")
    assert full and full[-1].tags["puller"] == "puller"
    assert full[-1].tags["nbytes"] > 0
    telemetry.disable()


def test_fence_reject_instant():
    t = telemetry.enable()
    gt = GlobalTier()
    assert gt.fence_admit(KEY, ("c1", 1, 1)) is True
    gt.fence_supersede("c1", 2)
    assert gt.fence_admit(KEY, ("c1", 2, 2)) is False     # dead epoch
    assert gt.fence_rejections == 1
    rej = _spans_named(t.spans(), "fence.reject")
    assert rej and rej[0].fence == "c1" and rej[0].epoch == 2
    assert rej[0].tags["key"] == KEY and rej[0].tags["seq"] == 2
    telemetry.disable()


# -- metrics registry ---------------------------------------------------------

def test_metric_name_validation():
    reg = metrics.Registry()
    with pytest.raises(ValueError):
        reg.counter("bad_name")
    with pytest.raises(ValueError):
        reg.gauge("faasm_thing")                          # no unit suffix
    with pytest.raises(ValueError):
        reg.histogram("faasm_Upper_case_ms")
    c = reg.counter("faasm_test_things_total")
    assert reg.counter("faasm_test_things_total") is c    # get-or-create
    with pytest.raises(TypeError):
        reg.gauge("faasm_test_things_total")              # kind mismatch
    with pytest.raises(ValueError):
        c.inc(-1)


def test_histogram_percentiles_vs_numpy(rng):
    sample = rng.lognormal(mean=1.0, sigma=1.2, size=20_000)
    h = metrics.Histogram("faasm_test_lat_ms")
    for v in sample:
        h.observe(v)
    assert h.count == sample.size
    assert abs(h.sum - float(sample.sum())) < 1e-6 * sample.size
    for p in (0.50, 0.90, 0.99, 0.999):
        want = float(np.percentile(sample, 100 * p))
        got = h.percentile(p)
        # half-bucket geometric error is ~2.2%; allow headroom for the
        # rank-interpolation difference on the tail
        assert abs(got - want) / want < 0.06, (p, got, want)
    assert h.min == pytest.approx(float(sample.min()))
    assert h.max == pytest.approx(float(sample.max()))


def test_histogram_zero_bucket():
    h = metrics.Histogram("faasm_test_zero_ms")
    for v in (0.0, -1.0, 0.0, 5.0):
        h.observe(v)
    assert h.percentile(0.5) == 0.0
    assert h.percentile(0.999) <= 5.0


def test_registry_render_text_and_collector():
    reg = metrics.Registry()
    reg.counter("faasm_test_events_total", "things that happened").inc(3)
    reg.histogram("faasm_test_lat_ms").observe(2.0)
    pulls = {"n": 0}
    reg.register_collector(
        lambda r: r.gauge("faasm_test_live_count").set(
            pulls.__setitem__("n", pulls["n"] + 1) or pulls["n"]))
    text = reg.render_text()
    assert pulls["n"] == 1                                 # collector ran
    assert "# TYPE faasm_test_events_total counter" in text
    assert "faasm_test_events_total 3" in text
    assert 'faasm_test_lat_ms{quantile="0.99"}' in text
    assert "faasm_test_live_count 1" in text
    snap = reg.snapshot()
    assert snap["faasm_test_events_total"] == 3.0
    assert snap["faasm_test_lat_ms_count"] == 1.0


def test_runtime_metrics_single_source_of_truth():
    rt = FaasmRuntime(n_hosts=1)
    try:
        rt.upload(FunctionDef("echo", lambda api: 0))
        for _ in range(3):
            assert rt.wait(rt.invoke("echo"), timeout=10) == 0
        stats = rt.cold_start_stats()
        snap = rt.metrics.snapshot()
        assert snap["faasm_host_warm_hits_total"] == stats["warm_hits"]
        assert snap["faasm_host_resets_total"] == stats["resets"] >= 3
        assert snap["faasm_runtime_calls_done_total"] >= 3
        text = rt.metrics_text()
        assert "faasm_tier_net_bytes" in text
        assert "faasm_host_init_ms" in text
    finally:
        rt.shutdown()


def test_metrics_http_endpoint():
    import urllib.request
    reg = metrics.Registry()
    reg.counter("faasm_test_hits_total").inc()
    srv = metrics.serve_http(reg, 0)                      # ephemeral port
    try:
        port = srv.server_address[1]
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        assert "faasm_test_hits_total 1" in body
    finally:
        srv.shutdown()


# -- Chrome/Perfetto export ---------------------------------------------------

def test_chrome_export_schema(tmp_path):
    t = telemetry.enable()
    n = 64 * 1024
    gt, tier = _fabric(n)
    sub = LocalTier("sub", gt)
    sub.pull(KEY)
    sub.subscribe(KEY)
    tier.replica(KEY).buf.view(np.float32)[:] += 1.0
    tier.push_delta(KEY, wire="int8")
    gt.flush_broadcasts()                # bcast flow-finish records on the pump

    path = tmp_path / "trace.json"
    n_events = trace.export_chrome(str(path))
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    assert len(events) == n_events > 0
    assert doc["displayTimeUnit"] == "ms"
    phases = {e["ph"] for e in events}
    assert "X" in phases and "M" in phases
    for e in events:
        assert e["pid"] == 1 and "tid" in e
        if e["ph"] == "M":
            assert e["name"] == "thread_name" and e["args"]["name"]
            continue
        assert isinstance(e["ts"], float)
        if e["ph"] == "X":
            assert e["dur"] >= 0.0
        if e["ph"] == "i":
            assert e["s"] == "t"
    # wire flow: every finish has a matching start with the same id
    starts = {e["id"] for e in events if e["ph"] == "s"}
    finishes = [e for e in events if e["ph"] == "f"]
    assert starts                                          # push emitted one
    for f in finishes:
        assert f["id"] in starts and f["bp"] == "e"
    telemetry.disable()


# -- sanitizer integration ----------------------------------------------------

@pytest.mark.sanitize
def test_drain_under_key_lock_reported():
    """Ring writes under a fabric lock are fine; a collector drain there
    is a telemetry-under-lock report."""
    from repro_torch.analysis import sanitizer

    t = telemetry.enable()
    gt = GlobalTier()                    # built with sanitizer armed
    gt.set(KEY, np.zeros(8, np.float32).tobytes(), host="seed")
    lock = gt.lock(KEY)
    lock.acquire_write()
    try:
        t.instant("probe.write", "wire", key=KEY)          # allowed
        t.drain()                                          # not allowed
    finally:
        lock.release_write()
    reports = sanitizer.take_reports()
    assert [r.check for r in reports] == ["telemetry-under-lock"], reports
    # outside the lock the same drain is clean
    t.drain()
    assert sanitizer.take_reports() == []
    telemetry.disable()


# -- traced chaos smoke (runs in scripts/tier1.sh via -k smoke) ---------------

@pytest.mark.sanitize
def test_traced_chaos_smoke(tmp_path):
    """Seed-0 runtime chaos with tracing armed under the sanitizer: the
    run converges exactly-once AND exports a non-empty, well-formed
    Perfetto trace with restore/exec/wire spans."""
    t = telemetry.enable()
    rt = FaasmRuntime(n_hosts=2, capacity=2, backoff=0.001)
    try:
        VectorAsync.create(rt.global_tier, KEY, np.zeros(8, np.float32))

        def inc(api):
            v = VectorAsync(api, KEY)
            v.pull(track_delta=True)
            v.add(0, 1.0)
            v.push_delta(wire="exact")
            return 0

        rt.upload(FunctionDef("inc", inc))
        with faults.armed(faults.FaultPlan.random(0)):
            cids = rt.invoke_many("inc", [b""] * 8, state_hint=[KEY])
            assert rt.wait_all(cids, timeout=60) == [0] * 8
        assert _global(rt.global_tier)[0] == 8.0          # exactly once

        names = {s.name for s in t.spans()}
        assert {"call.restore", "call.exec", "wire.push"} <= names, names
        path = tmp_path / "chaos_trace.json"
        n_events = trace.export_chrome(str(path))
        doc = json.loads(path.read_text())
        assert n_events > 0 and len(doc["traceEvents"]) == n_events
        assert all("ph" in e and "pid" in e for e in doc["traceEvents"])
    finally:
        rt.shutdown()
        telemetry.disable()
