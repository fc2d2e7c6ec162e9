"""The chaos suite of ``tests/test_chaos.py`` through the port.

Every scenario of the reference's chaos suite, with the same names,
parametrised cases and markers, run through ``repro_torch``'s runtime,
fault plane, overload control and state tiers on ``device="cpu"`` (the
port's kernels take their plain versions there; the card runs the
matrix in ``chip_smoke.py chaos``).  Each twin asserts what its
reference test asserts: exact global sums, a requeue exactly once,
fenced duplicates and sealed pushes refused, shed counts, retry budgets,
breaker steering, and every replica converged after one repair pull.

The port's sanitizer is its own (``repro_torch.analysis.sanitizer``):
``tests/conftest.py`` drives the reference's, so the fixture below turns
the port's on for ``sanitize``-marked tests (and under
``FAASM_SANITIZE=1``) and fails a test on any report it did not take.
The port's fault, telemetry and cost-model planes are disarmed after
every test.

Where the port's ``state/local.py`` differs from the reference's on
purpose, a twin says so in its docstring.  The storms and runtime
scenarios here hold exact sums in both packages: the port's window-miss
catch-up (``LocalTier._catch_up_locked``) moves a tracked replica in
place where the reference full-pulls, and its buffer mutex keeps every
HOGWILD add, so nothing the reference holds is loosened.
"""
import os
import threading
import time

import numpy as np
import pytest

from repro_torch import cancellation, faults
from repro_torch import overload as oload
from repro_torch.core import BatchTimeout, FaasmRuntime, FunctionDef
from repro_torch.core.chain import scatter_gather
from repro_torch.state.ddo import VectorAsync
from repro_torch.state.kv import GlobalTier
from repro_torch.state.local import INT8_WIRE_MIN_BYTES, LocalTier

KEY = "w"
_SANITIZE_ENV = os.environ.get("FAASM_SANITIZE") == "1"


@pytest.fixture(autouse=True)
def _port_sanitize(request):
    """The port's sanitizer over ``sanitize``-marked tests: on before the
    test builds its tiers (locks are instrumented at construction), and
    any report the test did not take fails it."""
    from repro_torch.analysis import sanitizer
    marked = request.node.get_closest_marker("sanitize") is not None
    if not (_SANITIZE_ENV or marked):
        yield
        return
    sanitizer.enable()
    sanitizer.reset()
    try:
        yield
        leftovers = sanitizer.take_reports()
    finally:
        sanitizer.disable()
    if leftovers:
        pytest.fail("repro_torch sanitizer reports:\n\n"
                    + "\n\n".join(str(r) for r in leftovers), pytrace=False)


@pytest.fixture(autouse=True)
def _port_planes_disarmed():
    """The port's fault, telemetry and cost-model planes never leak from
    one test into the next (conftest disarms the reference's)."""
    yield
    from repro_torch import telemetry
    from repro_torch.state import wire
    faults.disarm()
    telemetry.disable()
    wire.disable_cost_model()


def _global(gt, key=KEY):
    return np.frombuffer(gt.get(key, host="check"), np.float32)


def _fabric(n_floats=256, n_pushers=1, subscriber=False):
    """GlobalTier + warm pusher tiers (delta-base armed) [+ a subscriber]."""
    gt = GlobalTier(device="cpu")
    gt.set(KEY, np.zeros(n_floats, np.float32).tobytes(), host="seed")
    pushers = []
    for i in range(n_pushers):
        t = LocalTier(f"push{i}", gt)
        t.pull(KEY)
        t.snapshot_base(KEY)
        pushers.append(t)
    sub = None
    if subscriber:
        sub = LocalTier("sub", gt)
        sub.pull(KEY)
        sub.subscribe(KEY)
    return gt, pushers, sub


def _view(tier, key=KEY):
    return tier.replica(key).buf.view(np.float32)


# -- compile-out: the disarmed fast path is one pointer compare ---------------

def test_disarmed_points_compile_out():
    assert faults.active() is None
    # disarmed: every site returns False immediately — no validation, no
    # counting, no lock; even an unregistered name is not inspected
    assert faults.point("wire-frame-drop") is False
    assert faults.point("not-a-registered-point") is False
    plan = faults.FaultPlan(seed=7).add("wire-frame-drop")
    assert plan.hits("wire-frame-drop") == 0 and plan.fired() == 0
    # armed: the same site counts against the plan and fires
    with faults.armed(plan):
        assert faults.active() is plan
        assert faults.point("wire-frame-drop", key=KEY) is True   # rule fires
        assert faults.point("wire-frame-drop", key=KEY) is False  # rule spent
        with pytest.raises(ValueError):
            faults.point("not-a-registered-point")     # armed path validates
    assert faults.active() is None
    assert plan.hits("wire-frame-drop") == 2
    assert plan.fired("wire-frame-drop") == 1
    assert plan.log == [("wire-frame-drop", None, KEY, None)]


def test_plan_rejects_unknown_points_and_bad_triggers():
    with pytest.raises(ValueError):
        faults.FaultPlan().add("no-such-point")
    with pytest.raises(ValueError):
        faults.FaultPlan().add("wire-frame-drop", nth=0)
    # the randomized schedule is reproducible and well-formed
    a, b = faults.FaultPlan.random(3), faults.FaultPlan.random(3)
    assert [(r.point, r.nth, r.times) for r in a.rules] == \
        [(r.point, r.nth, r.times) for r in b.rules]
    assert all(r.point in faults.FAULT_POINTS for r in a.rules)


# -- host crashes: re-execution is exactly-once -------------------------------

def _inc_fn(slot=0):
    def inc(api):
        v = VectorAsync(api, KEY)
        v.pull(track_delta=True)
        v.add(slot, 1.0)
        v.push_delta(wire="exact")
        api.write_call_output(b"ok")
        return 0
    return inc


@pytest.mark.sanitize
def test_host_crash_pre_push_requeues_exactly_once():
    """Fail-stop before any global effect: the re-execution's push is the
    only one admitted."""
    rt = FaasmRuntime(n_hosts=2, capacity=1, device="cpu")
    try:
        VectorAsync.create(rt.global_tier, KEY, np.zeros(8, np.float32))
        rt.upload(FunctionDef("inc", _inc_fn()))
        with faults.armed(faults.FaultPlan(seed=1).add(
                "host-crash-pre-push", key=KEY)) as plan:
            cid = rt.invoke("inc")
            assert rt.wait(cid, timeout=30) == 0
            assert plan.fired("host-crash-pre-push") == 1
        assert rt.call(cid).attempts == 2
        assert rt.output(cid) == b"ok"
        assert _global(rt.global_tier)[0] == 1.0
        assert len(rt.alive_hosts()) == 1
    finally:
        rt.shutdown()


@pytest.mark.sanitize
def test_host_crash_post_push_duplicate_is_fenced():
    """Fail-stop AFTER the delta landed globally: the re-execution re-pushes
    the same (call, seq) pair and the fence rejects the duplicate — the
    increment lands exactly once, same as the fault-free run."""
    rt = FaasmRuntime(n_hosts=2, capacity=1, device="cpu")
    try:
        VectorAsync.create(rt.global_tier, KEY, np.zeros(8, np.float32))
        rt.upload(FunctionDef("inc", _inc_fn()))
        with faults.armed(faults.FaultPlan(seed=2).add(
                "host-crash-post-push", key=KEY)) as plan:
            cid = rt.invoke("inc")
            assert rt.wait(cid, timeout=30) == 0
            assert plan.fired("host-crash-post-push") == 1
        assert rt.call(cid).attempts == 2
        assert _global(rt.global_tier)[0] == 1.0     # NOT 2.0: deduplicated
    finally:
        rt.shutdown()


@pytest.mark.sanitize
def test_crash_storm_retries_exhausted_settles_failed():
    """A call crashing on every attempt burns its retry budget and settles
    as failed instead of hanging a waiter (bounded recovery)."""
    rt = FaasmRuntime(n_hosts=4, capacity=1, max_retries=2, backoff=0.001,
                      device="cpu")
    try:
        VectorAsync.create(rt.global_tier, KEY, np.zeros(8, np.float32))
        rt.upload(FunctionDef("inc", _inc_fn()))
        with faults.armed(faults.FaultPlan(seed=3).add(
                "host-crash-pre-push", key=KEY, times=10)):
            cid = rt.invoke("inc")
            rc = rt.wait(cid, timeout=30)
        call = rt.call(cid)
        assert rc != 0 and call.status == "failed"
        assert call.attempts == rt.max_attempts == 3
        assert _global(rt.global_tier)[0] == 0.0      # no partial effect
    finally:
        rt.shutdown()


# -- wire faults: drop / delay / subscriber-raise / codec-error ---------------

def test_wire_frame_drop_repaired_by_pull():
    gt, (p,), sub = _fabric(64, subscriber=True)
    with faults.armed(faults.FaultPlan(seed=4).add(
            "wire-frame-drop", host="sub")) as plan:
        _view(p)[:] += 1.0
        p.push_delta(KEY, wire="exact")              # frame to sub is lost
        gt.flush_broadcasts()                        # drain the async fan-out
        assert plan.fired("wire-frame-drop") == 1
        assert _view(sub)[0] == 0.0                  # sub missed it
        _view(p)[:] += 1.0
        p.push_delta(KEY, wire="exact")              # arrives, but out of
        gt.flush_broadcasts()
        assert _view(sub)[0] == 0.0                  # order: skipped too
    np.testing.assert_array_equal(_global(gt), np.full(64, 2.0, np.float32))
    sub.pull(KEY)                                    # repair via delta window
    np.testing.assert_array_equal(_view(sub)[:64],
                                  np.full(64, 2.0, np.float32))


def test_wire_frame_delay_converges():
    gt, (p,), sub = _fabric(64, subscriber=True)
    with faults.armed(faults.FaultPlan(seed=5).add(
            "wire-frame-delay", host="sub", times=3, delay_s=0.003)) as plan:
        for _ in range(3):
            _view(p)[0] += 1.0
            p.push_delta(KEY, wire="exact")
            gt.flush_broadcasts()        # delivery (and its fault) is async
        assert plan.fired("wire-frame-delay") == 3
    assert _global(gt)[0] == 3.0
    sub.pull(KEY)
    assert _view(sub)[0] == 3.0


def test_subscriber_raise_culled_mid_broadcast():
    """A subscriber blowing up inside the broadcast doesn't poison the push:
    the tier culls it and the pusher's delta still lands globally."""
    gt, (p,), sub = _fabric(64, subscriber=True)
    with faults.armed(faults.FaultPlan(seed=6).add(
            "subscriber-raise", host="sub")) as plan:
        _view(p)[:] += 1.0
        p.push_delta(KEY, wire="exact")              # sub raises mid-delivery
        gt.flush_broadcasts()                        # raise fires on the pump
        assert plan.fired("subscriber-raise") == 1
        assert _global(gt)[0] == 1.0                 # push unaffected
        _view(p)[:] += 1.0
        p.push_delta(KEY, wire="exact")              # sub was culled: no raise
        gt.flush_broadcasts()
    assert _global(gt)[0] == 2.0
    sub.pull(KEY)                                    # catch-up pull repairs
    assert _view(sub)[0] == 2.0


@pytest.mark.sanitize
def test_codec_error_falls_back_to_exact_wire():
    """An int8 encode failure mid-push is rescued by re-pushing the same
    delta on the exact wire — same fence token, so the rescue is still
    exactly-once — and the landed value carries no quantisation error."""
    n = INT8_WIRE_MIN_BYTES // 4                     # int8-eligible size
    gt, (p,), _ = _fabric(n)
    _view(p)[:] += 1.0
    with faults.armed(faults.FaultPlan(seed=7).add("codec-error")) as plan:
        moved = p.push_delta(KEY, wire="int8", fence=("cc", 1, 1))
        assert plan.fired("codec-error") == 1
    assert p.codec_fallbacks == 1
    assert moved > 0
    np.testing.assert_array_equal(_global(gt), np.ones(n, np.float32))
    # the fence token was consumed exactly once: replaying it is rejected
    _view(p)[:] += 1.0
    assert p.push_delta(KEY, wire="exact", fence=("cc", 1, 1)) == 0
    np.testing.assert_array_equal(_global(gt), np.ones(n, np.float32))


# -- attempt-fence semantics at the tier level --------------------------------

@pytest.mark.sanitize
def test_fence_rejects_superseded_duplicate_and_sealed_pushes():
    gt, (a, b), _ = _fabric(16, n_pushers=2)
    one = np.ones(16, np.float32)

    # attempt 1 (epoch 1) pushes its first delta
    _view(a)[:] += 1.0
    assert a.push_delta(KEY, wire="exact", fence=("c9", 1, 1)) > 0
    np.testing.assert_array_equal(_global(gt), one)

    # the runtime requeues: epoch 1 is superseded; the re-execution (epoch 2)
    # deterministically re-derives the same first push — duplicate seq, dropped
    gt.fence_supersede("c9", 1)
    _view(b)[:] += 1.0
    assert b.push_delta(KEY, wire="exact", fence=("c9", 2, 1)) == 0
    np.testing.assert_array_equal(_global(gt), one)
    # ...and the rejected replica was resynced to the global truth
    np.testing.assert_array_equal(_view(b)[:16], one)

    # a zombie write straggling in from the dead epoch is rejected too
    _view(a)[:] += 5.0
    assert a.push_delta(KEY, wire="exact", fence=("c9", 1, 2)) == 0
    np.testing.assert_array_equal(_global(gt), one)

    # epoch 2 advances past the duplicate: a NEW seq is admitted
    _view(b)[:] += 1.0
    assert b.push_delta(KEY, wire="exact", fence=("c9", 2, 2)) > 0
    np.testing.assert_array_equal(_global(gt), one * 2.0)

    # the winning settle seals the fence: a speculative loser (epoch 3)
    # can no longer write under this call
    gt.fence_seal("c9", 2)
    _view(a)[:] += 1.0
    assert a.push_delta(KEY, wire="exact", fence=("c9", 3, 1)) == 0
    np.testing.assert_array_equal(_global(gt), one * 2.0)

    # unrelated calls are untouched by the seal
    _view(a)[:] += 1.0
    assert a.push_delta(KEY, wire="exact", fence=("c10", 1, 1)) > 0
    np.testing.assert_array_equal(_global(gt), one * 3.0)


# -- monitor interleavings (fail_host / monitor_once / zombies) ---------------

def test_fail_host_requeues_queued_and_inflight_calls():
    """Killing a host with a full queue: the running call AND the calls
    still waiting in its pool are all re-executed elsewhere."""
    rt = FaasmRuntime(n_hosts=2, capacity=1, device="cpu")
    try:
        def napper(api):
            time.sleep(0.05)
            api.write_call_output(b"ok:" + api.read_call_input())
            return 0

        rt.upload(FunctionDef("nap", napper))
        cids = rt.invoke_many("nap", [bytes([i]) for i in range(6)])
        deadline = time.monotonic() + 5.0
        victim = None
        while victim is None and time.monotonic() < deadline:
            victim = next((h for h in rt.alive_hosts() if h._inflight > 0),
                          None)
        assert victim is not None
        rt.fail_host(victim.id)
        assert rt.wait_all(cids, timeout=30) == [0] * 6
        for i, cid in enumerate(cids):
            assert rt.output(cid) == b"ok:" + bytes([i])
            assert rt.call(cid).attempts <= rt.max_attempts
    finally:
        rt.shutdown()


def test_dispatch_retries_when_host_dies_between_placement_and_submit(
        monkeypatch):
    """The placement/submit race: the scheduler picks a host that dies
    before ``submit`` lands — the call is re-placed with backoff, not lost
    and not settled as failed."""
    rt = FaasmRuntime(n_hosts=2, device="cpu")
    try:
        def echo(api):
            api.write_call_output(b"ok")
            return 0

        rt.upload(FunctionDef("echo", echo))
        victim = rt.hosts["host0"]
        orig_submit = victim.submit

        def dying_submit(call):
            victim.fail()                # dies in the race window
            return orig_submit(call)     # raises "host is down"

        monkeypatch.setattr(victim, "submit", dying_submit)
        hit = {"n": 0}
        for sched in rt.schedulers.values():
            def place(call, _orig=sched.place):
                if hit["n"] == 0:
                    hit["n"] = 1
                    return victim        # force the race once
                return _orig(call)
            monkeypatch.setattr(sched, "place", place)

        cid = rt.invoke("echo")
        assert rt.wait(cid, timeout=10) == 0
        assert rt.output(cid) == b"ok"
        assert rt.call(cid).attempts == 2
        assert not victim.alive
    finally:
        rt.shutdown()


@pytest.mark.sanitize
def test_zombie_attempt_after_heartbeat_requeue_is_fenced():
    """Heartbeat false positive: a host merely sleeping is declared dead and
    its call requeued.  The zombie attempt later wakes and pushes — under
    its superseded epoch — and the fence drops the write: the increment
    lands exactly once, from the re-execution."""
    rt = FaasmRuntime(n_hosts=2, capacity=1, heartbeat_timeout=0.25,
                      device="cpu")
    try:
        VectorAsync.create(rt.global_tier, KEY, np.zeros(8, np.float32))
        seen = {"n": 0}
        zombie_done = threading.Event()

        def inc(api):
            seen["n"] += 1
            first = seen["n"] == 1
            v = VectorAsync(api, KEY)
            v.pull(track_delta=True)
            v.add(0, 1.0)
            if first:
                time.sleep(0.9)          # silent past the heartbeat timeout
            try:
                v.push_delta(wire="exact")
            finally:
                if first:
                    zombie_done.set()
            api.write_call_output(b"ok")
            return 0

        rt.upload(FunctionDef("inc", inc))
        cid = rt.invoke("inc")
        assert rt.wait(cid, timeout=30) == 0
        assert zombie_done.wait(timeout=10)
        assert seen["n"] == 2                        # requeue did re-execute
        assert rt.call(cid).attempts == 2
        assert len(rt.alive_hosts()) == 1            # false positive killed it
        time.sleep(0.05)                             # let the zombie settle
        assert _global(rt.global_tier)[0] == 1.0     # exactly once
    finally:
        rt.shutdown()


def test_monitor_once_is_noop_without_heartbeat_or_load():
    rt = FaasmRuntime(n_hosts=2, device="cpu")
    try:
        assert rt.monitor_once() == []               # no timeout configured
        assert rt.monitor_once(timeout=0.0) == []    # idle hosts never fail
        assert len(rt.alive_hosts()) == 2
    finally:
        rt.shutdown()


# -- satellites ---------------------------------------------------------------

def test_checkpoint_beats_heartbeat_for_pure_compute():
    """A kernel-style compute loop (no host-interface calls) beats through
    ``cancellation.checkpoint`` and survives a heartbeat timeout shorter
    than the call."""
    rt = FaasmRuntime(n_hosts=1, heartbeat_timeout=0.3, device="cpu")
    try:
        def crunch(api):
            t_end = time.monotonic() + 1.0           # 3x the timeout
            while time.monotonic() < t_end:
                cancellation.checkpoint()            # kernel dispatch hook
                time.sleep(0.005)
            api.write_call_output(b"ok")
            return 0

        rt.upload(FunctionDef("crunch", crunch))
        cid = rt.invoke("crunch")
        assert rt.wait(cid, timeout=30) == 0
        assert rt.call(cid).attempts == 1            # never declared dead
        assert len(rt.alive_hosts()) == 1
    finally:
        rt.shutdown()


def test_failed_call_discards_unpushed_local_deltas():
    """Faaslet-mode: a call that dirties a shared replica and fails before
    pushing must not leak its half-written delta into the next call."""
    rt = FaasmRuntime(n_hosts=1, device="cpu")
    try:
        VectorAsync.create(rt.global_tier, KEY, np.zeros(8, np.float32))
        bomb = {"armed": True}

        def writer(api):
            v = VectorAsync(api, KEY)
            v.pull(track_delta=True)
            v.add(0, 13.0)                           # dirty, never pushed
            if bomb.pop("armed", False):
                raise RuntimeError("boom")
            api.write_call_output(v.values.tobytes())
            return 0

        rt.upload(FunctionDef("writer", writer))
        assert rt.wait(rt.invoke("writer"), timeout=10) == 1
        host = next(iter(rt.hosts.values()))
        assert not host.local_tier.replica(KEY).dirty_chunks
        assert _global(rt.global_tier)[0] == 0.0
        # the next call sees the clean value, not the leaked 13
        c2 = rt.invoke("writer")
        assert rt.wait(c2, timeout=10) == 0
        assert np.frombuffer(rt.output(c2), np.float32)[0] == 13.0
    finally:
        rt.shutdown()


def test_submit_degradable_sheds_below_floor():
    from repro_torch.launch.serve import SHED_RC, submit_degradable
    rt = FaasmRuntime(n_hosts=2, device="cpu")
    try:
        def echo(api):
            api.write_call_output(b"ok")
            return 0

        rt.upload(FunctionDef("echo", echo))
        res = submit_degradable(rt, "echo", [b""] * 4, min_alive_hosts=1)
        assert res["shed"] == 0 and not res["degraded"]
        assert res["codes"] == [0] * 4

        rt.fail_host("host0")
        # below the floor: fail fast (shed) instead of queueing into a
        # cluster that can't serve
        res = submit_degradable(rt, "echo", [b""] * 4, min_alive_hosts=2)
        assert res["degraded"] and res["shed"] == 4
        assert res["codes"] == [SHED_RC] * 4
        assert res["call_ids"] == [None] * 4
        # at the floor: the surviving host still serves everything
        res = submit_degradable(rt, "echo", [b""] * 4, min_alive_hosts=1)
        assert res["shed"] == 0 and res["codes"] == [0] * 4
    finally:
        rt.shutdown()


def test_scatter_gather_retries_settled_failures():
    """Application-level retry above the runtime: children that SETTLE as
    failed (no host loss involved) are re-chained as fresh calls."""
    rt = FaasmRuntime(n_hosts=2, device="cpu")
    try:
        flaked = {}

        def child(api):
            p = bytes(api.read_call_input())
            if p not in flaked:
                flaked[p] = True
                return 1                             # settled failure
            api.write_call_output(b"ok:" + p)
            return 0

        def parent(api):
            pairs = scatter_gather(api, "child", [b"a", b"b"], retries=1)
            assert [rc for rc, _ in pairs] == [0, 0]
            api.write_call_output(b"".join(out for _, out in pairs))
            return 0

        rt.upload(FunctionDef("child", child))
        rt.upload(FunctionDef("parent", parent))
        cid = rt.invoke("parent")
        assert rt.wait(cid, timeout=30) == 0
        assert rt.output(cid) == b"ok:aok:b"
    finally:
        rt.shutdown()


# -- overload control plane ---------------------------------------------------

def test_overload_chaos_smoke_queue_flood_spills_to_peer():
    """An armed queue-flood storm on one host makes its bounded admission
    refuse every submit; the dispatcher spills down the rendezvous ranking
    to the healthy peer and every call still serves — zero sheds."""
    rt = FaasmRuntime(n_hosts=2,
                      overload=oload.OverloadPolicy(max_queue_depth=2),
                      device="cpu")
    try:
        rt.upload(FunctionDef("f", lambda api: 0))
        plan = faults.FaultPlan(seed=3).add("queue-flood", host="host0",
                                            times=64)
        with faults.armed(plan):
            cids = rt.invoke_many("f", [b""] * 6)
            assert rt.wait_all(cids, timeout=30) == [0] * 6
        assert plan.fired("queue-flood") >= 1
        assert rt.spill_total >= 1 and rt.shed_total == 0
        # nothing admitted on the flooded host: every call ran on the peer
        assert {rt._calls[c].host for c in cids} == {"host1"}
    finally:
        rt.shutdown()


def test_queue_flood_everywhere_sheds_fast():
    """When every host's admission refuses (cluster-wide flood), calls
    settle SHED_RC in microseconds instead of queueing invisibly."""
    rt = FaasmRuntime(n_hosts=2,
                      overload=oload.OverloadPolicy(max_queue_depth=1),
                      device="cpu")
    try:
        rt.upload(FunctionDef("f", lambda api: 0))
        plan = faults.FaultPlan(seed=5).add("queue-flood", times=256)
        with faults.armed(plan):
            cids = rt.invoke_many("f", [b""] * 4)
            codes = rt.wait_all(cids, timeout=30)
        assert codes == [oload.SHED_RC] * 4
        assert rt.shed_total == 4
        assert all(rt._calls[c].status == "shed" for c in cids)
    finally:
        rt.shutdown()


def test_deadline_clock_skew_sheds_at_dequeue():
    """A call whose budget evaporates between queue and dequeue (injected
    clock skew) settles DEADLINE_RC at the dequeue check — the function
    body never runs, no executor slot is wasted on doomed work."""
    rt = FaasmRuntime(n_hosts=1,
                      overload=oload.OverloadPolicy(default_deadline_s=0.05),
                      device="cpu")
    try:
        ran = []

        def f(api):
            ran.append(1)
            return 0

        rt.upload(FunctionDef("f", f))
        plan = faults.FaultPlan(seed=7).add("deadline-clock-skew",
                                            delay_s=0.15)
        with faults.armed(plan):
            cid = rt.invoke("f")
            assert rt.wait(cid, timeout=30) == oload.DEADLINE_RC
        assert plan.fired("deadline-clock-skew") == 1
        assert not ran
        assert rt._calls[cid].status == "deadline"
        assert rt.deadline_total == 1
    finally:
        rt.shutdown()


@pytest.mark.sanitize
def test_deadline_after_partial_push_is_exactly_once():
    """Deadline × fence: a call that lands one push_delta and then hits its
    deadline at the next push checkpoint leaves exactly the pushed effect —
    the un-pushed add is discarded with the failed attempt, nothing is
    double-applied, and the deadline settle never triggers a retry."""
    rt = FaasmRuntime(n_hosts=1, device="cpu")
    try:
        VectorAsync.create(rt.global_tier, KEY, np.zeros(8, np.float32))

        def fn(api):
            v = VectorAsync(api, KEY)
            v.pull(track_delta=True)
            v.add(0, 1.0)
            v.push_delta(wire="exact")       # lands before expiry
            v.add(1, 1.0)                    # never pushed
            time.sleep(0.2)                  # burn the whole budget
            v.push_delta(wire="exact")       # checkpoint raises here
            return 0

        rt.upload(FunctionDef("fn", fn))
        cid = rt.invoke("fn", deadline=0.08)
        assert rt.wait(cid, timeout=30) == oload.DEADLINE_RC
        assert rt._calls[cid].status == "deadline"
        g = _global(rt.global_tier)
        assert g[0] == 1.0 and g[1] == 0.0, g[:2]
    finally:
        rt.shutdown()


def test_subscriber_stall_does_not_block_pusher():
    """The async-broadcast contract with a timing bound: a subscriber
    stalled 250 ms delays only its own pump thread — the pusher's
    push_delta returns in well under 50 ms."""
    gt, (pusher,), sub = _fabric(subscriber=True)
    plan = faults.FaultPlan(seed=9).add("subscriber-stall", delay_s=0.25)
    with faults.armed(plan):
        _view(pusher)[0] += 1.0
        t0 = time.perf_counter()
        pusher.push_delta(KEY, wire="exact")
        wall = time.perf_counter() - t0
        gt.flush_broadcasts(timeout=10.0)
    assert plan.fired("subscriber-stall") == 1
    assert wall < 0.05, f"pusher blocked {wall * 1e3:.1f} ms by a stalled " \
                        f"subscriber"
    want = np.zeros(256, np.float32)
    want[0] = 1.0
    np.testing.assert_array_equal(_view(sub), want)


def test_bcast_overflow_drops_subscriber_to_pull_repair():
    """A subscriber whose channel overflows (stalled pump, pushes across
    more keys than the bounded depth holds) is dropped from the broadcast
    set instead of backpressuring the fabric — and one delta pull per key
    repairs it to the exact global state."""
    gt = GlobalTier(device="cpu")
    gt.bcast_depth = 1
    keys = [f"k{i}" for i in range(4)]
    push, sub = LocalTier("push", gt), LocalTier("sub", gt)
    for k in keys:
        gt.set(k, np.zeros(8, np.float32).tobytes(), host="seed")
        push.pull(k)
        push.snapshot_base(k)
        sub.pull(k)
        sub.subscribe(k)
    plan = faults.FaultPlan(seed=13).add("subscriber-stall", delay_s=0.3)
    with faults.armed(plan):
        for k in keys:
            push.replica(k).buf.view(np.float32)[0] += 1.0
            push.push_delta(k, wire="exact")
        gt.flush_broadcasts(timeout=10.0)
    assert gt.bcast_dropped >= 1
    for k in keys:
        sub.pull(k)
        assert sub.replica(k).buf.view(np.float32)[0] == 1.0, k


def test_wait_all_timeout_names_outstanding_calls():
    """A partial fan-out timeout is debuggable without tracing: BatchTimeout
    carries exactly which ids are still in flight and what the rest
    returned, and the batch stays waitable afterwards."""
    rt = FaasmRuntime(n_hosts=2, device="cpu")
    try:
        gate = threading.Event()
        rt.upload(FunctionDef("fast", lambda api: 0))
        rt.upload(FunctionDef("slow", lambda api: 0 if gate.wait(10) else 1))
        cid_f = rt.invoke("fast")
        assert rt.wait(cid_f, timeout=10) == 0       # settled before the batch
        cid_s = rt.invoke("slow")
        with pytest.raises(BatchTimeout) as ei:
            rt.wait_all([cid_f, cid_s], timeout=0.2)
        bt = ei.value
        assert bt.pending == [cid_s]
        assert bt.done == {cid_f: 0}
        assert bt.timeout == 0.2
        assert str(cid_s) in str(bt)
        gate.set()
        assert rt.wait_all([cid_f, cid_s], timeout=30) == [0, 0]
    finally:
        rt.shutdown()


def test_open_breaker_steers_placement_and_fails_open():
    """An open per-host breaker removes the host from the candidate pool;
    when every breaker is open the scheduler fails open (placement beats a
    self-inflicted total outage)."""
    rt = FaasmRuntime(n_hosts=2, overload=oload.OverloadPolicy(
        breaker=lambda: oload.CircuitBreaker(reset_timeout_s=60.0)),
        device="cpu")
    try:
        rt.upload(FunctionDef("f", lambda api: 0))
        rt._breakers["host0"].trip()
        cids = rt.invoke_many("f", [b""] * 4)
        assert rt.wait_all(cids, timeout=30) == [0] * 4
        assert {rt._calls[c].host for c in cids} == {"host1"}
        # all breakers open: fail open rather than refuse all placement
        rt._breakers["host1"].trip()
        cid = rt.invoke("f")
        assert rt.wait(cid, timeout=30) == 0
    finally:
        rt.shutdown()


def test_retry_budget_dry_settles_lost_calls_failed():
    """With the retry budget exhausted, a call lost to host failure settles
    failed immediately instead of amplifying the fault into a retry storm."""
    rt = FaasmRuntime(n_hosts=2, capacity=1, overload=oload.OverloadPolicy(
        retry_budget=oload.RetryBudget(initial=0.0)), device="cpu")
    try:
        block = threading.Event()
        rt.upload(FunctionDef("f", lambda api: 0 if block.wait(10) else 1))
        cid = rt.invoke("f")
        deadline = time.monotonic() + 5.0
        while rt._calls[cid].status != "running" and \
                time.monotonic() < deadline:
            time.sleep(0.001)
        assert rt._calls[cid].status == "running"
        rt.fail_host(rt._calls[cid].host)
        rc = rt.wait(cid, timeout=30)
        block.set()
        assert rc != 0
        assert "retry budget exhausted" in rt._calls[cid].error
        assert rt.overload.retry_budget.denied_total == 1
    finally:
        rt.shutdown()


# -- the seeded chaos matrix --------------------------------------------------

def _storm(seed, n_iters=6):
    """Two pusher tiers + a broadcast subscriber + a polling puller under a
    ``FaultPlan.random(seed)`` schedule: after the storm the global value
    must equal the fault-free sum exactly and every replica must converge
    after one repair pull."""
    n = 256                                          # < int8 floor: exact wire
    gt = GlobalTier(device="cpu")
    gt.set(KEY, np.zeros(n, np.float32).tobytes(), host="seed")
    pushers = []
    for i in range(2):
        t = LocalTier(f"push{i}", gt)
        t.pull(KEY)
        t.snapshot_base(KEY)
        pushers.append(t)
    sub = LocalTier("sub", gt)
    sub.pull(KEY)
    sub.subscribe(KEY)
    puller = LocalTier("puller", gt)
    puller.pull(KEY)

    stop = threading.Event()
    errors = []

    def push_loop(t, slot):
        try:
            for _ in range(n_iters):
                _view(t)[slot] += 1.0
                t.push_delta(KEY, wire="exact")
        except Exception as e:                       # pragma: no cover
            errors.append(e)

    def pull_loop():
        try:
            while not stop.is_set():
                puller.pull(KEY)
                time.sleep(0.001)
        except Exception as e:                       # pragma: no cover
            errors.append(e)

    with faults.armed(faults.FaultPlan.random(seed)) as plan:
        threads = [threading.Thread(target=push_loop, args=(t, i))
                   for i, t in enumerate(pushers)]
        pt = threading.Thread(target=pull_loop)
        for th in threads:
            th.start()
        pt.start()
        for th in threads:
            th.join(timeout=30)
        stop.set()
        pt.join(timeout=30)
        gt.flush_broadcasts()            # drain pumps while still armed
    assert not errors, errors

    want = np.zeros(n, np.float32)
    want[0] = want[1] = n_iters
    # the global tier holds the exact fault-free sum: nothing dropped,
    # nothing double-applied, regardless of the schedule
    np.testing.assert_array_equal(_global(gt), want)
    # and every replica converges after one clean repair pull
    for t in (sub, puller, *pushers):
        t.pull(KEY)
        np.testing.assert_array_equal(_view(t)[:n], want)
    return plan


@pytest.mark.sanitize
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_matrix_smoke(seed):
    _storm(seed)


@pytest.mark.slow
@pytest.mark.sanitize
@pytest.mark.parametrize("seed", list(range(3, 13)))
def test_chaos_matrix_full(seed):
    _storm(seed, n_iters=12)


@pytest.mark.sanitize
def test_runtime_chaos_kill_during_fanout():
    """Runtime-level storm: a random fault schedule plus an explicit host
    kill mid-fanout; every increment lands exactly once."""
    rt = FaasmRuntime(n_hosts=3, capacity=1, backoff=0.001, device="cpu")
    try:
        VectorAsync.create(rt.global_tier, KEY, np.zeros(8, np.float32))

        def inc(api):
            time.sleep(0.01)
            v = VectorAsync(api, KEY)
            v.pull(track_delta=True)
            v.add(0, 1.0)
            v.push_delta(wire="exact")
            return 0

        rt.upload(FunctionDef("inc", inc))
        with faults.armed(faults.FaultPlan.random(11)):
            cids = rt.invoke_many("inc", [b""] * 8, state_hint=[KEY])
            deadline = time.monotonic() + 5.0
            victim = None
            while victim is None and time.monotonic() < deadline:
                victim = next((h for h in rt.alive_hosts()
                               if h._inflight > 0), None)
            assert victim is not None
            rt.fail_host(victim.id)
            assert rt.wait_all(cids, timeout=60) == [0] * 8
        assert _global(rt.global_tier)[0] == 8.0     # exactly once each
    finally:
        rt.shutdown()
