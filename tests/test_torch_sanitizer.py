"""The runtime sanitizer of ``tests/test_sanitizer.py`` through the port.

Every test of the reference's file, with the same names and markers, run
through ``repro_torch.analysis.sanitizer`` and the port's state tiers on
``device="cpu"``: a multi-threaded fabric hammer runs clean, every check
fires on a deliberately seeded violation, and the instrumentation
compiles out to raw locks when disabled.  Each twin asserts what its
reference test asserts.

All fabric objects are built inside ``sanitize``-marked tests, after the
fixture of ``tests/torch_twin_planes.py`` has turned the port's
sanitizer on (instrumentation is decided at lock construction);
``tests/conftest.py`` drives the reference's sanitizer, not the port's.
Seeded tests drain their reports with ``take_reports()``; anything left
over fails the test through that fixture.  The port's fault, telemetry and cost-model planes are disarmed
after every test.
"""
import os
import threading
import time
import types

import numpy as np
import pytest

from repro_torch import cancellation
from repro_torch.analysis import sanitizer
from repro_torch.state.kv import RWLock
from repro_torch.state.kv import GlobalTier as _GlobalTier
from repro_torch.state.local import INT8_WIRE_MIN_BYTES, LocalTier
from repro_torch.state.wire import get_codec
from torch_twin_planes import port_planes_disarmed, port_sanitize  # noqa: F401


def GlobalTier(*args, **kwargs):
    """The port's global tier with its codec on the CPU."""
    return _GlobalTier(*args, device="cpu", **kwargs)


N = max(INT8_WIRE_MIN_BYTES // 4, 2048)     # floats per key: int8-eligible


def checks_of(reports):
    return {r.check for r in reports}


# -- the concurrency hammer --------------------------------------------------

@pytest.mark.sanitize
def test_hammer_pushers_pullers_subscribers_run_clean():
    """N pusher tiers × M puller tiers × a broadcast subscriber pounding
    shared keys for ~2 s: the real fabric must produce zero reports."""
    gt = GlobalTier()
    keys = ["a", "b"]
    for k in keys:
        gt.set(k, np.zeros(N, np.float32).tobytes(), host="seed")

    def tier(name, *, base=False, sub=False):
        t = LocalTier(name, gt)
        for k in keys:
            t.pull(k)
            if base:
                t.snapshot_base(k)
            if sub:
                t.subscribe(k)
        return t

    pushers = [tier(f"push{i}", base=True) for i in range(2)]
    pullers = [tier(f"pull{i}") for i in range(2)]
    sub = tier("sub", sub=True)

    deadline = time.monotonic() + 2.0
    stop = threading.Event()
    errors = []

    def run(fn):
        try:
            i = 0
            while time.monotonic() < deadline and not stop.is_set():
                fn(i)
                i += 1
        except Exception as e:                  # pragma: no cover - fail path
            errors.append(e)
            stop.set()

    def pusher_loop(t, rng):
        def step(i):
            k = keys[i % len(keys)]
            view = t.replica(k).buf.view(np.float32)
            view[:] += rng.normal(size=N).astype(np.float32) * 0.01
            t.push_delta(k, wire="int8" if i % 3 else "exact")
        return step

    def puller_loop(t):
        def step(i):
            t.pull(keys[i % len(keys)], wire="int8" if i % 2 else "exact")
        return step

    def sub_loop(t):
        def step(i):
            # mostly passive (broadcast delivery), occasional catch-up pull
            if i % 7 == 0:
                t.pull(keys[i % len(keys)])
            else:
                time.sleep(0.001)
        return step

    threads = [threading.Thread(target=run, args=(pusher_loop(t, np.random.default_rng(j)),))
               for j, t in enumerate(pushers)]
    threads += [threading.Thread(target=run, args=(puller_loop(t),))
                for t in pullers]
    threads += [threading.Thread(target=run, args=(sub_loop(sub),))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not errors, errors
    reports = sanitizer.take_reports()
    assert reports == [], "\n\n".join(str(r) for r in reports)


# -- seeded violations: one per check ----------------------------------------

@pytest.mark.sanitize
def test_seeded_lock_order_cycle_reports_both_stacks():
    a = sanitizer.make_mutex("A")
    b = sanitizer.make_mutex("B")
    with a:
        with b:
            pass
    with b:
        with a:                                 # reverse order: cycle
            pass
    reports = sanitizer.take_reports()
    assert checks_of(reports) == {"lock-order"}
    (r,) = reports
    assert "deadlock potential" in r.message
    assert r.stack and r.other_stack            # both acquisition stacks


@pytest.mark.sanitize
def test_seeded_same_kind_nesting_is_reported():
    s1 = sanitizer.make_mutex("stripe", "s1")
    s2 = sanitizer.make_mutex("stripe", "s2")
    with s1:
        with s2:
            pass
    reports = sanitizer.take_reports()
    assert checks_of(reports) == {"lock-order"}
    assert "homogeneous" in reports[0].message


@pytest.mark.sanitize
def test_reentrant_acquire_is_not_a_violation():
    m = sanitizer.make_mutex("host")
    with m:
        with m:
            pass
    assert sanitizer.take_reports() == []


@pytest.mark.sanitize
def test_seeded_unheld_release_is_lock_misuse():
    m = sanitizer.make_mutex("host", "probe")
    with pytest.raises(RuntimeError):
        m.release()
    assert checks_of(sanitizer.take_reports()) == {"lock-misuse"}


@pytest.mark.sanitize
def test_seeded_stripe_touch_without_lock():
    st = sanitizer.enable()                     # the active state (idempotent)
    gt = GlobalTier()
    s = gt._stripe("k")
    st.stripe_touch(s.lock, "k")                # not holding s.lock
    reports = sanitizer.take_reports()
    assert checks_of(reports) == {"stripe-ownership"}
    # and the same touch under the lock is clean
    with s.lock:
        st.stripe_touch(s.lock, "k")
    assert sanitizer.take_reports() == []


@pytest.mark.sanitize
def test_seeded_torn_read():
    st = sanitizer.enable()
    gt = GlobalTier()
    tok = st.read_begin(gt, "k")
    st.gen_bump(gt, "k")                        # concurrent mutation mid-read
    st.read_end(gt, "k", tok)
    assert checks_of(sanitizer.take_reports()) == {"torn-read"}


@pytest.mark.sanitize
def test_seeded_wire_version_regression():
    st = sanitizer.enable()
    gt = GlobalTier()
    st.version_bumped(gt, "k", 5, 5)            # non-advancing bump
    st.frame_applied(gt, "k", types.SimpleNamespace(prev_version=3,
                                                    version=3))
    reports = sanitizer.take_reports()
    assert checks_of(reports) == {"wire-version"}
    assert len(reports) == 2


@pytest.mark.sanitize
def test_seeded_wire_window_gap_and_floor():
    st = sanitizer.enable()
    gt = GlobalTier()
    # gap: frame 7->8 appended after a window whose tail is version 5
    st.frame_recorded(gt, "k", types.SimpleNamespace(prev_version=7,
                                                     version=8),
                      tail_version=5, floor=0)
    # empty window starting below its floor
    st.frame_recorded(gt, "k", types.SimpleNamespace(prev_version=1,
                                                     version=2),
                      tail_version=None, floor=4)
    reports = sanitizer.take_reports()
    assert checks_of(reports) == {"wire-window"}
    assert len(reports) == 2


@pytest.mark.sanitize
def test_seeded_residual_conservation_violation():
    st = sanitizer.enable()
    delta = np.array([1.0, -2.0, 0.5], np.float32)
    carried = np.array([0.9, -1.9, 0.4], np.float32)
    st.check_residual(delta, carried, None)     # dropped the carry: off by .1
    assert checks_of(sanitizer.take_reports()) == {"wire-residual"}
    # conserved residual is clean
    st.check_residual(delta, carried, delta - carried)
    assert sanitizer.take_reports() == []


@pytest.mark.sanitize
def test_seeded_attempt_fence_violations():
    st = sanitizer.enable()
    # same (call, key, seq) admitted twice: a re-execution double-applied
    st.fence_write("c1", 1, "k", 1, True)
    st.fence_write("c1", 2, "k", 1, True)
    # a write admitted from an epoch the runtime already superseded: zombie
    st.fence_superseded("c2", 3)
    st.fence_write("c2", 3, "k", 1, True)
    reports = sanitizer.take_reports()
    assert checks_of(reports) == {"attempt-fence"}
    assert len(reports) == 2
    assert any("double-applied" in r.message for r in reports)
    assert any("zombie" in r.message for r in reports)
    # the healthy traces are clean: a rejected duplicate, a fresh seq, and
    # a live (not yet superseded) epoch
    st.fence_write("c3", 1, "k", 1, True)
    st.fence_write("c3", 2, "k", 1, False)          # tier rejected the dup
    st.fence_write("c3", 2, "k", 2, True)
    st.fence_superseded("c4", 1)
    st.fence_write("c4", 2, "k", 1, True)
    assert sanitizer.take_reports() == []


@pytest.mark.sanitize
def test_seeded_cancellation_checkpoint_under_stripe_lock():
    gt = GlobalTier()
    s = gt._stripe("w")
    with s.lock:
        cancellation.checkpoint()               # end-to-end through the guard
    reports = sanitizer.take_reports()
    assert checks_of(reports) == {"cancel-under-lock"}
    assert "stripe" in reports[0].message
    # outside the lock the checkpoint is clean
    cancellation.checkpoint()
    assert sanitizer.take_reports() == []


@pytest.mark.sanitize
def test_seeded_apply_frame_without_write_lock():
    gt = GlobalTier()
    gt.set("k", np.zeros(4, np.float32).tobytes(), host="seed")
    t = LocalTier("h", gt)
    t.pull("k")
    r = t.replica("k")
    frame, _ = get_codec("exact").encode(np.ones(4, np.float32),
                                         np.zeros(4, np.float32))
    t._apply_frame_locked(r, frame)             # contract: write lock held
    assert checks_of(sanitizer.take_reports()) == {"lock-misuse"}
    r.lock.acquire_write()
    try:
        t._apply_frame_locked(r, frame)
    finally:
        r.lock.release_write()
    assert sanitizer.take_reports() == []


# -- compile-out --------------------------------------------------------------

@pytest.mark.skipif(os.environ.get("FAASM_SANITIZE") == "1",
                    reason="suite running under FAASM_SANITIZE=1")
def test_disabled_sanitizer_compiles_out_to_raw_locks():
    raw_rlock = type(threading.RLock())
    assert isinstance(sanitizer.make_mutex("stripe"), raw_rlock)
    rw = RWLock()
    assert sanitizer.wrap_rwlock(rw, "replica") is rw
    gt = GlobalTier()
    assert isinstance(gt._stripe("k").lock, raw_rlock)
    t = LocalTier("h", gt)
    gt.set("k", b"\0" * 8, host="seed")
    assert isinstance(t.replica("k").lock, RWLock)
    # hook globals are cleared: the per-call guard is one pointer compare
    from repro_torch.state import kv, local, wire
    assert kv._SAN is None and local._SAN is None and wire._SAN is None
    assert cancellation._SAN_GUARD is None
