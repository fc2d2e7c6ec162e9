"""The two-tier state of ``tests/test_state.py`` through the port: the
global tier's values, ranges and chunks, chunked pulls that move only the
bytes needed, dirty-only and delta pushes across hosts, the plain push's
overwrite, the reader-writer lock's exclusion and both hypothesis
properties with their settings, run through ``repro_torch.state.kv`` and
``repro_torch.state.local`` on ``device="cpu"``.  Each twin asserts what
its reference test asserts, under the same names.  ``GlobalTier`` is the
port's, its codec on the CPU.  The port's sanitizer, fault, telemetry
and cost-model planes are handled by the fixtures of
``tests/torch_twin_planes.py``.
"""
import threading

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro_torch.state.kv import RWLock
from repro_torch.state.kv import GlobalTier as _GlobalTier
from repro_torch.state.local import LocalTier
from torch_twin_planes import port_planes_disarmed, port_sanitize  # noqa: F401


def GlobalTier(*args, **kwargs):
    """The port's global tier with its codec on the CPU."""
    return _GlobalTier(*args, device="cpu", **kwargs)



def test_global_tier_basic():
    gt = GlobalTier(chunk_size=16)
    gt.set("a", b"hello", host="h0")
    assert gt.get("a", host="h1") == b"hello"
    gt.append("a", b" world", host="h0")
    assert gt.get("a", host="h1") == b"hello world"
    assert gt.bytes_pushed["h0"] == len(b"hello") + len(b" world")


def test_global_tier_range_and_chunks():
    gt = GlobalTier(chunk_size=8)
    gt.set("k", bytes(range(32)), host="h")
    assert gt.n_chunks("k") == 4
    assert gt.get_range("k", 8, 8, host="h") == bytes(range(8, 16))
    gt.set_range("k", 30, b"\xff\xff\xff", host="h")   # extends the value
    assert gt.size("k") == 33
    with pytest.raises(IndexError):
        gt.get_range("k", 30, 10)


def test_local_tier_chunked_pull_moves_only_needed_bytes():
    gt = GlobalTier(chunk_size=8)
    gt.set("k", bytes(range(64)), host="up")
    lt = LocalTier("h0", gt)
    gt.reset_metrics()
    lt.pull_range("k", 20, 4)                      # covers chunk 2 only
    assert gt.bytes_pulled["h0"] == 8
    r = lt.replica("k")
    assert bytes(r.buf[20:24]) == bytes(range(20, 24))
    # pulling the same chunk again is free
    lt.pull_range("k", 16, 8)
    assert gt.bytes_pulled["h0"] == 8


def test_local_push_dirty_only():
    gt = GlobalTier(chunk_size=8)
    gt.set("k", bytes(64), host="up")
    lt = LocalTier("h0", gt)
    lt.pull("k")
    gt.reset_metrics()
    r = lt.replica("k")
    r.buf[9] = 42
    lt.mark_dirty("k", 9, 1)
    moved = lt.push_dirty("k")
    assert moved == 8                              # one chunk
    assert gt.get("k", host="x")[9] == 42


def test_push_delta_accumulates_across_hosts():
    """Concurrent delta pushes from different hosts compose (HOGWILD-safe)."""
    gt = GlobalTier()
    base = np.zeros(16, np.float32)
    gt.set("w", base.tobytes(), host="up")
    tiers = [LocalTier(f"h{i}", gt) for i in range(4)]
    for i, lt in enumerate(tiers):
        lt.pull("w")
        lt.snapshot_base("w")
        view = lt.replica("w").buf.view(np.float32)
        view[i] += float(i + 1)
    for lt in tiers:
        lt.push_delta("w")
    final = np.frombuffer(gt.get("w", host="x"), np.float32)
    np.testing.assert_allclose(final[:4], [1, 2, 3, 4])
    np.testing.assert_allclose(final[4:], 0)


def test_plain_push_overwrites():
    gt = GlobalTier()
    gt.set("w", np.zeros(4, np.float32).tobytes(), host="up")
    l0, l1 = LocalTier("h0", gt), LocalTier("h1", gt)
    for i, lt in enumerate((l0, l1)):
        lt.pull("w")
        lt.replica("w").buf.view(np.float32)[i] = 7.0
    l0.push("w")
    l1.push("w")                                    # last-writer-wins
    final = np.frombuffer(gt.get("w", host="x"), np.float32)
    assert final[1] == 7.0 and final[0] == 0.0      # h0's write lost (expected)


def test_rwlock_mutual_exclusion():
    lock = RWLock()
    counter = {"v": 0}
    errs = []

    def writer():
        for _ in range(200):
            lock.acquire_write()
            try:
                v = counter["v"]
                counter["v"] = v + 1
            finally:
                lock.release_write()

    def reader():
        for _ in range(200):
            lock.acquire_read()
            try:
                _ = counter["v"]
            finally:
                lock.release_read()

    ts = [threading.Thread(target=writer) for _ in range(3)] + \
        [threading.Thread(target=reader) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert counter["v"] == 600
    assert not errs


@settings(max_examples=25, deadline=None)
@given(size=st.integers(1, 300), chunk=st.integers(1, 64),
       offset_frac=st.floats(0, 1), length_frac=st.floats(0, 1),
       seed=st.integers(0, 2**16))
def test_property_pull_range_correct(size, chunk, offset_frac, length_frac, seed):
    """Any chunked partial pull reproduces exactly the global bytes."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    gt = GlobalTier(chunk_size=chunk)
    gt.set("k", data, host="up")
    lt = LocalTier("h", gt)
    off = int(offset_frac * (size - 1))
    length = max(1, int(length_frac * (size - off)))
    lt.pull_range("k", off, length)
    r = lt.replica("k")
    assert bytes(r.buf[off:off + length]) == data[off:off + length]


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 64), writes=st.lists(
    st.tuples(st.integers(0, 63), st.floats(-10, 10)), max_size=16),
    seed=st.integers(0, 2**16))
def test_property_delta_push_equals_sum(n, writes, seed):
    """global' == global + Σ per-host deltas regardless of interleaving."""
    gt = GlobalTier()
    init = np.zeros(64, np.float32)
    gt.set("w", init.tobytes(), host="up")
    expected = init.copy()
    lt = LocalTier("h", gt)
    lt.pull("w")
    lt.snapshot_base("w")
    view = lt.replica("w").buf.view(np.float32)
    for idx, val in writes:
        view[idx % 64] += np.float32(val)
        expected[idx % 64] += np.float32(val)
    lt.push_delta("w")
    final = np.frombuffer(gt.get("w", host="x"), np.float32)
    np.testing.assert_allclose(final, expected, atol=1e-5)
