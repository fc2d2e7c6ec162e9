"""The quantised-push cases of ``tests/test_quantized_push.py`` through the
port, and the three device-side windows the port's ``state/local.py``
names.

The first part twins the ten cases of the reference's file that
``tests/test_torch_runtime.py`` does not carry (it holds the
device-replica block in both packages): the wire round trip's error
bound, the pad region, the tier push against the kernel's apply, error
feedback, concurrent int8 pushes, the 4 MB byte bound, wire-byte
accounting, the exact fallbacks and a grown replica's base.  Same names,
cases and assertions, through ``repro_torch`` on ``device="cpu"``.  The
reference's ``xla`` and ``pallas_interpret`` backends are the port's
``auto`` (numpy operands on the CPU take the copied host codec) and
``torch`` (the kernels' plain PyTorch versions).

The second part forces a host add into each window at a fixed point
(a hook inside the push's encode, or a plain order of calls; no timing
race) and asserts whether the add reaches the global value:

* a device replica of a dtype other than f32 pushing while an add lands
  during its encode: kept (the push re-bases from the content its device
  copy was synced from, as the f32 path does);
* ``from_device`` after an add that followed the device sync: lost, by
  design (it writes the device value over the buffer, as the
  reference's does);
* ``to_device(track_delta=True)`` over an add not yet pushed: kept (the
  device base is armed from the host base, so the add ships with the
  next device push).
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels.state_push import (apply_delta, dequantize,
                                            quantize_delta, wire_nbytes)
from repro_torch.state.ddo import VectorAsync
from repro_torch.state.kv import GlobalTier
from repro_torch.state.local import INT8_WIRE_MIN_BYTES, LocalTier
from repro_torch.state.wire import get_codec

BACKENDS = ("auto", "torch")


def _rng(seed=0):
    return np.random.default_rng(seed)


# -- wire format round trip ----------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [1, 100, 128, 1000])
def test_wire_roundtrip_error_bound(backend, n):
    """Quantise→dequantise error is bounded by half a quantisation step
    (per-row absmax / 127 / 2)."""
    rng = _rng(n)
    local = rng.normal(size=n).astype(np.float32)
    base = rng.normal(size=n).astype(np.float32)
    q, s, numel = quantize_delta(local, base, backend=backend, device="cpu")
    assert numel == n
    deq = np.asarray(dequantize(q, s, numel))
    delta = local - base
    bound = np.abs(delta).max() / 254.0 + 1e-6
    assert np.abs(deq - delta).max() <= bound


@pytest.mark.parametrize("backend", BACKENDS)
def test_pad_region_quantises_to_zero(backend):
    """Non-multiple-of-128 values pad to (rows, 128); the pad must carry
    zero delta so applying a padded push is a no-op beyond ``numel``."""
    n = 130                                   # 2 rows, 126 pad lanes
    rng = _rng(3)
    local = rng.normal(size=n).astype(np.float32)
    base = rng.normal(size=n).astype(np.float32)
    q, s, numel = quantize_delta(local, base, backend=backend, device="cpu")
    assert q.shape == (2, 128) and numel == n
    assert np.all(np.asarray(q).reshape(-1)[n:] == 0)
    # apply through the kernel: the value beyond numel is never touched
    gv = rng.normal(size=n).astype(np.float32)
    out = np.asarray(apply_delta(gv, q, s, backend=backend, device="cpu"))
    bound = np.abs(local - base).max() / 254.0 + 1e-5
    assert np.abs(out - (gv + (local - base))).max() <= bound


@pytest.mark.parametrize("backend", BACKENDS)
def test_tier_push_matches_kernel_apply(backend):
    """LocalTier int8 push through GlobalTier.apply_quantized lands the same
    value as applying the wire tuple with the fused kernel."""
    n = INT8_WIRE_MIN_BYTES // 4 * 2
    rng = _rng(7)
    init = rng.normal(size=n).astype(np.float32)
    gt = GlobalTier(device="cpu")
    gt.set("w", init.tobytes(), host="up")
    lt = LocalTier("h0", gt)
    lt.pull("w")
    lt.snapshot_base("w")
    upd = (rng.normal(size=n) * 0.1).astype(np.float32)
    lt.replica("w").buf.view(np.float32)[:] += upd
    lt.push_delta("w", wire="int8", backend=backend)
    got = np.frombuffer(gt.get("w", host="x"), np.float32)
    q, s, numel = quantize_delta(init + upd, init, backend=backend,
                               device="cpu")
    want = np.asarray(apply_delta(init, q, s, backend=backend, device="cpu"))
    np.testing.assert_allclose(got, want, atol=1e-5)


# -- error feedback ------------------------------------------------------------


def test_error_feedback_residual_bounded_and_converges():
    """≥10 consecutive int8 pushes track the exact path within tolerance and
    the per-replica residual stays bounded (no bias accumulation) — the
    acceptance-criterion property."""
    n = 1 << 18                               # 1 MB of f32
    rng = _rng(11)
    gt = GlobalTier(device="cpu")
    gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
    lt = LocalTier("h0", gt)
    lt.pull("w")
    lt.snapshot_base("w")
    view = lt.replica("w").buf.view(np.float32)
    expected = np.zeros(n, np.float32)
    scale = 0.01
    resid_caps = []
    for i in range(12):
        u = (rng.normal(size=n) * scale).astype(np.float32)
        view[:] += u
        expected += u
        lt.push_delta("w", wire="int8")
        r = lt.replica("w").residual
        resid_caps.append(float(np.abs(r).max()))
    final = np.frombuffer(gt.get("w", host="x"), np.float32)
    # with error feedback, total error ≤ one half-step of the *last* push,
    # not the sum of 12 half-steps
    one_step = scale * 6 / 254.0              # ~absmax of one N(0,0.01) push
    assert np.abs(final - expected).max() <= one_step * 2
    # residual bounded across all pushes: no growth trend
    assert max(resid_caps) <= one_step * 2
    assert resid_caps[-1] <= 2 * max(resid_caps[:3]) + 1e-6


def test_error_feedback_beats_no_feedback():
    """The same biased update stream quantised N times: with feedback the
    accumulated value stays near exact; zeroing the residual each push
    (no feedback) drifts measurably further."""
    n = 1 << 14
    pushes = 15
    u = np.full(n, 0.003, np.float32)         # constant update: worst case
    u[::7] = 0.1                              # large row absmax -> coarse step

    def run(feedback: bool) -> float:
        gt = GlobalTier(device="cpu")
        gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
        lt = LocalTier("h0", gt)
        lt.pull("w")
        lt.snapshot_base("w")
        view = lt.replica("w").buf.view(np.float32)
        for _ in range(pushes):
            view[:] += u
            lt.push_delta("w", wire="int8")
            if not feedback:
                lt.replica("w").residual[:] = 0
        final = np.frombuffer(gt.get("w", host="x"), np.float32)
        return float(np.abs(final - u * pushes).max())

    assert run(True) < run(False)


# -- HOGWILD composition -------------------------------------------------------


def test_concurrent_int8_pushes_compose():
    """Concurrent quantised pushes from different hosts accumulate instead
    of overwriting (each under the key's global write lock)."""
    n = INT8_WIRE_MIN_BYTES // 4
    n_hosts = 4
    gt = GlobalTier(device="cpu")
    gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
    tiers = [LocalTier(f"h{i}", gt) for i in range(n_hosts)]
    per = n // n_hosts
    for i, lt in enumerate(tiers):
        lt.pull("w")
        lt.snapshot_base("w")
        view = lt.replica("w").buf.view(np.float32)
        # ±c patterns quantise exactly (scale = c/127, q = ±127)
        view[i * per:(i + 1) * per] += np.float32(i + 1)
    errs = []

    def push(lt):
        try:
            lt.push_delta("w", wire="int8")
        except Exception as e:                # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=push, args=(lt,)) for lt in tiers]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    final = np.frombuffer(gt.get("w", host="x"), np.float32)
    want = np.zeros(n, np.float32)
    for i in range(n_hosts):
        want[i * per:(i + 1) * per] = i + 1
    np.testing.assert_allclose(final, want, atol=1e-4)


# -- wire-byte accounting (the ≤30% acceptance bound) --------------------------


def test_int8_push_of_4mb_key_moves_under_30_percent():
    """Acceptance criterion: int8 push_delta of a ≥4 MB f32 key moves ≤ 30%
    of the exact-path bytes, with the residual bounded across ≥10 pushes."""
    size = 4 << 20                            # 4 MB
    n = size // 4
    rng = _rng(23)

    def run(wire: str):
        gt = GlobalTier(device="cpu")
        gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
        lt = LocalTier("h0", gt)
        lt.pull("w")
        lt.snapshot_base("w")
        gt.reset_metrics()
        view = lt.replica("w").buf.view(np.float32)
        resid_caps = []
        for i in range(10):
            view[:] += (rng.normal(size=n) * 0.01).astype(np.float32)
            lt.push_delta("w", wire=wire)
            r = lt.replica("w").residual
            if r is not None:
                resid_caps.append(float(np.abs(r).max()))
        return gt.bytes_pushed["h0"], resid_caps

    exact_bytes, _ = run("exact")
    int8_bytes, resid_caps = run("int8")
    assert exact_bytes == 10 * size           # exact accounts value bytes
    assert int8_bytes <= 0.30 * exact_bytes   # wire accounting: ~26% + scales
    assert len(resid_caps) == 10
    assert max(resid_caps) <= 0.01 * 6 / 254.0 * 2   # bounded, no growth


def test_apply_quantized_accounts_wire_bytes():
    n = 1024
    gt = GlobalTier(device="cpu")
    gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
    gt.reset_metrics()
    delta = np.full(n, 0.5, np.float32)
    q, s, numel = quantize_delta(delta, np.zeros(n, np.float32),
                             device="cpu")
    q, s = np.asarray(q), np.asarray(s)
    moved = gt.apply_quantized("w", q, s, numel, host="h0")
    wire = wire_nbytes(q, s)
    assert moved == wire == q.nbytes + s.nbytes
    assert gt.bytes_pushed["h0"] == wire      # not the 4 KB of value bytes
    assert gt.total_copied() == wire
    np.testing.assert_allclose(
        np.frombuffer(gt.get("w", host="x"), np.float32), 0.5, atol=0.5 / 127)


# -- fallbacks -----------------------------------------------------------------


def test_sub_threshold_and_non_float_fall_back_exact():
    gt = GlobalTier(device="cpu")
    tiny = np.arange(16, dtype=np.float32)
    gt.set("t", np.zeros(16, np.float32).tobytes(), host="up")
    lt = LocalTier("h0", gt)
    lt.pull("t")
    lt.snapshot_base("t")
    lt.replica("t").buf.view(np.float32)[:] = tiny
    moved = lt.push_delta("t", wire="int8")   # < INT8_WIRE_MIN_BYTES
    assert moved == 64                        # exact in-place path
    np.testing.assert_array_equal(
        np.frombuffer(gt.get("t", host="x"), np.float32), tiny)

    gt.set("i", np.zeros(INT8_WIRE_MIN_BYTES // 8, np.int64).tobytes(),
           host="up")
    lt.pull("i")
    lt.snapshot_base("i")
    lt.replica("i").buf.view(np.int64)[0] = 7
    lt.push_delta("i", dtype=np.int64, wire="int8")   # int dtype: exact
    assert np.frombuffer(gt.get("i", host="x"), np.int64)[0] == 7

    with pytest.raises(ValueError):
        lt.push_delta("t", wire="bogus")



def test_grown_replica_base_zero_extended():
    """Regression: a base snapshotted before the replica grew is
    zero-extended for the new tail (never pushed => base 0 there), not
    replaced with an all-zeros base (which would re-push the whole value)."""
    n = INT8_WIRE_MIN_BYTES // 4
    gt = GlobalTier(device="cpu")
    gt.set("w", np.full(n, 5.0, np.float32).tobytes(), host="up")
    lt = LocalTier("h0", gt)
    lt.pull("w")
    lt.snapshot_base("w")                           # base = 5.0 * n
    gt.append("w", np.full(n, 3.0, np.float32).tobytes(), host="up")
    lt.replica("w", size=2 * n * 4)                 # buf grows; base is stale
    lt.pull_chunk("w", 0)                           # old chunk present
    r = lt.replica("w")
    r.present_chunks.clear()
    r.full = False
    lt.pull("w")                                    # refresh whole value
    lt.push_delta("w", wire="int8")                 # delta vs old-base: tail!
    final = np.frombuffer(gt.get("w", host="x"), np.float32)
    # head: 5 - 5 = 0 delta; tail: base zero-extended -> pushes +3 once
    np.testing.assert_allclose(final[:n], 5.0, atol=1e-3)
    np.testing.assert_allclose(final[n:], 6.0, atol=1e-3)




# -- the device-side windows of state/local.py ---------------------------------


class _Api:
    """The two calls ``VectorAsync`` makes of a Faaslet's API, over one
    tier: its handle maps the tier's shared replica buffer."""

    def __init__(self, lt):
        self._lt = lt

    def _local(self):
        return self._lt

    def get_state(self, key, *, writable=True):
        if not self._lt.has(key):
            self._lt.pull(key)
        return self._lt.replica(key).buf


def _vector(n=INT8_WIRE_MIN_BYTES // 4):
    """A global tier holding an n-float ``VectorAsync`` at zero, one tier
    with the replica pulled and its base armed, and a handle on it."""
    gt = GlobalTier(device="cpu")
    VectorAsync.create(gt, "w", np.zeros(n, np.float32))
    lt = LocalTier("h0", gt)
    lt.pull("w")
    lt.snapshot_base("w")
    return gt, lt, VectorAsync(_Api(lt), "w")


def _encode_hook(monkeypatch, wire, before):
    """Run ``before()`` once, inside the next encode on ``wire``: after the
    push chose its branch and read its operands, before it re-bases."""
    codec = get_codec(wire)
    real = codec.encode
    fired = []

    def encode(*a, **kw):
        if not fired:
            fired.append(1)
            before()
        return real(*a, **kw)

    monkeypatch.setattr(codec, "encode", encode)
    return fired


def test_window_non_f32_device_push_keeps_an_add_during_its_encode(
        monkeypatch):
    """A float64 device replica, synced and armed, pushes on the int8
    wire; a host add (what ``VectorAsync.add`` does, on the f64 view)
    lands inside the encode.  The push re-bases from the content the
    device copy was synced from, not from the live buffer, so the add
    stays pending and the next push ships it."""
    n = INT8_WIRE_MIN_BYTES // 8
    gt = GlobalTier(device="cpu")
    gt.set("w", np.zeros(n, np.float64).tobytes(), host="up")
    lt = LocalTier("h0", gt)
    lt.pull("w")
    lt.snapshot_base("w")
    dv = lt.to_device("w", np.float64, track_delta=True)
    assert dv.dtype == torch.float64
    lt.update_device("w", dv + 2.0)
    lt.from_device("w")                      # host and device agree at 2.0
    lt.to_device("w", np.float64, track_delta=True)

    def add():
        r = lt.replica("w")
        with r.buf_lock:
            r.buf.view(np.float64)[3] += 1.0
        lt.mark_dirty("w", 0, r.buf.size)

    fired = _encode_hook(monkeypatch, "int8", add)
    lt.push_delta("w", dtype=np.float64, wire="int8")
    assert fired == [1]
    lt.push_delta("w", dtype=np.float64, wire="int8")   # host branch now
    got = np.frombuffer(gt.get("w", host="check"), np.float64)
    survived = int(abs(got[3] - 3.0) < 1e-3)
    assert survived == 1
    np.testing.assert_allclose(np.delete(got, 3), 2.0, atol=1e-3)


def test_window_from_device_overwrites_an_add_after_the_sync():
    """A ``VectorAsync.add`` that lands after the device sync and before
    ``from_device`` is overwritten: ``from_device`` writes the device
    value over the whole buffer, as the reference's does.  The add is
    lost; the device's own writes reach the global value."""
    gt, lt, vec = _vector()
    dv = lt.to_device("w", track_delta=True)
    lt.update_device("w", dv + 2.0)          # device-side write, pending
    vec.add([3], 1.0)                        # host add after the sync
    assert lt.replica("w").buf.view(np.float32)[3] == 1.0
    lt.from_device("w")
    lt.push_delta("w", wire="int8")
    got = np.frombuffer(gt.get("w", host="check"), np.float32)
    survived = int(abs(got[3] - 3.0) < 1e-3)
    assert survived == 0
    np.testing.assert_allclose(got, 2.0, atol=1e-5)


def test_window_track_delta_sync_keeps_a_pending_add():
    """A ``VectorAsync.add`` not yet pushed, then ``to_device(
    track_delta=True)``: the device base is armed from the host base (the
    content the global tier last took from this replica), not from the
    synced value, so the device-native push ships the add."""
    gt, lt, vec = _vector()
    vec.add([3], 1.0)                        # pending: buffer − base
    dv = lt.to_device("w", track_delta=True)
    assert float(dv[3]) == 1.0
    lt.update_device("w", dv + 2.0)
    lt.push_delta("w", wire="int8")          # device-native push
    got = np.frombuffer(gt.get("w", host="check"), np.float32)
    survived = int(abs(got[3] - 3.0) < 1e-3)
    assert survived == 1
    # int8: the add is its row's absmax, so the other lanes round within
    # half a step of it
    np.testing.assert_allclose(np.delete(got, 3), 2.0,
                               atol=3.0 / 254 + 1e-6)
    lt.from_device("w")
    lt.push_delta("w", wire="int8")          # nothing pushed twice
    np.testing.assert_allclose(
        np.frombuffer(gt.get("w", host="check"), np.float32)[3], 3.0,
        atol=1e-3)


def test_window_track_delta_after_a_cold_pull_ships_only_the_update():
    """A base armed on a cold replica, then a peer's push, then the cold
    full pull: the pull leaves the host base behind the global value.
    ``to_device(track_delta=True)`` then arms the device base from the
    synced value, so the device push ships only its own update and not
    the peer's write a second time."""
    n = INT8_WIRE_MIN_BYTES // 4
    gt = GlobalTier(device="cpu")
    VectorAsync.create(gt, "w", np.zeros(n, np.float32))
    lt = LocalTier("h0", gt)
    lt.replica("w", gt.size("w"))            # cold: nothing pulled yet
    lt.snapshot_base("w")
    peer = LocalTier("h1", gt)
    peer.pull("w")
    peer.snapshot_base("w")
    peer.replica("w").buf.view(np.float32)[:] += 5.0
    peer.push_delta("w")
    lt.pull("w")                             # cold full pull over the base
    dv = lt.to_device("w", track_delta=True)
    np.testing.assert_array_equal(dv.numpy(), 5.0)
    lt.update_device("w", dv + 2.0)
    lt.push_delta("w", wire="int8")          # device-native push
    got = np.frombuffer(gt.get("w", host="check"), np.float32)
    np.testing.assert_allclose(got, 7.0, atol=1e-5)
