"""The wire-fabric suite of ``tests/test_wire_fabric.py`` through the port.

Every test of the reference's file, with the same names and parametrised
cases, run through ``repro_torch``'s state tiers on ``device="cpu"``:
quantised delta pulls (stale-base fallback, pull-side error feedback),
peer broadcast (subscriber churn, base coherence, device apply), racing
pushers, adaptive wire selection (flip-flop damping, backoff, ``auto``)
and the pull-direction kernel entry points.  Each twin asserts what its
reference test asserts.

The reference's ``xla`` and ``pallas_interpret`` backends are the port's
``auto`` (numpy operands on the CPU take the copied host codec, as the
reference's ``xla`` backend does) and ``torch`` (the kernels' plain
PyTorch versions, which stand in for the kernels on CPU tensors).  A
device replica holds a torch tensor where the reference holds a JAX
array, and a codec called by hand is told ``device="cpu"`` (the port's
codecs run on the card unless asked).  Last, the cost-model and ``set_wire_tiers`` cases of
``tests/test_codec_tiers.py``: the port copies ``WireCostModel`` and
the measured-cost ``WirePolicy``, and these name them.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.state_push import apply_pull, dequantize, encode_pull
from repro_torch.state import wire as wire_mod
from repro_torch.state.kv import GlobalTier as _GlobalTier
from repro_torch.state.local import INT8_WIRE_MIN_BYTES, LocalTier
from repro_torch.state.wire import (WireCostModel, WireFrame, WirePolicy,
                                    available_wires, get_codec)
from torch_twin_planes import port_planes_disarmed  # noqa: F401

BACKENDS = ("auto", "torch")


def GlobalTier(**kw):
    """The port's global tier with its codec on the CPU."""
    return _GlobalTier(device="cpu", **kw)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _setup(n, *, seed=0, init=None, **gt_kwargs):
    """Global tier with an n-float key, a pusher (base armed) and a puller
    (warm full replica)."""
    gt = GlobalTier(**gt_kwargs)
    init = np.zeros(n, np.float32) if init is None else init
    gt.set("w", init.tobytes(), host="up")
    pusher = LocalTier("pusher", gt)
    pusher.pull("w")
    pusher.snapshot_base("w")
    puller = LocalTier("puller", gt)
    puller.pull("w")
    return gt, pusher, puller


def _global(gt, key="w"):
    return np.frombuffer(gt.get(key, host="check"), np.float32)


# -- delta pulls ---------------------------------------------------------------


def test_warm_int8_refresh_moves_under_30_percent():
    """Acceptance criterion: a warm-replica 4 MB f32 refresh via
    ``pull(wire="int8")`` moves ≤ 30% of the exact (full) pull bytes."""
    size = 4 << 20
    n = size // 4
    gt, pusher, puller = _setup(n)
    view = pusher.replica("w").buf.view(np.float32)
    view[:] += (_rng(1).normal(size=n) * 0.01).astype(np.float32)
    pusher.push_delta("w", wire="int8")
    gt.reset_metrics()
    moved = puller.pull("w", wire="int8")
    assert 0 < moved <= 0.30 * size
    assert gt.bytes_pulled["puller"] == moved
    got = puller.replica("w").buf.view(np.float32)
    want = _global(gt)
    # one delta pull: error bounded by one quantisation step of the delta
    assert np.abs(got - want).max() <= 0.01 * 6 / 254.0 + 1e-6
    # up to date now: the next pull moves nothing
    assert puller.pull("w", wire="int8") == 0


def test_exact_delta_pull_is_exact():
    n = INT8_WIRE_MIN_BYTES // 4 * 4
    gt, pusher, puller = _setup(n)
    view = pusher.replica("w").buf.view(np.float32)
    view[:] += (_rng(2).normal(size=n)).astype(np.float32)
    pusher.push_delta("w", wire="exact")
    moved = puller.pull("w", wire="exact")
    assert moved == n * 4                       # the f32 delta frame
    np.testing.assert_array_equal(
        puller.replica("w").buf.view(np.float32), _global(gt))


def test_repeated_int8_pulls_carry_residual():
    """Pull-side error feedback: across many quantised refreshes the
    replica tracks the global value within ~one step (no random walk)."""
    n = INT8_WIRE_MIN_BYTES // 4 * 8
    gt, pusher, puller = _setup(n)
    view = pusher.replica("w").buf.view(np.float32)
    rng = _rng(3)
    for _ in range(12):
        view[:] += (rng.normal(size=n) * 0.01).astype(np.float32)
        pusher.push_delta("w", wire="exact")    # global moves exactly
        puller.pull("w", wire="int8")           # replica refreshes quantised
    got = puller.replica("w").buf.view(np.float32)
    assert np.abs(got - _global(gt)).max() <= 2 * 0.01 * 6 / 254.0
    assert puller.replica("w").pull_residual is not None


def test_stale_base_falls_back_to_full_pull():
    """A base older than the retained window floor can't be served as a
    delta: the pull degrades to a full (exact) re-pull."""
    n = INT8_WIRE_MIN_BYTES // 4
    gt, pusher, puller = _setup(n, delta_window=2)
    view = pusher.replica("w").buf.view(np.float32)
    for _ in range(5):                          # window keeps only the last 2
        view[:] += 1.0
        pusher.push_delta("w", wire="int8")
    gt.reset_metrics()
    moved = puller.pull("w", wire="int8")
    assert moved == n * 4                       # full-value bytes
    np.testing.assert_array_equal(
        puller.replica("w").buf.view(np.float32), _global(gt))
    assert puller.pull("w") == 0                # re-based: now current


def test_non_delta_write_invalidates_window():
    """set()/push() overwrite semantics can't be expressed as retained
    deltas: pulls from older bases full-pull, exactly."""
    n = INT8_WIRE_MIN_BYTES // 4
    gt, pusher, puller = _setup(n)
    view = pusher.replica("w").buf.view(np.float32)
    view[:] += 2.0
    pusher.push_delta("w", wire="int8")
    gt.set("w", np.full(n, 7.0, np.float32).tobytes(), host="up")
    gt.reset_metrics()
    moved = puller.pull("w", wire="int8")
    assert moved == n * 4
    np.testing.assert_array_equal(puller.replica("w").buf.view(np.float32),
                                  np.full(n, 7.0, np.float32))


def test_pull_after_grow_falls_back():
    """append() grows the value and invalidates the window: the warm
    replica full-pulls the grown value instead of mis-applying a delta."""
    n = INT8_WIRE_MIN_BYTES // 4
    gt, pusher, puller = _setup(n, init=np.full(n, 1.0, np.float32))
    gt.append("w", np.full(n, 5.0, np.float32).tobytes(), host="up")
    moved = puller.pull("w", wire="int8")
    assert moved == 2 * n * 4
    got = puller.replica("w").buf.view(np.float32)
    np.testing.assert_array_equal(got[n:], 5.0)


def test_pull_rejects_bogus_wire():
    n = INT8_WIRE_MIN_BYTES // 4
    gt, pusher, puller = _setup(n)
    pusher.replica("w").buf.view(np.float32)[:] += 1.0
    pusher.push_delta("w", wire="int8")
    with pytest.raises(ValueError):
        puller.pull("w", wire="bogus")


# -- peer broadcast ------------------------------------------------------------


def test_subscribed_peer_converges_with_zero_pull_bytes():
    """Acceptance criterion: after one int8 push a subscribed peer replica
    holds the new global value and its next pull moves zero bytes."""
    n = (4 << 20) // 4
    gt, pusher, _ = _setup(n)
    peer = LocalTier("peer", gt)
    peer.subscribe("w")
    gt.reset_metrics()
    view = pusher.replica("w").buf.view(np.float32)
    view[:] += (_rng(5).normal(size=n) * 0.01).astype(np.float32)
    pusher.push_delta("w", wire="int8")
    gt.flush_broadcasts()                       # fan-out is async: drain it
    # the peer replica converged through the broadcast alone
    np.testing.assert_array_equal(peer.replica("w").buf.view(np.float32),
                                  _global(gt))
    assert gt.bytes_pulled.get("peer", 0) == 0
    assert peer.pull("w", wire="int8") == 0     # zero pull bytes
    assert gt.total_broadcast() > 0             # push-side fan-out accounted


def test_broadcast_updates_base_no_repush():
    """The broadcast delta lands in the peer's delta base too: its next
    push ships only its own writes, never the peer-received delta."""
    n = INT8_WIRE_MIN_BYTES // 4
    gt, pusher, _ = _setup(n)
    peer = LocalTier("peer", gt)
    peer.subscribe("w")
    peer.snapshot_base("w")
    pview = pusher.replica("w").buf.view(np.float32)
    pview[:] += 2.0
    pusher.push_delta("w", wire="int8")         # broadcast lands at the peer
    gt.flush_broadcasts()
    peer.push_delta("w", wire="exact")          # peer pushes nothing new
    np.testing.assert_allclose(_global(gt), 2.0, atol=1e-5)


def test_broadcast_applies_to_fresh_device_replica():
    """A device-resident subscribed replica stays fresh: the frame is
    applied to the device value and base, so a later device-native push
    carries no phantom delta.  The port's device value is a torch
    tensor on the tier's device."""
    n = INT8_WIRE_MIN_BYTES // 4
    gt, pusher, _ = _setup(n)
    peer = LocalTier("peer", gt)
    peer.subscribe("w")
    peer.to_device("w", track_delta=True)
    pview = pusher.replica("w").buf.view(np.float32)
    pview[:] += 2.0
    pusher.push_delta("w", wire="int8")
    gt.flush_broadcasts()
    assert not peer.device_stale("w")
    dv = peer.device_replica("w").value
    assert isinstance(dv, torch.Tensor) and dv.device.type == "cpu"
    np.testing.assert_allclose(dv.numpy(), _global(gt), atol=1e-6)
    peer.push_delta("w", wire="int8")           # device-native, zero delta
    np.testing.assert_allclose(_global(gt), 2.0, atol=1e-5)


def test_subscriber_churn_host_leaves_mid_broadcast():
    """A subscriber whose host left (replica evicted / callback raising) is
    dropped mid-broadcast; the healthy peers still receive the frame."""
    n = INT8_WIRE_MIN_BYTES // 4
    gt, pusher, _ = _setup(n)
    healthy = LocalTier("healthy", gt)
    healthy.subscribe("w")
    leaver = LocalTier("leaver", gt)
    leaver.subscribe("w")
    calls = {"dead": 0}

    def dead_cb(key, frame):
        calls["dead"] += 1
        raise RuntimeError("host went away")

    gt.subscribe("w", "dead-host", dead_cb)
    # the leaver's host fails between subscribe and push: drop() cancels
    # its subscription, simulating departure mid-stream
    leaver.drop()
    view = pusher.replica("w").buf.view(np.float32)
    view[:] += 1.0
    pusher.push_delta("w", wire="int8")
    gt.flush_broadcasts()
    np.testing.assert_array_equal(healthy.replica("w").buf.view(np.float32),
                                  _global(gt))
    assert calls["dead"] == 1                   # delivered once, then dropped
    view[:] += 1.0
    pusher.push_delta("w", wire="int8")
    gt.flush_broadcasts()
    assert calls["dead"] == 1                   # raising subscriber was culled
    np.testing.assert_array_equal(healthy.replica("w").buf.view(np.float32),
                                  _global(gt))


def test_out_of_order_frame_skipped_then_repaired_by_pull():
    """A frame that doesn't extend the replica's exact version is skipped
    (never misapplied); the next pull repairs through the delta window."""
    n = INT8_WIRE_MIN_BYTES // 4
    gt, pusher, _ = _setup(n)
    peer = LocalTier("peer", gt)
    peer.subscribe("w")
    view = pusher.replica("w").buf.view(np.float32)
    view[:] += 1.0
    pusher.push_delta("w", wire="exact")
    gt.flush_broadcasts()
    # replay the same frame versions: prev no longer matches -> skipped
    stale = WireFrame(wire="exact", numel=n,
                      payload=np.full(n, 100.0, np.float32),
                      prev_version=0, version=1)
    peer._deliver("w", stale)
    assert float(peer.replica("w").buf.view(np.float32).max()) < 50.0
    view[:] += 1.0
    pusher.push_delta("w", wire="exact")        # peer applies (versions chain)
    gt.flush_broadcasts()
    assert peer.pull("w") == 0 or True          # and pull reconciles any gap
    np.testing.assert_allclose(peer.replica("w").buf.view(np.float32),
                               _global(gt), atol=1e-5)


def test_racing_pushers_never_replay_their_own_frame():
    """Regression: a pusher whose push raced a peer's (its frame landed on
    top of a version it never saw) must not re-apply its own delta when it
    later delta-pulls — own-origin frames are excluded from the window
    composition."""
    n = INT8_WIRE_MIN_BYTES // 4
    gt = GlobalTier()
    init = np.full(n, 10.0, np.float32)
    gt.set("w", init.tobytes(), host="up")
    a, b = LocalTier("a", gt), LocalTier("b", gt)
    for lt in (a, b):
        lt.pull("w")
        lt.snapshot_base("w")
    a.replica("w").buf.view(np.float32)[:] += 1.0
    a.push_delta("w", wire="exact")
    # b's push lands second: its frame's prev_version is a's version, which
    # b has not seen — b's global_version goes stale
    b.replica("w").buf.view(np.float32)[:] += 2.0
    b.push_delta("w", wire="exact")
    np.testing.assert_allclose(_global(gt), 13.0, atol=1e-5)
    moved = b.pull("w")                         # catches up on a's frame ONLY
    assert moved > 0
    np.testing.assert_allclose(b.replica("w").buf.view(np.float32), 13.0,
                               atol=1e-5)      # NOT 15.0 (own +2 replayed)
    assert b.pull("w") == 0
    # and b's next push carries nothing new
    b.push_delta("w", wire="exact")
    np.testing.assert_allclose(_global(gt), 13.0, atol=1e-5)


def test_broadcast_applies_f64_frames_with_value_dtype():
    """Regression: a broadcast frame for a float64 key must be applied
    through f64 views — an f32 reinterpretation scrambles the bytes."""
    n = INT8_WIRE_MIN_BYTES // 8
    gt = GlobalTier()
    gt.set("w", np.full(n, 1.0, np.float64).tobytes(), host="up")
    pusher = LocalTier("p", gt)
    pusher.pull("w")
    pusher.snapshot_base("w")
    peer = LocalTier("peer", gt)
    peer.subscribe("w")
    pusher.replica("w").buf.view(np.float64)[:] += 2.0
    pusher.push_delta("w", dtype=np.float64, wire="int8")
    gt.flush_broadcasts()                       # fan-out is async: drain it
    got = peer.replica("w").buf.view(np.float64)
    want = np.frombuffer(gt.get("w", host="x"), np.float64)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, 3.0, atol=1e-4)


def test_full_pull_fallback_refreshes_base_no_repush():
    """Regression: the warm-refresh full-pull fallback re-stamps the delta
    base from the pulled buffer — otherwise the next push re-applies every
    peer write since the stale snapshot."""
    n = INT8_WIRE_MIN_BYTES // 4
    gt, pusher, puller = _setup(n)
    puller.snapshot_base("w")                   # base at version v0
    gt.set("w", np.full(n, 7.0, np.float32).tobytes(), host="up")  # window gone
    moved = puller.pull("w")                    # fallback full pull
    assert moved == n * 4
    puller.push_delta("w", wire="exact")        # nothing local: no-op push
    np.testing.assert_allclose(_global(gt), 7.0, atol=1e-6)


def test_exact_wire_pushes_fresh_device_value():
    """Regression: the exact wire must push from a fresh DeviceReplica's
    arrays, like the int8 path — a policy flip to exact on a
    device-resident key must not silently drop device-side updates."""
    n = INT8_WIRE_MIN_BYTES // 4
    gt, pusher, _ = _setup(n)
    dv = pusher.to_device("w", track_delta=True)
    assert isinstance(dv, torch.Tensor)
    pusher.update_device("w", dv + 2.0)         # device-side compute
    pusher.replica("w").buf.view(np.float32)[:] = 1e9   # poison host copy
    pusher.push_delta("w", wire="exact")
    np.testing.assert_allclose(_global(gt), 2.0, atol=1e-6)
    pusher.push_delta("w", wire="exact")        # base rebound: no re-push
    np.testing.assert_allclose(_global(gt), 2.0, atol=1e-6)


def test_stale_refresh_keeps_unpushed_local_writes():
    """Regression: the full-pull fallback must not clobber a replica's
    un-pushed local writes — warm pulls on a dirty replica stay a no-op
    (legacy semantics) until the writes are pushed."""
    n = INT8_WIRE_MIN_BYTES // 4
    gt, pusher, puller = _setup(n, delta_window=2)
    puller.snapshot_base("w")
    puller.replica("w").buf.view(np.float32)[0] += 5.0
    puller.mark_dirty("w", 0, 4)                # un-pushed local write
    view = pusher.replica("w").buf.view(np.float32)
    for _ in range(5):                          # window floor passes puller
        view[:] += 1.0
        pusher.push_delta("w", wire="int8")
    assert puller.pull("w") == 0                # no clobber: writes pending
    assert puller.replica("w").buf.view(np.float32)[0] == 5.0
    puller.push_delta("w", wire="exact")        # ship the local write
    assert puller.pull("w") == n * 4            # clean now: full refresh
    np.testing.assert_allclose(_global(gt)[0], 10.0, atol=1e-3)
    np.testing.assert_allclose(
        puller.replica("w").buf.view(np.float32), _global(gt), atol=1e-6)


def test_inplace_exact_push_keeps_warm_pull_free():
    """Regression: the zero-copy in-place exact path (sole consumer, or
    sub-threshold keys) must keep the pusher's base version current — its
    warm pulls stay 0-byte no-ops instead of full re-pulls per push."""
    n = 1024                                    # sub-threshold f32 key
    gt = GlobalTier()
    gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
    lt = LocalTier("h", gt)
    lt.pull("w")
    lt.snapshot_base("w")
    gt.reset_metrics()
    for _ in range(3):
        lt.replica("w").buf.view(np.float32)[:] += 1.0
        lt.push_delta("w", wire="exact")        # in-place legacy path
        assert lt.pull("w") == 0                # warm pull: no re-pull
    assert gt.bytes_pulled.get("h", 0) == 0
    np.testing.assert_allclose(_global(gt), 3.0, atol=1e-6)


def test_container_sibling_tiers_are_distinct_fabric_parties():
    """Regression: container tiers share a metrics host id (`runtime`
    re-points ``host_id`` at the physical host) but must remain distinct
    wire-fabric parties — a sibling's frames are NOT 'own frames' and a
    delta pull must deliver them."""
    n = INT8_WIRE_MIN_BYTES // 4
    gt = GlobalTier()
    gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
    a = LocalTier("host0/c1", gt)
    b = LocalTier("host0/c2", gt)
    a.host_id = b.host_id = "host0"             # what container mode does
    for lt in (a, b):
        lt.pull("w")
        lt.snapshot_base("w")
    a.replica("w").buf.view(np.float32)[:] += 3.0
    a.push_delta("w", wire="int8")
    moved = b.pull("w", wire="int8")
    assert moved > 0                            # sibling's frame delivered
    np.testing.assert_allclose(b.replica("w").buf.view(np.float32), 3.0,
                               atol=1e-4)
    # and both siblings can hold broadcast subscriptions at once
    a.subscribe("w")
    b.subscribe("w")
    b.replica("w").buf.view(np.float32)[:] += 1.0
    b.push_delta("w", wire="exact")
    gt.flush_broadcasts()
    np.testing.assert_allclose(a.replica("w").buf.view(np.float32), 4.0,
                               atol=1e-4)


def test_write_only_keys_retain_no_frames():
    """Demand gating: with no other warm puller or subscriber, exact f32
    pushes stay on the zero-copy in-place path (no value-sized memcpy
    accounted) and nothing is retained; the first consumer full-pulls once
    and flips later pushes onto the frame path."""
    n = INT8_WIRE_MIN_BYTES // 4
    gt = GlobalTier()
    gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
    pusher = LocalTier("pusher", gt)
    pusher.pull("w")
    pusher.snapshot_base("w")
    assert not gt.wire_interest("w", exclude="pusher")
    gt.reset_metrics()
    pusher.replica("w").buf.view(np.float32)[:] += 1.0
    pusher.push_delta("w", wire="exact")
    assert gt.total_copied() == 0               # in-place, no frame built
    late = LocalTier("late", gt)
    late.pull("w")                              # full pull declares interest
    assert gt.wire_interest("w", exclude="pusher")
    pusher.replica("w").buf.view(np.float32)[:] += 1.0
    pusher.push_delta("w", wire="exact")        # now recorded
    assert late.pull("w", wire="exact") == n * 4   # served as a delta
    np.testing.assert_array_equal(late.replica("w").buf.view(np.float32),
                                  _global(gt))


# -- adaptive wire selection ---------------------------------------------------


def test_policy_structural_fallbacks():
    p = WirePolicy()
    assert p.select(INT8_WIRE_MIN_BYTES - 1, np.float32) == "exact"
    assert p.select(1 << 20, np.int64) == "exact"
    assert p.select(1 << 20, np.float32) == "int8"


def test_policy_flips_after_damping_and_back():
    p = WirePolicy(damping=3)
    bad = dict(delta_absmax=1.0, density=0.9, residual_ratio=2.0)
    good = dict(delta_absmax=1.0, density=0.9, residual_ratio=0.001)
    p.observe(**bad)
    p.observe(**bad)
    assert p.wire == "int8"                     # not yet: damping holds
    p.observe(**bad)
    assert p.wire == "exact"                    # 3 consecutive -> flip
    p.observe(**good)
    p.observe(**good)
    p.observe(**good)
    assert p.wire == "int8"                     # healthy again -> flip back


def test_policy_flip_flop_damped():
    """Alternating good/bad observations never accumulate a streak: the
    wire stays put instead of thrashing."""
    p = WirePolicy(damping=2)
    bad = dict(delta_absmax=1.0, density=0.9, residual_ratio=2.0)
    good = dict(delta_absmax=1.0, density=0.9, residual_ratio=0.0)
    for _ in range(10):
        p.observe(**bad)
        p.observe(**good)
    assert p.wire == "int8"
    # zero-delta pushes teach nothing either
    p.observe(delta_absmax=0.0, density=0.0, residual_ratio=9.9)
    assert p.wire == "int8"


def test_policy_prefers_exact_for_sparse_deltas():
    p = WirePolicy(damping=1)
    p.observe(delta_absmax=1.0, density=1e-5, residual_ratio=0.0)
    assert p.wire == "exact"


def test_policy_exact_observations_never_vote_int8():
    """Regression: exact-wire pushes carry no quantisation evidence
    (residual_ratio=None) — they must not vote the policy back onto int8,
    or a key int8 genuinely mishandles would thrash exact↔int8 forever.
    Returning to int8 happens only through an explicit probe push."""
    p = WirePolicy(damping=1, probe_after=3)
    big, f32 = 1 << 20, np.float32
    p.observe(delta_absmax=1.0, density=0.9, residual_ratio=2.0)
    assert p.wire == "exact"
    for _ in range(2):                          # dense exact pushes: no vote
        p.observe(delta_absmax=1.0, density=0.9)
        assert p.wire == "exact" and p.select(big, f32) == "exact"
    p.observe(delta_absmax=1.0, density=0.9)    # 3rd: probe clock expires
    assert p.select(big, f32, probe=False) == "exact"   # pulls don't consume
    assert p.select(big, f32) == "int8"         # exactly one probe push
    assert p.select(big, f32) == "exact"        # then back until evidence
    p.observe(delta_absmax=1.0, density=0.9, residual_ratio=0.0)
    assert p.wire == "int8"                     # healthy probe re-qualifies


def test_auto_wire_end_to_end():
    """wire="auto" picks int8 for a large dense f32 key (wire bytes ~¼ of
    the value) and exact for a sub-threshold key."""
    big = (1 << 20) // 4
    gt, pusher, _ = _setup(big)
    view = pusher.replica("w").buf.view(np.float32)
    view[:] += (_rng(7).normal(size=big) * 0.1).astype(np.float32)
    moved = pusher.push_delta("w", wire="auto")
    assert moved <= 0.30 * big * 4
    tiny = 16
    gt.set("t", np.zeros(tiny, np.float32).tobytes(), host="up")
    lt = LocalTier("h", gt)
    lt.pull("t")
    lt.snapshot_base("t")
    lt.replica("t").buf.view(np.float32)[:] = 3.0
    assert lt.push_delta("t", wire="auto") == tiny * 4     # exact path
    np.testing.assert_array_equal(_global(gt, "t"), 3.0)


def test_policy_backoff_switches_pushes_to_exact():
    """End-to-end adaptivity: deltas so sparse the per-row scales carry no
    information flip the key's policy after `damping` pushes, and auto
    pushes move to the exact wire."""
    n = INT8_WIRE_MIN_BYTES // 4 * 4
    gt, pusher, _ = _setup(n)
    pol = pusher.wire_policy("w")
    view = pusher.replica("w").buf.view(np.float32)
    for _ in range(pol.damping):
        view[0] += 5.0                          # a single spot write
        assert pusher.push_delta("w", wire="auto") <= 0.3 * n * 4
    assert pol.wire == "exact"
    view[:] += 1.0
    assert pusher.push_delta("w", wire="auto") == n * 4    # exact frame now
    np.testing.assert_allclose(_global(gt)[1:], 1.0, atol=1e-4)


# -- pull-direction kernel entry points (ref + interpret parity) ---------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [64, 128, 1000])
def test_encode_pull_apply_pull_roundtrip(backend, n):
    rng = _rng(n)
    new = rng.normal(size=n).astype(np.float32)
    base = rng.normal(size=n).astype(np.float32)
    q, s, numel = encode_pull(new, base, backend=backend, device="cpu")
    assert numel == n
    deq = np.asarray(dequantize(q, s, numel))
    bound = np.abs(new - base).max() / 254.0 + 1e-6
    assert np.abs(deq - (new - base)).max() <= bound
    val = rng.normal(size=n).astype(np.float32)
    got = np.asarray(apply_pull(val, q, s, backend=backend, device="cpu"))
    np.testing.assert_allclose(got, val + deq, atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("wire", ("exact", "int8"))
def test_tier_delta_pull_parity(backend, wire):
    """A warm-replica refresh lands the same value whichever backend runs
    the codec, and the exact wire is bit-exact with the global value."""
    n = INT8_WIRE_MIN_BYTES // 4 * 2
    gt, pusher, puller = _setup(n, seed=13)
    view = pusher.replica("w").buf.view(np.float32)
    view[:] += (_rng(13).normal(size=n) * 0.05).astype(np.float32)
    pusher.push_delta("w", wire="exact", backend=backend)
    moved = puller.pull("w", wire=wire, backend=backend)
    assert moved > 0
    got = puller.replica("w").buf.view(np.float32)
    want = _global(gt)
    if wire == "exact":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 0.05 * 6 / 254.0 + 1e-6


# -- frame plumbing ------------------------------------------------------------


def test_wire_frame_nbytes_and_decode():
    delta = np.arange(8, dtype=np.float32)
    exact = get_codec("exact").encode_delta(delta, device="cpu")
    assert exact.nbytes == 32
    np.testing.assert_array_equal(exact.decode(), delta)
    int8 = get_codec("int8").encode_delta(delta, device="cpu")
    assert int8.nbytes == int8.payload.nbytes + int8.scales.nbytes
    assert int8.numel == 8
    assert np.abs(int8.decode() - delta).max() <= delta.max() / 254.0 + 1e-6


def test_exact_frame_push_matches_legacy_inplace():
    """The exact f32 frame path lands bit-identical results to the old
    in-place add (same math, now recordable/broadcastable)."""
    n = 256
    rng = _rng(17)
    init = rng.normal(size=n).astype(np.float32)
    upd = rng.normal(size=n).astype(np.float32)

    # _setup's puller declares interest, so pusher1 takes the frame path
    gt1, pusher1, _ = _setup(n, init=init.copy())
    pusher1.replica("w").buf.view(np.float32)[:] += upd
    pusher1.push_delta("w", wire="exact")

    gt2 = GlobalTier()
    gt2.set("w", init.tobytes(), host="up")
    lt2 = LocalTier("h", gt2)
    lt2.pull("w")
    lt2.snapshot_base("w")
    local = lt2.replica("w").buf.view(np.float32)
    local[:] += upd
    base = lt2.replica("w").base.view(np.float32)
    gt2.add_inplace("w", local, base, host="h")
    got1, got2 = _global(gt1), _global(gt2)
    np.testing.assert_allclose(got1, init + upd, atol=1e-6)
    np.testing.assert_allclose(got1, got2, atol=1e-6)


# -- WireCostModel and set_wire_tiers (tests/test_codec_tiers.py) ---------------


def test_cost_model_bucket_clamps():
    assert WireCostModel.bucket(1) == WireCostModel.MIN_BUCKET
    assert WireCostModel.bucket(1 << 20) == 20
    assert WireCostModel.bucket(1 << 40) == WireCostModel.MAX_BUCKET


def test_cost_model_frame_bytes():
    vb = 128 * 4 * 8                          # 8 rows of f32
    assert WireCostModel.frame_bytes("exact", vb) == vb
    assert WireCostModel.frame_bytes("int8", vb) == 8 * 128 + 8 * 4
    assert WireCostModel.frame_bytes("int4", vb) == 8 * 64 + 8 * 4
    assert WireCostModel.frame_bytes("fp8", vb) == 8 * 128 + 8 * 4


def test_cost_model_predict_needs_evidence_then_learns():
    m = WireCostModel()
    assert m.predict("int8", 1 << 20) is None
    m.observe("int8", 1 << 20, 2_000_000, wall_ns=5_000_000)
    p = m.predict("int8", 1 << 20)
    assert p == pytest.approx(5_000_000)
    # EWMA moves toward new evidence without jumping
    m.observe("int8", 1 << 20, 4_000_000, wall_ns=8_000_000)
    p2 = m.predict("int8", 1 << 20)
    assert 5_000_000 < p2 < 8_000_000


def test_cost_model_rescales_from_nearest_bucket():
    m = WireCostModel()
    m.observe("exact", 1 << 20, 1_000_000, wall_ns=1_500_000)
    # 4 MB never observed: the 1 MB evidence rescales linearly
    p = m.predict("exact", 1 << 22)
    assert p == pytest.approx(6_000_000)


def test_cost_model_link_bandwidth_term():
    m = WireCostModel(link_bytes_per_s=1e6)   # 1 MB/s — glacial
    m.observe("exact", 1 << 20, 1_000, wall_ns=2_000)
    m.observe("int8", 1 << 20, 500_000, wall_ns=600_000)
    # exact ships 4x the bytes: on a slow link int8 must win
    assert m.predict("int8", 1 << 20) < m.predict("exact", 1 << 20)


def test_cost_model_seed_from_bench_schema():
    bench = {"value_kb": [64, 4096],
             "64kb": {"exact": {"encode_us_p50": 50.0, "push_us_p50": 100.0,
                                "bytes_per_push": 65536},
                      "int8": {"encode_us_p50": 150.0, "push_us_p50": 300.0,
                               "bytes_per_push": 17408},
                      "auto": {"push_us_p50": 99.0},
                      "crossover_mbps": {"int8": 100.0}},
             "4096kb": {"exact": {"encode_us_p50": 4000.0,
                                  "push_us_p50": 8000.0}}}
    m = WireCostModel()
    assert m.seed(bench) == 3                 # auto/crossover rows skipped
    assert m.predict("exact", 64 << 10) == pytest.approx(100.0 * 1e3)
    assert m.predict("int8", 64 << 10) == pytest.approx(300.0 * 1e3)
    snap = m.snapshot()
    assert 16 in snap["exact"] and 22 in snap["exact"]


def _armed(**kw):
    return wire_mod.enable_cost_model(**kw)


def test_policy_cost_mode_probes_unknown_then_argmins():
    m = _armed()
    pol = WirePolicy(tiers=("int8",))
    nb = 1 << 20
    # nothing observed: exact is first unknown → probe it
    assert pol.select(nb, np.float32) == "exact"
    m.observe("exact", nb, 1_000_000, wall_ns=2_000_000)
    # int8 still unknown → probed next
    assert pol.select(nb, np.float32) == "int8"
    m.observe("int8", nb, 500_000, wall_ns=900_000)
    assert pol.select(nb, np.float32) == "int8"     # measured cheapest
    m.observe("int8", nb, 9_000_000, wall_ns=20_000_000)
    assert pol.select(nb, np.float32) == "exact"    # evidence flipped it
    assert pol.flips >= 2


def test_policy_cost_mode_residual_ban_and_reprobe():
    m = _armed()
    pol = WirePolicy(tiers=("int8",), damping=3, probe_after=4)
    nb = 1 << 20
    m.observe("exact", nb, 1_000_000, wall_ns=2_000_000)
    m.observe("int8", nb, 100_000, wall_ns=200_000)
    assert pol.select(nb, np.float32) == "int8"
    # 3 consecutive over-cap residuals ban the tier despite its low cost
    for _ in range(3):
        pol.observe(delta_absmax=1.0, density=1.0,
                    residual_ratio=0.9, wire="int8")
    assert pol.select(nb, np.float32) == "exact"   # advances the ban clock
    # every probe_after-th select routes one re-qualification push onto the
    # banned tier (the assert above already advanced the clock once)
    wires = [pol.select(nb, np.float32) for _ in range(4)]
    assert wires.count("int8") == 1
    assert all(w == "exact" for w in wires if w != "int8")
    # the re-probe comes back clean → tier un-banned, wins again on cost
    pol.observe(delta_absmax=1.0, density=1.0,
                residual_ratio=0.01, wire="int8")
    assert pol.select(nb, np.float32) == "int8"


def test_policy_cost_mode_structural_fallbacks_hold():
    _armed()
    pol = WirePolicy(tiers=("int8", "int4"))
    assert pol.select(64, np.float32) == "exact"          # below min_bytes
    assert pol.select(1 << 20, np.int32) == "exact"       # non-float


def test_policy_legacy_regime_untouched_when_disarmed():
    pol = WirePolicy(tiers=("int8",), damping=2)
    nb = 1 << 20
    assert pol.select(nb, np.float32) == "int8"
    for _ in range(2):
        pol.observe(delta_absmax=1.0, density=1.0,
                    residual_ratio=0.9, wire="int8")
    assert pol.select(nb, np.float32) == "exact"
    assert pol.flips == 1


def test_auto_push_with_cost_model_takes_cheapest_wire():
    """End to end: an armed cost model seeded to favour int8 routes an
    ``auto`` push onto the int8 wire; spans aside, the global value still
    converges."""
    n = 256 << 8
    m = _armed()
    for w in available_wires():
        # seed: int8 measured far cheaper than anything else at this size
        ns = 100_000 if w == "int8" else 10_000_000
        m.observe(w, n * 4, ns, wall_ns=ns * 2)
    gt = GlobalTier()
    gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
    lt = LocalTier("h0", gt)
    lt.set_wire_tiers(*[w for w in available_wires() if w != "exact"])
    lt.pull("w")
    lt.snapshot_base("w")
    LocalTier("q", gt).pull("w")
    view = lt.replica("w").buf.view(np.float32)
    u = (_rng(23).normal(size=n) * 0.01).astype(np.float32)
    view[:] += u
    lt.push_delta("w", wire="auto")
    assert lt.wire_policy("w").wire == "int8"
    got = np.frombuffer(gt.get("w", host="check"), np.float32)
    assert np.abs(got - u).max() <= np.abs(u).max() / 254.0 + 1e-6
