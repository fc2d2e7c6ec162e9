"""The port's Faasm runtime and two-tier state against the JAX package's.

Each scenario runs in both packages, ``repro`` and ``repro_torch`` (on
``device="cpu"``, where the port's kernels take their plain versions and
numpy buffers the copied host codec), from the same numpy inputs.  On the
exact wire the two end in the same global value bitwise; on the quantised
wires within the int8 bound, absmax/127·1.01 per push.  Covered: the
quickstart flow, int8 pushes with error feedback, warm delta pulls and peer
broadcast, attempt-fenced duplicate pushes, the device-replica plane (the
cases of ``tests/test_quantized_push.py``, device values as torch tensors),
the torch-specific hazards (aliasing, host copies, residual placement), a
failing encode (only the injected codec fault falls back to the exact wire)
and one scenario under the runtime sanitizer in a subprocess.
"""
import importlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

PKGS = ("repro", "repro_torch")
REPO = Path(__file__).resolve().parents[1]
N_DEV = 1024                 # INT8_WIRE_MIN_BYTES // 4: the int8 floor


class Pkg:
    """One package's runtime and state modules, with the port on the CPU."""

    def __init__(self, name: str):
        self.name = name
        self.core = importlib.import_module(f"{name}.core")
        self.kv = importlib.import_module(f"{name}.state.kv")
        self.local = importlib.import_module(f"{name}.state.local")
        self.ddo = importlib.import_module(f"{name}.state.ddo")
        self.dev = {"device": "cpu"} if name == "repro_torch" else {}

    def global_tier(self, **kw):
        return self.kv.GlobalTier(**kw, **self.dev)

    def runtime(self, **kw):
        return self.core.FaasmRuntime(**kw, **self.dev)


@pytest.fixture(params=PKGS)
def pkg(request):
    return Pkg(request.param)


@pytest.fixture(autouse=True)
def _port_planes_disarmed():
    """The port's own fault, telemetry and cost-model planes never leak
    from one test into the next (conftest disarms the reference's)."""
    yield
    from repro_torch import faults, telemetry
    from repro_torch.state import wire
    faults.disarm()
    telemetry.disable()
    wire.disable_cost_model()


def _host(x) -> np.ndarray:
    """A device value (jax array or torch tensor) as host numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _global(gt, key="w"):
    return np.frombuffer(gt.get(key, host="check"), np.float32).copy()


def _tier(p: Pkg, gt, host="h0", key="w", track=True):
    lt = p.local.LocalTier(host, gt)
    lt.pull(key)
    if track:
        lt.snapshot_base(key)
    return lt


# -- scenarios: each returns the final global value -------------------------------


def quickstart(p: Pkg) -> np.ndarray:
    """examples/quickstart.py: an orchestrator chains 8 workers that
    HOGWILD-add into a shared vector and push deltas."""
    rt = p.runtime(n_hosts=2, capacity=4)
    try:
        p.ddo.VectorAsync.create(rt.global_tier, "acc", np.zeros(8, np.float32))

        def worker(api):
            i = int.from_bytes(api.read_call_input(), "little")
            vec = p.ddo.VectorAsync(api, "acc")
            vec.pull(track_delta=True)
            vec.add([i % 8], [float(i)])
            vec.push_delta()
            p.ddo.Counter(api, "done").increment()
            api.write_call_output(f"worker-{i} ok".encode())
            return 0

        def orchestrator(api):
            ids = p.core.chain(api, "worker",
                               [i.to_bytes(2, "little") for i in range(16)])
            assert all(c == 0 for c in p.core.await_all(api, ids))
            api.write_call_output(b"; ".join(p.core.outputs(api, ids)))
            return 0

        rt.upload(p.core.FunctionDef("worker", worker))
        rt.upload(p.core.FunctionDef("orchestrator", orchestrator))
        cid = rt.invoke("orchestrator")
        assert rt.wait(cid, timeout=60) == 0
        assert rt.output(cid).count(b"ok") == 16
        return _global(rt.global_tier, "acc")
    finally:
        rt.shutdown()


def int8_error_feedback(p: Pkg) -> np.ndarray:
    """Twelve int8 pushes of N(0, 0.01) updates from one replica."""
    n = 1 << 14
    gt = p.global_tier()
    gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
    lt = _tier(p, gt)
    view = lt.replica("w").buf.view(np.float32)
    rng = np.random.default_rng(11)
    for _ in range(12):
        view[:] += (rng.normal(size=n) * 0.01).astype(np.float32)
        lt.push_delta("w", wire="int8")
    return _global(gt)


def warm_pull_and_broadcast(p: Pkg) -> np.ndarray:
    """A warm replica refreshes through int8 delta pulls while a subscribed
    peer converges by broadcast alone; returns global, puller, peer."""
    n = N_DEV * 8
    gt = p.global_tier()
    gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
    pusher = _tier(p, gt, "pusher")
    puller = _tier(p, gt, "puller", track=False)
    peer = p.local.LocalTier("peer", gt)
    peer.subscribe("w")
    view = pusher.replica("w").buf.view(np.float32)
    rng = np.random.default_rng(3)
    for _ in range(6):
        view[:] += (rng.normal(size=n) * 0.01).astype(np.float32)
        pusher.push_delta("w", wire="int8")
        gt.flush_broadcasts()        # the bounded fan-out drains per frame
        assert puller.pull("w", wire="int8") > 0
    assert gt.bytes_pulled.get("peer", 0) == n * 4     # the initial sync only
    return np.concatenate([_global(gt),
                           puller.replica("w").buf.view(np.float32),
                           peer.replica("w").buf.view(np.float32)])


def fenced_duplicate(p: Pkg) -> np.ndarray:
    """A re-sent push under the same attempt fence applies once."""
    n = N_DEV * 2
    gt = p.global_tier()
    gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
    a, b = _tier(p, gt, "a"), _tier(p, gt, "b")
    a.replica("w").buf.view(np.float32)[:] += 1.5
    assert a.push_delta("w", wire="int8", fence=("c1", 1, 1)) > 0
    b.replica("w").buf.view(np.float32)[:] += 1.5
    assert b.push_delta("w", wire="int8", fence=("c1", 1, 1)) == 0  # dup
    a.replica("w").buf.view(np.float32)[:] += 0.25
    assert a.push_delta("w", wire="exact", fence=("c1", 1, 2)) > 0
    return _global(gt)


SCENARIOS = {   # name: (scenario, exact wire?, pushes, |delta| max per push)
    "quickstart": (quickstart, True, 16, None),
    "int8_error_feedback": (int8_error_feedback, False, 12, 0.06),
    "warm_pull_and_broadcast": (warm_pull_and_broadcast, False, 6, 0.06),
    "fenced_duplicate": (fenced_duplicate, False, 2, 1.5),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_packages_end_in_the_same_value(name):
    scenario, exact, pushes, absmax = SCENARIOS[name]
    want = scenario(Pkg("repro"))
    got = scenario(Pkg("repro_torch"))
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        bound = pushes * absmax / 127 * 1.01
        assert np.abs(got - want).max() <= bound


def test_quickstart_value(pkg):
    want = np.zeros(8, np.float32)
    for i in range(16):
        want[i % 8] += i
    np.testing.assert_array_equal(quickstart(pkg), want)


def test_int8_error_feedback_tracks_exact(pkg):
    n, rng = 1 << 14, np.random.default_rng(11)
    want = np.zeros(n, np.float32)
    for _ in range(12):
        want += (rng.normal(size=n) * 0.01).astype(np.float32)
    # error feedback: one half-step of the last push, not twelve
    assert np.abs(int8_error_feedback(pkg) - want).max() <= 2 * 0.06 / 254


def test_warm_pull_and_broadcast_converge(pkg):
    g, puller, peer = np.split(warm_pull_and_broadcast(pkg), 3)
    np.testing.assert_array_equal(peer, g)            # broadcast: exact copy
    assert np.abs(puller - g).max() <= 2 * 0.06 / 254  # pull residual carried


def test_fenced_duplicate_applies_once(pkg):
    np.testing.assert_allclose(fenced_duplicate(pkg), 1.75, atol=1.5 / 254)


# -- a failing encode: only the injected codec fault is rescued -------------------


def test_injected_codec_error_falls_back_to_exact_wire():
    from repro_torch import faults
    gt, lt = _dev_setup(Pkg("repro_torch"))
    lt.replica("w").buf.view(np.float32)[:] += 1.0
    with faults.armed(faults.FaultPlan(seed=7).add("codec-error")) as plan:
        assert lt.push_delta("w", wire="int8") > 0
        assert plan.fired("codec-error") == 1
    assert lt.codec_fallbacks == 1
    np.testing.assert_array_equal(_global(gt), np.ones(N_DEV, np.float32))


@pytest.mark.parametrize("replica", ["host", "device"])
def test_kernel_error_fails_the_push(monkeypatch, replica):
    """A kernel that fails to build or launch raises out of ``push_delta``:
    it is not rescued onto the host's exact wire, and nothing lands."""
    from repro_torch.kernels.state_push import ops

    def broken(*a, **kw):
        raise RuntimeError("state_push: launch failed")

    gt, lt = _dev_setup(Pkg("repro_torch"))
    if replica == "device":
        lt.update_device("w", lt.to_device("w", track_delta=True) + 1.0)
    else:
        lt.replica("w").buf.view(np.float32)[:] += 1.0
    monkeypatch.setattr(ops, "encode_quant", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        lt.push_delta("w", wire="int8")
    assert lt.codec_fallbacks == 0
    np.testing.assert_array_equal(_global(gt), np.zeros(N_DEV, np.float32))


# -- the device-replica plane (tests/test_quantized_push.py), device="cpu" --------


def _dev_setup(p: Pkg, init=None, track=True):
    gt = p.global_tier()
    init = np.zeros(N_DEV, np.float32) if init is None else init
    gt.set("w", init.tobytes(), host="up")
    return gt, _tier(p, gt, track=track)


def test_device_replica_sync_and_staleness(pkg):
    gt, lt = _dev_setup(pkg, np.arange(N_DEV, dtype=np.float32), track=False)
    dv = lt.to_device("w")
    if pkg.name == "repro_torch":
        assert isinstance(dv, torch.Tensor) and dv.device.type == "cpu"
    assert _host(dv)[5] == 5.0 and not lt.device_stale("w")
    ver = lt.device_replica("w").synced_version
    assert lt.to_device("w") is dv                     # synced: no re-upload
    lt.replica("w").buf.view(np.float32)[0] = 99.0
    lt.mark_dirty("w", 0, 4)
    assert lt.device_stale("w")
    dv2 = lt.to_device("w")
    assert _host(dv2)[0] == 99.0
    assert lt.device_replica("w").synced_version > ver
    lt.update_device("w", dv2 + 1.0)
    assert not lt.device_stale("w") and lt.device_replica("w").device_dirty
    assert lt.from_device("w") == N_DEV * 4
    assert lt.replica("w").buf.view(np.float32)[0] == 100.0
    assert not lt.device_replica("w").device_dirty


def test_device_native_int8_push_skips_host_buffer(pkg):
    gt, lt = _dev_setup(pkg, track=False)
    dv = lt.to_device("w", track_delta=True)
    lt.update_device("w", dv + 2.0)
    lt.replica("w").buf.view(np.float32)[:] = 1e9      # poison the host copy
    gt.reset_metrics()
    assert lt.push_delta("w", wire="int8") < N_DEV * 4
    np.testing.assert_allclose(_global(gt), 2.0, atol=1e-5)
    lt.push_delta("w", wire="int8")                    # base refreshed
    np.testing.assert_allclose(_global(gt), 2.0, atol=1e-5)


def test_stale_device_copy_is_not_pushed(pkg):
    gt, lt = _dev_setup(pkg)
    lt.to_device("w", track_delta=True)
    lt.replica("w").buf.view(np.float32)[:] = 3.0
    lt.mark_dirty("w", 0, N_DEV * 4)
    lt.push_delta("w", wire="int8")
    np.testing.assert_allclose(_global(gt), 3.0, atol=1e-4)


def test_device_push_without_track_delta_uses_host_base(pkg):
    init = np.arange(N_DEV, dtype=np.float32)
    gt, lt = _dev_setup(pkg, init)
    lt.to_device("w")
    lt.push_delta("w", wire="int8")
    np.testing.assert_allclose(_global(gt), init, atol=init.max() / 200)


def test_from_device_carries_base_no_double_push(pkg):
    gt, lt = _dev_setup(pkg)
    dv = lt.to_device("w", track_delta=True)
    lt.update_device("w", dv + 2.0)
    lt.push_delta("w", wire="int8")
    lt.from_device("w")
    lt.push_delta("w")
    np.testing.assert_allclose(_global(gt), 2.0, atol=1e-4)


def test_track_delta_does_not_drop_pending_device_writes(pkg):
    gt, lt = _dev_setup(pkg, track=False)
    dv = lt.to_device("w", track_delta=True)
    lt.update_device("w", dv + 2.0)
    assert _host(lt.to_device("w", track_delta=True))[0] == 2.0
    lt.push_delta("w", wire="int8")
    np.testing.assert_allclose(_global(gt), 2.0, atol=1e-5)


def test_device_push_then_host_push_no_double_apply(pkg):
    gt, lt = _dev_setup(pkg)
    lt.replica("w").buf.view(np.float32)[:] = 1.0
    lt.mark_dirty("w", 0, N_DEV * 4)
    lt.to_device("w")
    lt.push_delta("w", wire="int8")
    lt.mark_dirty("w", 0, 4)
    lt.push_delta("w", wire="int8")
    np.testing.assert_allclose(_global(gt), 1.0, atol=1e-4)


def test_host_writes_survive_device_dirty_push(pkg):
    gt, lt = _dev_setup(pkg, track=False)
    dv = lt.to_device("w", track_delta=True)
    lt.update_device("w", dv + 2.0)
    lt.replica("w").buf.view(np.float32)[0] = 7.0
    lt.mark_dirty("w", 0, 4)
    lt.push_delta("w", wire="int8")
    assert lt.replica("w").dirty_chunks
    np.testing.assert_allclose(_global(gt), 2.0, atol=1e-5)


@pytest.mark.parametrize("wire", ["exact", "int8"])
def test_broadcast_applies_to_fresh_device_replica(pkg, wire):
    gt, pusher = _dev_setup(pkg)
    peer = pkg.local.LocalTier("peer", gt)
    peer.subscribe("w")
    peer.to_device("w", track_delta=True)
    pusher.replica("w").buf.view(np.float32)[:] += 2.0
    pusher.push_delta("w", wire=wire)
    gt.flush_broadcasts()
    assert not peer.device_stale("w")
    np.testing.assert_allclose(_host(peer.device_replica("w").value),
                               _global(gt), atol=1e-6)
    peer.push_delta("w", wire="int8")                  # zero delta
    np.testing.assert_allclose(_global(gt), 2.0, atol=1e-5)


def test_runtime_device_plane(pkg):
    """Two hosts: a call pushes from its device replica over the int8 wire;
    the other host's device replica catches up through a delta pull."""
    rt = pkg.runtime(n_hosts=2, capacity=2)
    try:
        gt = rt.global_tier
        gt.set("w", np.zeros(N_DEV * 4, np.float32).tobytes(), host="up")
        for h in rt.hosts.values():                    # warm replicas
            h.local_tier.pull("w")
            h.local_tier.to_device("w")

        def dev_push(api):
            dv = api.state_to_device("w", track_delta=True)
            api.state_update_device("w", dv + 0.5)
            api.push_state_delta("w", wire="int8")
            return 0

        rt.upload(pkg.core.FunctionDef("dev_push", dev_push))
        cid = rt.invoke("dev_push")
        assert rt.wait(cid, timeout=60) == 0
        other = next(h for h in rt.hosts.values() if h.id != rt.call(cid).host)
        assert other.local_tier.pull("w", wire="int8") > 0
        assert not other.local_tier.device_stale("w")
        dev = _host(other.local_tier.device_replica("w").value)
        np.testing.assert_allclose(dev, _global(gt), atol=0.5 / 254)
        np.testing.assert_allclose(_global(gt), 0.5, atol=0.5 / 254)
    finally:
        rt.shutdown()


# -- hazards of tensors that JAX arrays do not have (the port only) ---------------


def _port_dev_setup():
    return _dev_setup(Pkg("repro_torch"), track=False)


def test_aliasing_frames_apply_once_to_value_and_base():
    """A frame lands once in the device value and once in the delta base,
    which is a copy, not a second name for the value: an in-place apply
    through an alias would add it to the base twice, and the next push
    would ship a phantom negative delta."""
    gt, pusher = _port_dev_setup()
    peer = pusher.__class__("peer", gt)
    peer.subscribe("w")
    dv = peer.to_device("w", track_delta=True)
    d = peer.device_replica("w")
    assert d.base is not d.value and d.base.data_ptr() != d.value.data_ptr()
    pusher.replica("w").buf.view(np.float32)[:] += 2.0
    pusher.push_delta("w", wire="int8")
    gt.flush_broadcasts()
    assert torch.equal(dv, torch.zeros(N_DEV))         # not updated in place
    torch.testing.assert_close(d.value, torch.full((N_DEV,), 2.0),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(d.base, d.value, atol=0, rtol=0)
    peer.push_delta("w", wire="int8")
    np.testing.assert_allclose(_global(gt), 2.0, atol=1e-5)


def test_aliasing_in_place_device_write_is_pushed():
    """A torch user may write the tensor ``to_device`` returned in place
    before installing it: the base must not move with it."""
    gt, lt = _port_dev_setup()
    dv = lt.to_device("w", track_delta=True)
    dv.add_(3.0)
    lt.update_device("w", dv)
    lt.push_delta("w", wire="int8")
    np.testing.assert_allclose(_global(gt), 3.0, atol=1e-5)
    dv.add_(1.0)                                       # again, same tensor
    lt.update_device("w", dv)
    lt.push_delta("w", wire="int8")
    np.testing.assert_allclose(_global(gt), 4.0, atol=1e-5)


def test_host_copies_device_replica_is_a_snapshot():
    """On the CPU a device replica must not share memory with the shared
    host buffer (``torch.from_numpy`` would), nor with a numpy array handed
    to ``update_device``: writes on either side stay on that side."""
    gt, lt = _port_dev_setup()
    dv = lt.to_device("w")
    buf = lt.replica("w").buf.view(np.float32)
    buf[:] = 5.0                                       # host write
    assert float(dv.abs().max()) == 0.0
    dv.fill_(7.0)                                      # device write
    assert buf[0] == 5.0
    src = np.full(N_DEV, 2.0, np.float32)
    lt.update_device("w", src)                         # numpy in: copied
    src[:] = -1.0                                      # the caller reuses it
    assert float(lt.device_replica("w").value.min()) == 2.0


def test_residual_placement_device_owns_the_debt():
    """While the device replica is fresh its error-feedback residual is a
    tensor on the device; ``from_device`` hands it back to the host as an
    owned numpy array, and ``to_device`` moves it over again."""
    gt, lt = _port_dev_setup()
    dv = lt.to_device("w", track_delta=True)
    upd = torch.from_numpy(np.random.default_rng(0).normal(
        size=N_DEV).astype(np.float32))
    lt.update_device("w", dv + upd)
    lt.push_delta("w", wire="int8")
    d = lt.device_replica("w")
    assert isinstance(d.residual, torch.Tensor) and d.residual.numel() == N_DEV
    assert lt.replica("w").residual is None
    want = d.residual.clone()
    step = float(upd.abs().max()) / 127
    assert float(want.abs().max()) <= step / 2 + 1e-6
    lt.from_device("w")
    host_resid = lt.replica("w").residual
    assert d.residual is None and isinstance(host_resid, np.ndarray)
    np.testing.assert_array_equal(host_resid, want.numpy())
    host_resid_copy = host_resid.copy()
    want.zero_()                                       # no shared memory
    np.testing.assert_array_equal(lt.replica("w").residual, host_resid_copy)
    lt.mark_dirty("w", 0, 4)                           # device copy stale:
    lt.to_device("w")                                  # re-sync moves it over
    assert isinstance(lt.device_replica("w").residual, torch.Tensor)
    assert lt.replica("w").residual is None
    host_resid[:] = 9.0                                # the old host array
    np.testing.assert_array_equal(lt.device_replica("w").residual.numpy(),
                                  host_resid_copy)
    # the debt is paid exactly once: global + residual == pushed content
    got = _global(gt) + lt.device_replica("w").residual.numpy()
    np.testing.assert_allclose(got, upd.numpy(), atol=1e-6)


# -- HOGWILD writes and window-miss refreshes (the port's fix) ---------------------


def test_window_miss_refresh_keeps_unpushed_writes():
    """A delta-tracked replica whose base fell out of the retained window
    catches up in place: a HOGWILD add that landed in the shared buffer
    but is not (or no longer) marked dirty survives the refresh and reaches
    the global tier with the next push.  The reference's full-pull
    fallback overwrites the buffer and loses it."""
    p = Pkg("repro_torch")
    gt = p.global_tier(delta_window=2)
    gt.set("w", np.zeros(N_DEV, np.float32).tobytes(), host="up")
    a, b = _tier(p, gt, "a"), _tier(p, gt, "b")
    a.replica("w").buf.view(np.float32)[:] += 1.0
    a.push_delta("w", wire="exact")                    # a is delta-tracked
    for _ in range(4):                                 # b pushes a's base
        b.replica("w").buf.view(np.float32)[:] += 0.5  # out of the window
        b.push_delta("w", wire="exact")
    a.replica("w").buf.view(np.float32)[7] += 10.0     # HOGWILD add, not
    assert not a.replica("w").dirty_chunks             # yet marked dirty
    assert a.pull("w") == N_DEV * 4                    # a window miss
    buf = a.replica("w").buf.view(np.float32)
    np.testing.assert_array_equal(buf[:7], 3.0)
    assert buf[7] == 13.0
    a.push_delta("w", wire="exact")
    want = np.full(N_DEV, 3.0, np.float32)
    want[7] = 13.0
    np.testing.assert_array_equal(_global(gt), want)


@pytest.mark.parametrize("same_token", [True, False], ids=["same", "spread"])
def test_concurrent_int8_fanout_keeps_its_counts(same_token):
    """Eight executor threads pull, add one count and push over the int8
    wire, as the serving fan-out does, at a switch interval of 1 µs that
    widens every race window.  The in-place catch-up keeps every write
    that was in the buffer when it read it; the reference's full pull
    drops such writes in this scenario.  Every write of the shared buffer
    (an add, the catch-up's move, a frame's apply) holds the replica's
    buffer mutex for its one numpy call, so no two of them interleave:
    no count is lost, and the sum is off by the int8 residual alone."""
    p, calls, vocab = Pkg("repro_torch"), 160, 4096
    rt = p.runtime(n_hosts=1, capacity=8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        p.ddo.VectorAsync.create(rt.global_tier, "stats",
                                 np.zeros(vocab, np.float32))

        def count(api):
            i = int.from_bytes(api.read_call_input(), "little")
            stats = p.ddo.VectorAsync(api, "stats")
            stats.pull(track_delta=True)
            stats.add([5 if same_token else i * 31 % vocab], 1.0)
            stats.push_delta(wire="int8")
            return 0

        rt.upload(p.core.FunctionDef("count", count))
        cids = rt.invoke_many("count", [i.to_bytes(4, "little")
                                        for i in range(calls)])
        assert rt.wait_all(cids, timeout=120) == [0] * calls
        got = _global(rt.global_tier, "stats")
    finally:
        sys.setswitchinterval(old)
        rt.shutdown()
    want = np.bincount([5 if same_token else i * 31 % vocab
                        for i in range(calls)], minlength=vocab)
    assert np.abs(got - want).max() <= calls * 1.01 / 127
    assert abs(calls - got.sum()) <= calls * 1.01 / 127


@pytest.mark.parametrize("wire", ["exact", "int8"])
def test_device_replica_push_keeps_concurrent_adds(wire):
    """One function pushes the key from a fresh device replica, again and
    again, while eight co-located functions add HOGWILD into the host
    buffer at a switch interval of 1 µs; a peer tier subscribes, so the
    exact wire ships frames too.  A push from the device copy re-bases the
    host buffer from the content the copy was synced from, never from a
    second read of the live buffer, and a push from the host buffer drops
    the device copy's stale base and takes back its debt: an add that
    lands during a push stays pending, none is pushed twice, and the
    global value counts every add.  Exactly on the exact wire; on int8
    within f32 rounding, since each delta's one nonzero element is its
    row's absmax and quantises to ±127 codes.  The peer equals the
    global value after one repair pull."""
    p, adders, adds = Pkg("repro_torch"), 8, 200
    rt = p.runtime(n_hosts=1, capacity=adders + 1)
    done = threading.Event()
    pushes = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        p.ddo.VectorAsync.create(rt.global_tier, "w",
                                 np.zeros(N_DEV, np.float32))
        peer = p.local.LocalTier("peer", rt.global_tier)
        peer.subscribe("w")

        def add(api):
            vec = p.ddo.VectorAsync(api, "w")
            for _ in range(adds):
                vec.add([5], 1.0)
            return 0

        def push(api):
            vec = p.ddo.VectorAsync(api, "w")
            while not done.is_set():
                api.state_to_device("w")
                vec.push_delta(wire=wire)
                pushes.append(1)
            vec.push_delta(wire=wire)
            return 0

        rt.upload(p.core.FunctionDef("add", add))
        rt.upload(p.core.FunctionDef("push", push))
        pusher = rt.invoke("push")
        cids = rt.invoke_many("add", [b""] * adders)
        assert rt.wait_all(cids, timeout=120) == [0] * adders
        done.set()
        assert rt.wait(pusher, timeout=120) == 0
        got = _global(rt.global_tier)
        peer.pull("w")
        seen = peer.replica("w").buf.view(np.float32).copy()
    finally:
        sys.setswitchinterval(old)
        rt.shutdown()
    want = np.zeros(N_DEV, np.float32)
    want[5] = adders * adds
    assert pushes
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0 if wire == "exact" else 1e-3)
    np.testing.assert_array_equal(seen, got)


def test_add_after_host_failure_leaves_the_global_value():
    """A handle whose replica a host failure dropped keeps the replica it
    mapped: an add then fails in ``mark_dirty`` (a ``KeyError``, as the
    reference's does) instead of dirtying a fresh zero-filled replica, and
    a push after it writes nothing over the global value."""
    p = Pkg("repro_torch")
    rt = p.runtime(n_hosts=1, capacity=1)
    seen, finished = [], threading.Event()
    init = np.arange(N_DEV, dtype=np.float32)
    try:
        p.ddo.VectorAsync.create(rt.global_tier, "w", init)

        def fn(api):
            try:
                vec = p.ddo.VectorAsync(api, "w")
                api.host.fail()
                for op in (lambda: vec.add([3], 1.0), vec.push):
                    try:
                        op()
                        seen.append(None)
                    except KeyError as e:
                        seen.append(e)
            finally:
                finished.set()
            return 0

        rt.upload(p.core.FunctionDef("fn", fn))
        rt.invoke("fn")
        assert finished.wait(60)
        got = _global(rt.global_tier)
    finally:
        rt.shutdown()
    assert len(seen) == 2 and all(isinstance(e, KeyError) for e in seen)
    np.testing.assert_array_equal(got, init)


def test_stats_push_wave_in_both_packages(pkg):
    """The fan-out's serve/stats pull, add and int8 push alone, under one
    8-executor wave of 64 calls at qwen1.5-0.5b's vocabulary, through each
    package (``benchmarks/bench_stats_push_torch.py::stats_wave``): every
    call returns 0; the port's global value is the tokens' histogram
    within the int8 residual, with no count lost; the reference's counts
    no more than it was given (it keeps its HOGWILD loss).  Each
    package's mean pull, add and push a call are printed (``-s``)."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from benchmarks.bench_stats_push_torch import (CALLS, EXECUTORS,
                                                   INT8_STEP, stats_wave)
    r = stats_wave(pkg.core, pkg.ddo, runtime_kw=pkg.dev)
    calls = CALLS + EXECUTORS
    bound = calls * INT8_STEP
    print(f"stats wave [{pkg.name}]: pull {r['pull_ms']:.3f}ms, add "
          f"{r['add_ms']:.3f}ms, int8 push {r['push_ms']:.3f}ms, "
          f"{r['stats_ms']:.3f}ms a call; wave {r['wall_s'] * 1e3:.1f}ms")
    assert r["rcs"] == [0] * calls
    assert r["stats"].sum() <= calls + bound
    if pkg.name == "repro_torch":
        assert np.abs(r["stats"] - r["want"]).max() <= bound
        assert abs(calls - r["stats"].sum()) <= bound


# -- under the runtime sanitizer ---------------------------------------------------


SANITIZED = """
import numpy as np
from repro_torch.analysis import sanitizer
sanitizer.enable()
from repro_torch.core import FaasmRuntime, FunctionDef
from repro_torch.state.ddo import VectorAsync
rt = FaasmRuntime(n_hosts=2, capacity=4, device="cpu")
VectorAsync.create(rt.global_tier, "acc", np.zeros(2048, np.float32))
def worker(api):
    i = int.from_bytes(api.read_call_input(), "little")
    vec = VectorAsync(api, "acc")
    vec.pull(track_delta=True)
    vec.add([i], [1.0])
    vec.push_delta(wire="int8")
    return 0
rt.upload(FunctionDef("worker", worker))
rcs = rt.wait_all(rt.invoke_many("worker", [i.to_bytes(2, "little")
                                            for i in range(32)]), timeout=120)
final = np.frombuffer(rt.global_tier.get("acc", host="x"), np.float32)
rt.shutdown()
assert rcs == [0] * 32, rcs
assert np.abs(final[:32] - 1.0).max() <= 32 / 127 * 1.01, final[:32]
reports = sanitizer.take_reports()
assert not reports, reports
print("sanitized OK")
"""


def test_int8_fanout_under_the_sanitizer():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), FAASM_SANITIZE="1")
    r = subprocess.run([sys.executable, "-c", SANITIZED], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "sanitized OK" in r.stdout
