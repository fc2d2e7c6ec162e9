"""The runtime cases of ``tests/test_runtime.py`` that
``tests/test_torch_runtime.py`` does not carry, through the port.

Of the reference's 14 tests, two are carried there under other names:
``test_invoke_and_output`` and ``test_chained_calls_listing1_pattern``
by the quickstart scenario (``test_quickstart_value`` and
``test_packages_end_in_the_same_value[quickstart]``: an orchestrator
invokes, chains 16 workers, awaits them and reads their outputs).  The
other twelve are here, under their own names, run through
``repro_torch``'s runtime on ``device="cpu"``: the warm Faaslet reset
(§5.2), the Proto-Faaslet restored on another host, warm placement, a
host failure's re-execution, state surviving it in the global tier,
speculation, elastic hosts, the container/Faaslet transfer contrast,
counters under concurrency, the container tier dropped on a failed call,
the straggler cancelled after its twin settles, and the host interface.
Each asserts what its reference test asserts.  The port's sanitizer,
fault, telemetry and cost-model planes are handled by the fixtures of
``tests/torch_twin_planes.py``.
"""
import time

import numpy as np
import pytest

from repro_torch.core import FaasmRuntime as _FaasmRuntime
from repro_torch.core import FunctionDef, ProtoFaaslet
from repro_torch.state.ddo import Counter, VectorAsync
from torch_twin_planes import port_planes_disarmed, port_sanitize  # noqa: F401


def FaasmRuntime(*args, **kwargs):
    """The port's runtime on the CPU."""
    return _FaasmRuntime(*args, device="cpu", **kwargs)



def _echo(api):
    api.write_call_output(b"echo:" + api.read_call_input())
    return 0






def test_warm_faaslets_reused_and_reset():
    """Second call hits a warm Faaslet; private memory is reset between calls
    (§5.2 multi-tenant guarantee)."""
    rt = FaasmRuntime(n_hosts=1)
    try:
        leaks = []

        def fn(api):
            api.faaslet.brk(64)
            data = bytes(api.faaslet.read(0, 6))
            leaks.append(data)
            api.faaslet.write(0, b"secret")
            return 0

        rt.upload(FunctionDef("fn", fn))
        for _ in range(3):
            assert rt.wait(rt.invoke("fn"), timeout=10) == 0
        stats = rt.cold_start_stats()
        assert stats["warm_hits"] >= 2
        assert len(leaks) == 3
        assert b"secret" not in leaks[1:]            # reset wiped it
        # the reset went through the O(dirty) CoW path, not a full copy
        assert stats["resets"] == 3
        assert 1 <= stats["reset_pages"] <= 3
    finally:
        rt.shutdown()


def test_proto_faaslet_cross_host_restore():
    p = None

    def init(api):
        api.faaslet.brk(128)
        api.faaslet.write(0, b"weights-v1")
        return {"extra": 42}

    rt = FaasmRuntime(n_hosts=2)
    try:
        rt.upload(FunctionDef("f", _echo, init_fn=init))
        key = "proto/f"
        assert rt.global_tier.exists(key)
        proto = ProtoFaaslet.deserialize(rt.global_tier.get(key, host="test"))
        faaslet, state = proto.restore("some-other-host")
        assert bytes(faaslet.read(0, 10)) == b"weights-v1"
        assert state == {"extra": 42}
        assert faaslet.restored_from_proto
    finally:
        rt.shutdown()


def test_scheduler_prefers_warm_hosts():
    rt = FaasmRuntime(n_hosts=4)
    try:
        rt.upload(FunctionDef("f", _echo))
        first = rt.invoke("f", b"a")
        rt.wait(first, timeout=10)
        warm_host = rt.call(first).host
        hosts = set()
        for _ in range(6):
            cid = rt.invoke("f", b"b")
            rt.wait(cid, timeout=10)
            hosts.add(rt.call(cid).host)
        assert warm_host in hosts
        stats = rt.cold_start_stats()
        assert stats["warm_hits"] >= 5               # most calls stayed warm
    finally:
        rt.shutdown()


def test_host_failure_reexecutes_calls():
    rt = FaasmRuntime(n_hosts=2)
    try:
        def slow(api):
            time.sleep(0.4)
            api.write_call_output(b"done")
            return 0

        rt.upload(FunctionDef("slow", slow))
        cid = rt.invoke("slow")
        time.sleep(0.1)
        victim = rt.call(cid).host
        assert victim is not None
        rt.fail_host(victim)
        assert rt.wait(cid, timeout=30) == 0
        assert rt.output(cid) == b"done"
        assert rt.call(cid).attempts == 2
    finally:
        rt.shutdown()


def test_state_survives_host_failure_via_global_tier():
    rt = FaasmRuntime(n_hosts=2)
    try:
        VectorAsync.create(rt.global_tier, "w", np.arange(4, dtype=np.float32))

        def reader(api):
            v = VectorAsync(api, "w")
            api.write_call_output(np.asarray(v.values, np.float32).tobytes())
            return 0

        rt.upload(FunctionDef("reader", reader))
        c1 = rt.invoke("reader")
        rt.wait(c1, timeout=10)
        rt.fail_host(rt.call(c1).host)               # local tier dropped
        c2 = rt.invoke("reader")
        assert rt.wait(c2, timeout=10) == 0
        got = np.frombuffer(rt.output(c2), np.float32)
        np.testing.assert_allclose(got, np.arange(4, dtype=np.float32))
    finally:
        rt.shutdown()


def test_straggler_speculative_execution():
    rt = FaasmRuntime(n_hosts=2, straggler_timeout=0.3)
    try:
        state = {"n": 0}

        def sometimes_slow(api):
            state["n"] += 1
            if state["n"] == 1:
                time.sleep(5.0)                      # first attempt straggles
            api.write_call_output(b"ok")
            return 0

        rt.upload(FunctionDef("s", sometimes_slow))
        t0 = time.perf_counter()
        cid = rt.invoke("s")
        assert rt.wait(cid, timeout=30) == 0
        assert time.perf_counter() - t0 < 4.0        # didn't wait for straggler
    finally:
        rt.shutdown()


def test_elastic_add_remove_host():
    rt = FaasmRuntime(n_hosts=1)
    try:
        rt.upload(FunctionDef("echo", _echo))
        hid = rt.add_host()
        assert len(rt.alive_hosts()) == 2
        cids = [rt.invoke("echo", bytes([i])) for i in range(6)]
        for c in cids:
            rt.wait(c, timeout=10)
        rt.remove_host(hid, drain=True)
        assert len(rt.alive_hosts()) == 1
        cid = rt.invoke("echo", b"post")
        assert rt.wait(cid, timeout=10) == 0
    finally:
        rt.shutdown()


def test_container_mode_ships_data_faaslet_shares():
    """The §6 comparison: same code, container mode moves more bytes."""
    results = {}
    for mode in ("faaslet", "container"):
        rt = FaasmRuntime(n_hosts=1, isolation=mode)
        try:
            VectorAsync.create(rt.global_tier,
                               "big", np.zeros(50_000, np.float32))

            def toucher(api):
                api.get_state("big", writable=False)
                time.sleep(0.3)                     # force concurrent instances
                return 0

            rt.upload(FunctionDef("t", toucher))
            rt.global_tier.reset_metrics()
            cids = [rt.invoke("t") for _ in range(4)]
            for c in cids:
                assert rt.wait(c, timeout=15) == 0
            results[mode] = rt.transfer_bytes()
        finally:
            rt.shutdown()
    # container mode re-pulls per instance; faaslets share one replica
    assert results["faaslet"] < results["container"]


def test_counter_and_dict_consistency_under_concurrency():
    rt = FaasmRuntime(n_hosts=3, capacity=4)
    try:
        def inc(api):
            Counter(api, "c").increment()
            return 0

        rt.upload(FunctionDef("inc", inc))
        cids = [rt.invoke("inc") for _ in range(20)]
        for c in cids:
            assert rt.wait(c, timeout=20) == 0

        def read(api):
            api.write_call_output(str(Counter(api, "c").value()).encode())
            return 0

        rt.upload(FunctionDef("read", read))
        cid = rt.invoke("read")
        rt.wait(cid, timeout=10)
        assert rt.output(cid) == b"20"
    finally:
        rt.shutdown()


def test_container_tier_dropped_on_failed_call():
    """A failed call in container isolation must not leave its private tier
    (half-written replicas) behind: the retry re-pulls clean state."""
    rt = FaasmRuntime(n_hosts=1, isolation="container")
    try:
        VectorAsync.create(rt.global_tier, "w", np.zeros(8, np.float32))
        attempts = {"n": 0}

        def writer(api):
            attempts["n"] += 1
            v = VectorAsync(api, "w")
            v[0] = 13.0                          # half-written replica
            if attempts["n"] == 1:
                raise RuntimeError("boom")       # fail before push
            # retry: the private replica must be a clean re-pull, not the
            # poisoned one from the failed attempt
            api.write_call_output(
                np.asarray(v.values, np.float32).tobytes())
            return 0

        rt.upload(FunctionDef("writer", writer))
        host = rt.hosts["host0"]
        c1 = rt.invoke("writer")
        assert rt.wait(c1, timeout=10) == 1      # first attempt fails
        assert host._container_tiers == {}       # tier dropped with the failure
        c2 = rt.invoke("writer")
        assert rt.wait(c2, timeout=10) == 0
    finally:
        rt.shutdown()


def test_straggler_cancelled_after_twin_settles():
    """Speculation cleanup: once the twin's result is adopted, the straggler
    stops at its next host-interface checkpoint instead of running its loop
    to completion in an executor slot."""
    rt = FaasmRuntime(n_hosts=2, straggler_timeout=0.2)
    try:
        VectorAsync.create(rt.global_tier, "w", np.zeros(4, np.float32))
        progress = {"first": 0}
        state = {"n": 0}

        def sometimes_slow(api):
            state["n"] += 1
            if state["n"] == 1:                  # first attempt straggles
                for _ in range(100):
                    time.sleep(0.05)
                    api.pull_state("w")          # cooperative checkpoint
                    progress["first"] += 1
            api.write_call_output(b"ok")
            return 0

        rt.upload(FunctionDef("s", sometimes_slow))
        cid = rt.invoke("s")
        assert rt.wait(cid, timeout=30) == 0
        assert rt.output(cid) == b"ok"
        # the straggler hits a checkpoint within ~50ms of the twin settling
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline and \
                sum(h.cancelled_execs for h in rt.hosts.values()) == 0:
            time.sleep(0.05)
        assert sum(h.cancelled_execs for h in rt.hosts.values()) == 1
        assert progress["first"] < 50            # it stopped early, not at 100
        assert rt.call(cid).status == "done"     # the adopted result stands
    finally:
        rt.shutdown()


def test_host_interface_misc():
    rt = FaasmRuntime(n_hosts=1)
    try:
        rt.vfs.put_global("models/readme.txt", b"hello file")
        rt.register_module("libmath", {"square": lambda x: x * x})

        def fn(api):
            fd = api.open("models/readme.txt")
            data = api.read(fd, 100)
            api.close(fd)
            h = api.dlopen("libmath")
            sq = api.dlsym(h, "square")
            t = api.gettime()
            rnd = api.getrandom(8)
            assert t >= 0 and len(rnd) == 8
            wfd = api.open("scratch/out.txt", "w")
            api.write(wfd, b"local write")
            api.close(wfd)
            api.write_call_output(data + str(sq(7)).encode())
            return 0

        rt.upload(FunctionDef("fn", fn))
        cid = rt.invoke("fn")
        assert rt.wait(cid, timeout=10) == 0, rt.call(cid).error
        assert rt.output(cid) == b"hello file49"
        # write-local: visible on the host overlay, not the global store
        assert rt.vfs.read(rt.call(cid).host, "scratch/out.txt") == b"local write"
        assert not rt.global_tier.exists("fs::scratch/out.txt")
    finally:
        rt.shutdown()
