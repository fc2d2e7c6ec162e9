"""The CoW Proto-Faaslet restore and zero-copy state plane of
``tests/test_cow_state.py`` through the port.

Every test of the reference's file, with the same names, parametrised
cases and markers, run through ``repro_torch``'s ``core/faaslet.py``,
``core/proto.py``, ``core/runtime.py``, ``core/scheduler.py``,
``state/kv.py`` and ``state/local.py`` on ``device="cpu"``: dirty-page
tracking, the eager copy under ``EAGER_COPY_MAX_BYTES``, the CoW restore
sharing its base without a leak, the dirty reset byte-identical to a full
restore (the paper's §5.2 guarantee), ``readinto``/``write_from``
bounds, ``add_inplace``, the atomic rewrite, the delta-record warm set,
madvise reclaim and the real-RSS pressure.  Each twin asserts what its
reference test asserts.

The port's sanitizer is its own (``repro_torch.analysis.sanitizer``):
``tests/conftest.py`` drives the reference's, so the fixtures of
``tests/torch_twin_planes.py`` turn the port's on for ``sanitize``-marked
tests (and under ``FAASM_SANITIZE=1``), fail a test on any report it
did not take, and disarm the port's fault, telemetry and cost-model
planes after every test.  ``GlobalTier`` and ``FaasmRuntime`` are the port's, on the
CPU (the port runs on the card unless asked).
"""

import numpy as np
import pytest

from repro_torch.core import FaasmRuntime as _FaasmRuntime
from repro_torch.core import FunctionDef, ProtoFaaslet
from repro_torch.core.faaslet import (EAGER_COPY_MAX_BYTES, ArenaBase, Faaslet,
                                      WASM_PAGE)
from repro_torch.core.scheduler import WARM_PREFIX
from repro_torch.state.kv import GlobalTier as _GlobalTier
from repro_torch.state.local import LocalTier
from torch_twin_planes import port_planes_disarmed, port_sanitize  # noqa: F401


def GlobalTier(*args, **kwargs):
    """The port's global tier with its codec on the CPU."""
    return _GlobalTier(*args, device="cpu", **kwargs)


def FaasmRuntime(*args, **kwargs):
    """The port's runtime on the CPU."""
    return _FaasmRuntime(*args, device="cpu", **kwargs)



# -- dirty-page tracking ------------------------------------------------------


def test_write_and_brk_mark_dirty_pages():
    f = Faaslet("fn", "h0", memory_limit=8 * WASM_PAGE)
    f.brk(2 * WASM_PAGE)                      # exposes pages 0-1
    assert f.dirty_pages == {0, 1}
    f.clear_dirty()
    f.write(WASM_PAGE + 10, b"abc")           # page 1 only
    assert f.dirty_pages == {1}
    f.write(WASM_PAGE - 1, b"xy")             # straddles pages 0/1
    assert f.dirty_pages == {0, 1}


def test_shared_region_writes_do_not_dirty_arena():
    f = Faaslet("fn", "h0")
    backing = np.zeros(256, np.uint8)
    r = f.map_shared_region("k", backing)
    f.write(r.base + 3, b"zz")
    assert f.dirty_pages == set()


# -- CoW restore / reset ------------------------------------------------------


def _make_proto(arena_bytes: int, fill: bytes = b"\xab") -> ProtoFaaslet:
    limit = max(arena_bytes, WASM_PAGE)
    f = Faaslet("fn", "h0", memory_limit=2 * limit)
    f.brk(arena_bytes)
    f.write(0, fill * (arena_bytes // len(fill)))
    return ProtoFaaslet.capture(f, {"model": [1, 2, 3]})


def test_cow_restore_small_uses_eager_copy():
    proto = _make_proto(2 * WASM_PAGE)
    assert len(proto.arena) <= EAGER_COPY_MAX_BYTES
    assert proto.arena_base()._fd < 0         # no memfd for tiny snapshots
    f, state = proto.restore("h1")
    assert state == {"model": [1, 2, 3]}
    assert bytes(f.read(0, 4)) == b"\xab" * 4
    assert f.restored_from_proto


def test_cow_restore_large_shares_base_no_leak():
    pages = EAGER_COPY_MAX_BYTES // WASM_PAGE + 4      # force the mmap path
    proto = _make_proto(pages * WASM_PAGE)
    a, _ = proto.restore("h0")
    b, _ = proto.restore("h0")
    a.write(7 * WASM_PAGE, b"private!")
    # b maps the same base but must not see a's private write
    assert bytes(b.read(7 * WASM_PAGE, 8)) == b"\xab" * 8
    # and the base itself is untouched
    assert proto.arena[7 * WASM_PAGE:7 * WASM_PAGE + 8] == b"\xab" * 8


@pytest.mark.parametrize("arena_pages", [2, EAGER_COPY_MAX_BYTES // WASM_PAGE + 4])
def test_dirty_reset_byte_identical_to_full_restore(arena_pages):
    """Same writes, one faaslet reset via dirty pages, one restored full-copy:
    the arenas must match byte for byte (the §5.2 isolation guarantee)."""
    proto = _make_proto(arena_pages * WASM_PAGE)
    f, _ = proto.restore("h0")
    limit = f.memory_limit
    f.brk(limit)                              # grow past the snapshot
    f.write(0, b"A" * (WASM_PAGE + 123))      # dirty low pages
    f.write(limit - 3000, b"B" * 2999)        # dirty pages beyond the snapshot
    stamped = f.reset_from_base()
    assert stamped >= 2                       # low pages + tail pages
    ref, _ = proto.restore_copy("h0")         # the old full-copy baseline
    span = min(f._arena.size, max(ref._arena.size, len(proto.arena)))
    got = np.asarray(f._arena[:span])
    want = np.zeros(span, np.uint8)
    want[:len(proto.arena)] = np.frombuffer(proto.arena, np.uint8)
    assert np.array_equal(got, want)
    assert f.brk_value == proto.brk == ref.brk_value


def test_reset_clears_dirty_and_is_idempotent():
    proto = _make_proto(2 * WASM_PAGE)
    f, _ = proto.restore("h0")
    f.write(0, b"junk")
    assert f.reset_from_base() >= 1
    assert f.dirty_pages == set()
    assert f.reset_from_base() == 0           # nothing dirty: O(0)


def test_user_state_template_cached_once():
    proto = _make_proto(WASM_PAGE)
    _, s1 = proto.restore("h0")
    _, s2 = proto.restore("h1")
    assert s1 is s2                           # decoded once, shared read-only


def test_proto_pickle_roundtrip_drops_caches():
    proto = _make_proto(WASM_PAGE)
    proto.arena_base()                        # populate caches
    proto.user_state_template()
    clone = ProtoFaaslet.deserialize(proto.serialize())
    assert clone.arena == proto.arena and clone.brk == proto.brk
    f, state = clone.restore("hX")
    assert state == {"model": [1, 2, 3]}
    assert bytes(f.read(0, 2)) == b"\xab\xab"


def test_arena_read_views_are_readonly():
    """Writes must go through write() so dirty tracking (and thus the §5.2
    reset) sees them — a read() view of the arena cannot be a side door."""
    proto = _make_proto(2 * WASM_PAGE)
    f, _ = proto.restore("h0")
    view = f.read(0, 4)
    with pytest.raises((ValueError, RuntimeError)):
        view[:] = 0x45
    # shared regions keep the zero-copy write path (unless mapped read-only)
    backing = np.zeros(128, np.uint8)
    region = f.map_shared_region("k", backing)
    f.read(region.base, 4)[:] = 7             # allowed: writable region
    assert backing[0] == 7
    ro = f.map_shared_region("k2", np.zeros(64, np.uint8), writable=False)
    with pytest.raises((ValueError, RuntimeError)):
        f.read(ro.base, 4)[:] = 1


def test_cow_faaslet_memory_charged_once_per_base():
    """Clean mmap-CoW pages belong to the shared base: N warm Faaslets from
    one snapshot must not be billed N full arenas.  Eager-copied arenas are
    fully private and stay charged in full."""
    from repro_torch.core.faaslet import FAASLET_OVERHEAD_BYTES
    pages = EAGER_COPY_MAX_BYTES // WASM_PAGE + 4      # force the mmap path
    proto = _make_proto(pages * WASM_PAGE)
    faaslets = [proto.restore("h0")[0] for _ in range(4)]
    if faaslets[0]._mm is None:
        pytest.skip("mmap/memfd unavailable: eager fallback in use")
    fps = {f.base_footprint() for f in faaslets}
    assert len(fps) == 1                      # one shared base
    _, base_bytes = next(iter(fps))
    assert base_bytes == pages * WASM_PAGE
    for f in faaslets:
        assert f.memory_bytes() == FAASLET_OVERHEAD_BYTES   # no dirty pages
    faaslets[0].write(0, b"x")
    assert faaslets[0].memory_bytes() == WASM_PAGE + FAASLET_OVERHEAD_BYTES
    # eager path: the arena is a private copy, charged in full
    small = _make_proto(2 * WASM_PAGE)
    g, _ = small.restore("h0")
    assert g.base_footprint() is None
    assert g.memory_bytes() == g._arena.size + FAASLET_OVERHEAD_BYTES


# -- zero-copy global-tier primitives ----------------------------------------


def test_readinto_write_from_roundtrip_and_bounds():
    gt = GlobalTier()
    gt.set("k", bytes(range(64)), host="up")
    dest = np.zeros(16, np.uint8)
    assert gt.readinto("k", 8, dest, host="h") == 16
    assert bytes(dest) == bytes(range(8, 24))
    with pytest.raises(IndexError):
        gt.readinto("k", 60, dest, host="h")
    src = np.full(8, 0xEE, np.uint8)
    gt.write_from("k", 4, src, host="h")
    assert gt.get_range("k", 4, 8, host="h") == b"\xee" * 8
    # extension + gap zero-fill
    gt.set("short", b"ab", host="up")
    gt.write_from("short", 6, src, host="h")
    assert gt.get("short", host="h") == b"ab\x00\x00\x00\x00" + b"\xee" * 8


def test_readinto_clamps_after_concurrent_truncation():
    """A pull sized before a truncating push must copy what exists, not
    fail — the race the bytes-typed get() path tolerated."""
    gt = GlobalTier()
    gt.set("k", bytes(range(64)), host="up")
    dest = np.zeros(64, np.uint8)
    gt.write_from("k", 0, np.ones(16, np.uint8), host="h", truncate=True)
    moved = gt.readinto("k", 0, dest, host="h", clamp=True)
    assert moved == 16
    assert bytes(dest[:16]) == b"\x01" * 16
    with pytest.raises(IndexError):           # strict mode still traps
        gt.readinto("k", 0, dest, host="h")


def test_write_from_truncate_semantics():
    gt = GlobalTier()
    gt.set("k", bytes(32), host="up")
    gt.write_from("k", 0, np.ones(8, np.uint8), host="h", truncate=True)
    assert gt.size("k") == 8                  # full-value push replaced it


def test_pull_push_delta_single_copy_accounting():
    size = 256 * 1024
    gt = GlobalTier()
    gt.set("w", np.zeros(size // 4, np.float32).tobytes(), host="up")
    lt = LocalTier("h0", gt)
    gt.reset_metrics()
    lt.pull("w")
    lt.snapshot_base("w")
    lt.replica("w").buf.view(np.float32)[5] += 2.5
    lt.push_delta("w")
    # one full-value memcpy for the pull, zero for the in-place delta push
    assert gt.total_copied() == size
    assert np.frombuffer(gt.get("w", host="x"), np.float32)[5] == 2.5


def test_add_inplace_accumulates_and_clips():
    gt = GlobalTier()
    gt.set("w", np.zeros(4, np.float32).tobytes(), host="up")
    local = np.array([1, 2, 3, 4, 99], np.float32)     # longer than global
    base = np.array([0, 1, 0, 1, 0], np.float32)
    moved = gt.add_inplace("w", local, base, host="h")
    assert moved == 16                        # clipped to the stored value
    np.testing.assert_allclose(
        np.frombuffer(gt.get("w", host="x"), np.float32), [1, 1, 3, 3])


def test_append_amortised_and_rewrite_atomic():
    gt = GlobalTier()
    for i in range(100):
        gt.append("log", f"+h{i}\n".encode(), host="h")
    assert gt.get("log", host="h").count(b"\n") == 100
    new, ver = gt.rewrite("log", lambda cur: b"+h99\n", host="h")
    assert new == b"+h99\n" and gt.get("log", host="h") == b"+h99\n"
    assert ver == gt.version("log")           # version captured atomically


# -- delta-record warm set ----------------------------------------------------


def test_warm_set_delta_records_and_compaction():
    rt = FaasmRuntime(n_hosts=2)
    try:
        s0 = rt.schedulers["host0"]
        s1 = rt.schedulers["host1"]
        key = WARM_PREFIX + "f"
        s0.register_warm("f")
        assert rt.global_tier.get(key, host="t") == b"+host0\n"
        s0.register_warm("f")                  # member already: no new record
        assert rt.global_tier.get(key, host="t") == b"+host0\n"
        s1.register_warm("f")
        assert s0.warm_hosts("f") == ["host0", "host1"]
        s1.deregister_warm("host1", "f")
        assert s0.warm_hosts("f") == ["host0"]
        # churn: the log compacts instead of growing without bound
        for _ in range(30):
            s1.register_warm("f")
            s1._warm_cache.clear()
            s1.deregister_warm("host1", "f")
        assert s0.warm_hosts("f") == ["host0"]
        assert rt.global_tier.get(key, host="t").count(b"\n") <= \
            2 + 8 + 1                          # membership + slack + in-flight
        # a registration appends one small record, not the whole list
        rt.global_tier.reset_metrics()
        s1.register_warm("f")
        assert rt.global_tier.bytes_pushed["host1"] == len(b"+host1\n")
    finally:
        rt.shutdown()


def test_warm_set_survives_runtime_paths():
    """End-to-end: placement still prefers warm hosts with the delta log."""
    rt = FaasmRuntime(n_hosts=3)
    try:
        def echo(api):
            api.write_call_output(api.read_call_input())
            return 0

        rt.upload(FunctionDef("e", echo))
        first = rt.invoke("e", b"x")
        rt.wait(first, timeout=10)
        for _ in range(5):
            cid = rt.invoke("e", b"y")
            assert rt.wait(cid, timeout=10) == 0
        assert rt.cold_start_stats()["warm_hits"] >= 4
    finally:
        rt.shutdown()


# -- CoW page reclaim (madvise) ----------------------------------------------


def test_reset_reclaims_dirty_pages_via_madvise():
    """On the mmap path the post-call reset hands dirty pages back with
    madvise(MADV_DONTNEED): content refaults to the shared base (byte-
    identical to re-stamping) and ``reclaimed_pages`` counts them."""
    import mmap as _mmap
    pages = EAGER_COPY_MAX_BYTES // WASM_PAGE + 4      # force the mmap path
    proto = _make_proto(pages * WASM_PAGE)
    f, _ = proto.restore("h0")
    if f._mm is None or not hasattr(_mmap, "MADV_DONTNEED"):
        pytest.skip("mmap/madvise unavailable: memcpy fallback in use")
    f.write(0, b"junk" * 64)
    f.write(5 * WASM_PAGE + 3, b"zz")
    f.write(6 * WASM_PAGE, b"ww")                      # contiguous run with 5
    n = f.reset_from_base()
    assert n >= 3
    assert f.reclaimed_pages >= 3                      # reclaimed, not copied
    assert f.dirty_pages == set()
    # refault reads the shared base content back
    assert bytes(f.read(0, 8)) == b"\xab" * 8
    assert bytes(f.read(5 * WASM_PAGE, 8)) == b"\xab" * 8
    assert bytes(f.read(6 * WASM_PAGE, 8)) == b"\xab" * 8
    # beyond-snapshot pages refault as zeros (the memfd hole)
    f.brk(f.memory_limit)
    f.write(f.memory_limit - WASM_PAGE + 7, b"tail")
    f.reset_from_base()
    f.brk(f.memory_limit)
    assert bytes(f.read(f.memory_limit - WASM_PAGE, 16)) == bytes(16)


def test_reset_reclaim_never_retains_pages():
    """``reclaim="never"`` re-stamps dirty pages in place: content is
    restored, nothing is madvise'd back, ``retained_pages`` counts them."""
    pages = EAGER_COPY_MAX_BYTES // WASM_PAGE + 4
    proto = _make_proto(pages * WASM_PAGE)
    f, _ = proto.restore("h0")
    f.write(2 * WASM_PAGE + 5, b"scratch")
    n = f.reset_from_base(reclaim="never")
    assert n >= 1
    assert f.reclaimed_pages == 0
    assert f.retained_pages >= 1
    assert bytes(f.read(2 * WASM_PAGE, 8)) == b"\xab" * 8


def test_reset_reclaim_auto_follows_pressure():
    """``reclaim="auto"`` retains without pressure (hot Faaslet stays
    refault-free) and reclaims under pressure (mmap path)."""
    pages = EAGER_COPY_MAX_BYTES // WASM_PAGE + 4
    proto = _make_proto(pages * WASM_PAGE)
    f, _ = proto.restore("h0")
    f.write(0, b"hot")
    f.reset_from_base(reclaim="auto", pressure=False)
    assert f.reclaimed_pages == 0 and f.retained_pages >= 1
    retained0 = f.retained_pages
    f.write(0, b"cold")
    f.reset_from_base(reclaim="auto", pressure=True)
    if f._mm is not None and hasattr(__import__("mmap"), "MADV_DONTNEED"):
        assert f.reclaimed_pages >= 1
        assert f.retained_pages == retained0
    assert bytes(f.read(0, 4)) == b"\xab" * 4
    with pytest.raises(ValueError):
        f.reset_from_base(reclaim="bogus")


def test_proc_rss_bytes_reads_real_rss():
    """/proc/self/statm field 2 × page size — positive and at least as big
    as the interpreter's floor on any linux box."""
    from repro_torch.core import runtime as rtmod
    rss = rtmod._proc_rss_bytes()
    if rss is None:
        pytest.skip("procfs unavailable")
    assert rss > 4 << 20                      # a bare CPython is > 4 MB


def test_reclaim_auto_pressure_from_real_rss_with_fallback(monkeypatch):
    """``reclaim="auto"`` reads real RSS growth since host init; a zero
    threshold means every reset sees pressure.  When procfs reads fail the
    bookkeeping estimate takes over — with a huge threshold it reports no
    pressure and the hot Faaslet is retained."""
    import mmap as _mmap
    if not hasattr(_mmap, "MADV_DONTNEED"):
        pytest.skip("madvise unavailable")
    from repro_torch.core import runtime as rtmod

    def run(threshold):
        rt = FaasmRuntime(n_hosts=1, reclaim="auto")
        try:
            rt.hosts["host0"].reclaim_rss_bytes = threshold

            def init(api):
                api.brk(EAGER_COPY_MAX_BYTES + 2 * WASM_PAGE)
                return None

            def touch_mem(api):
                api.sbrk(WASM_PAGE)
                return 0

            rt.upload(FunctionDef("touch_mem", touch_mem, init_fn=init,
                                  memory_limit=4 * EAGER_COPY_MAX_BYTES))
            for _ in range(3):
                assert rt.wait(rt.invoke("touch_mem"), timeout=20) == 0
            warm = rt.hosts["host0"]._warm["touch_mem"]
            mmapped = bool(warm) and warm[0]._mm is not None
            return rt.cold_start_stats(), mmapped
        finally:
            rt.shutdown()

    # real-RSS path, threshold 0: any growth (or none) >= 0 is pressure
    stats, mmapped = run(0)
    if mmapped:
        assert stats["reclaimed_pages"] >= 1
    # procfs gone: the estimate path with the default 256 MB threshold
    # sees no pressure from a few WASM pages — the Faaslet is retained
    monkeypatch.setattr(rtmod, "_proc_rss_bytes", lambda: None)
    stats, _ = run(256 << 20)
    assert stats["reclaimed_pages"] == 0
    assert stats["retained_pages"] >= 1


def test_runtime_reset_splits_reclaimed_and_retained():
    """End-to-end metric split: an "always" runtime reports reclaimed
    pages, a "never" runtime reports the same work as retained."""
    import mmap as _mmap
    if not hasattr(_mmap, "MADV_DONTNEED"):
        pytest.skip("madvise unavailable")

    def run(reclaim):
        rt = FaasmRuntime(n_hosts=1, reclaim=reclaim)
        try:
            def init(api):
                api.brk(EAGER_COPY_MAX_BYTES + 2 * WASM_PAGE)
                return None

            def touch_mem(api):
                api.sbrk(WASM_PAGE)
                return 0

            rt.upload(FunctionDef("touch_mem", touch_mem, init_fn=init,
                                  memory_limit=4 * EAGER_COPY_MAX_BYTES))
            for _ in range(3):
                assert rt.wait(rt.invoke("touch_mem"), timeout=20) == 0
            warm = rt.hosts["host0"]._warm["touch_mem"]
            mmapped = bool(warm) and warm[0]._mm is not None
            return rt.cold_start_stats(), mmapped
        finally:
            rt.shutdown()

    stats, mmapped = run("always")
    if mmapped:
        assert stats["reclaimed_pages"] >= 1
    stats, _ = run("never")
    assert stats["reclaimed_pages"] == 0
    assert stats["retained_pages"] >= 1


def test_runtime_reset_reports_reclaimed_pages():
    """End-to-end: under ``reclaim="always"`` a warm call that dirties
    private memory on an mmap-CoW Faaslet shows up in the host
    reclaimed_pages metric."""
    import mmap as _mmap
    if not hasattr(_mmap, "MADV_DONTNEED"):
        pytest.skip("madvise unavailable")
    rt = FaasmRuntime(n_hosts=1, reclaim="always")
    try:
        def init(api):
            api.brk(EAGER_COPY_MAX_BYTES + 2 * WASM_PAGE)  # big mmap-able arena
            return None

        def touch_mem(api):
            api.sbrk(WASM_PAGE)                        # dirties a private page
            return 0

        rt.upload(FunctionDef("touch_mem", touch_mem, init_fn=init,
                              memory_limit=4 * EAGER_COPY_MAX_BYTES))
        for _ in range(3):
            assert rt.wait(rt.invoke("touch_mem"), timeout=20) == 0
        stats = rt.cold_start_stats()
        assert stats["resets"] >= 3
        if rt.hosts["host0"]._warm["touch_mem"] and \
                rt.hosts["host0"]._warm["touch_mem"][0]._mm is not None:
            assert stats["reclaimed_pages"] >= 1
    finally:
        rt.shutdown()
