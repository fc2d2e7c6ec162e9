"""Per-call span tracing: lock-free per-thread rings drained by a collector.

Opt-in and **zero overhead when disabled**, following the sanitizer/faults
discipline: every hook site in the runtime and state fabric is guarded by
a module-global ``if _TEL is not None`` — one pointer compare per event in
the disarmed steady state, no wrapper frames, zero ring-buffer writes
(``scripts/check_jax_pin.py`` asserts the compile-out).

Architecture
------------

* **Writers** record :class:`Span` objects into a per-thread ring buffer
  (:class:`_Ring`).  A ring has exactly one writer — its owning thread —
  so writes take no lock (the GIL serialises the list ops); a full ring
  drops the oldest span and counts it in ``dropped``.  Ring writes are
  therefore safe anywhere, **including under stripe/key locks** (the hot
  wire-frame sites run inside them).
* **The collector** (:meth:`Tracer.drain`) swaps every ring's buffer out
  and accumulates the spans centrally.  Draining walks shared state and
  is *not* safe under fabric locks — the sanitizer's
  ``telemetry-under-lock`` check (installed here as ``_SAN_GUARD``)
  reports any drain/export reached while a stripe or key lock is held.

Trace context
-------------

``Host._run`` installs the executing attempt's identity —
``(call_id, fence_id, fence_epoch, host)`` — as thread-local context;
spans recorded on that thread (wire frames pushed from inside the user
function, fault-point hits, kernel work) inherit it.  Because a
speculative twin, a retry after host loss, and a zombie attempt all carry
the **primary's** ``fence_id`` with distinct epochs, their spans land as
siblings of one logical call in the export: group by ``fence``, order by
``epoch``.

Import-light on purpose (stdlib only): ``repro_torch.core``/``repro_torch.state``
hold a ``_TEL`` slot this module installs into; it must never import
them back at top level (:func:`_install` does, lazily).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.telemetry import clock

__all__ = [
    "Span", "Tracer", "disable", "enable", "enabled", "tracer",
]

_RING_CAPACITY = 8192            # spans per thread before drop-oldest
_COLLECTED_CAP = 1 << 20         # collector hard cap (runaway guard)

# Sanitizer hook: repro_torch.analysis.sanitizer._install points this at its
# drain guard; Tracer.drain calls it so a collector drain under a
# stripe/key lock is reported.  None when the sanitizer is disabled.
_SAN_GUARD = None


class Span:
    """One recorded interval (or instant, ``t0 == t1``) on one thread."""

    __slots__ = ("name", "cat", "t0", "t1", "call", "fence", "epoch",
                 "host", "thread", "tags")

    def __init__(self, name: str, cat: str, t0: float, t1: float,
                 call: Optional[int], fence: Optional[str],
                 epoch: Optional[int], host: Optional[str],
                 thread: str, tags: Optional[Dict[str, Any]]):
        self.name = name
        self.cat = cat              # call | wire | fault | serve | train
        self.t0 = t0                # clock.now() seconds
        self.t1 = t1
        self.call = call            # physical attempt (Call.id)
        self.fence = fence          # logical call (Call.fence_id)
        self.epoch = epoch          # attempt epoch under that fence
        self.host = host
        self.thread = thread
        self.tags = tags

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def __repr__(self) -> str:   # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, {self.dur * 1e3:.3f}ms, "
                f"call={self.call}, fence={self.fence}, epoch={self.epoch}, "
                f"host={self.host}, tags={self.tags})")


class _Ring:
    """Fixed-capacity single-writer ring.  The owning thread appends;
    the collector swaps the buffer out wholesale.  No locks: one writer
    per ring plus the GIL makes the append/swap races benign (a span
    appended concurrently with a swap lands in the next drain)."""

    __slots__ = ("buf", "head", "dropped")

    def __init__(self):
        self.buf: List[Span] = []
        self.head = 0
        self.dropped = 0

    def push(self, span: Span) -> None:
        buf = self.buf
        if len(buf) < _RING_CAPACITY:
            buf.append(span)
        else:
            buf[self.head] = span
            self.head = (self.head + 1) % _RING_CAPACITY
            self.dropped += 1

    def swap(self) -> List[Span]:
        out, self.buf, self.head = self.buf, [], 0
        # restore drain order for a wrapped ring: oldest surviving first
        if self.dropped and out:
            h = self.dropped % _RING_CAPACITY
            out = out[h:] + out[:h]
        return out


class _Ctx:
    __slots__ = ("call", "fence", "epoch", "host")

    def __init__(self):
        self.call: Optional[int] = None
        self.fence: Optional[str] = None
        self.epoch: Optional[int] = None
        self.host: Optional[str] = None


class Tracer:
    """The armed tracing state: ring registry + collector + counters."""

    def __init__(self):
        self._mu = threading.Lock()          # ring registry + collected list
        self._tls = threading.local()
        self._rings: Dict[int, Tuple[str, _Ring]] = {}
        self._collected: List[Span] = []
        self.writes = 0                      # total ring-buffer writes ever
        self.dropped = 0                     # spans lost to full rings

    # -- clock (re-exported so hook sites hold one object) ------------------

    @staticmethod
    def now() -> float:
        return clock.now()

    @staticmethod
    def now_ns() -> int:
        return clock.now_ns()

    # -- trace context -------------------------------------------------------

    def set_ctx(self, call: int, fence: str, epoch: int, host: str) -> None:
        ctx = getattr(self._tls, "ctx", None)
        if ctx is None:
            ctx = self._tls.ctx = _Ctx()
        ctx.call, ctx.fence, ctx.epoch, ctx.host = call, fence, epoch, host

    def clear_ctx(self) -> None:
        ctx = getattr(self._tls, "ctx", None)
        if ctx is not None:
            ctx.call = ctx.fence = ctx.epoch = ctx.host = None

    def _ctx(self) -> Optional[_Ctx]:
        return getattr(self._tls, "ctx", None)

    # -- recording (any thread, any lock context) ---------------------------

    def _ring(self) -> _Ring:
        r = getattr(self._tls, "ring", None)
        if r is None:
            r = self._tls.ring = _Ring()
            t = threading.current_thread()
            with self._mu:
                self._rings[t.ident or id(t)] = (t.name, r)
        return r

    def record(self, name: str, cat: str, t0: float, t1: float, *,
               call: Optional[int] = None, fence: Optional[str] = None,
               epoch: Optional[int] = None, host: Optional[str] = None,
               **tags: Any) -> None:
        """Record a finished interval.  Identity fields left ``None`` are
        filled from the thread's trace context (if any)."""
        ctx = self._ctx()
        if ctx is not None:
            if call is None:
                call = ctx.call
            if fence is None:
                fence = ctx.fence
            if epoch is None:
                epoch = ctx.epoch
            if host is None:
                host = ctx.host
        self.writes += 1
        self._ring().push(Span(
            name, cat, t0, t1, call, fence, epoch, host,
            threading.current_thread().name, tags or None))

    def instant(self, name: str, cat: str, **tags: Any) -> None:
        t = clock.now()
        self.record(name, cat, t, t, **tags)

    # -- collector (never call under a stripe/key lock) ---------------------

    def drain(self) -> List[Span]:
        """Swap every ring out and absorb the spans centrally.  Returns
        the newly drained spans (the full set is :meth:`spans`)."""
        guard = _SAN_GUARD
        if guard is not None:
            guard()
        with self._mu:
            rings = list(self._rings.values())
        fresh: List[Span] = []
        for _name, ring in rings:
            fresh.extend(ring.swap())
            self.dropped += ring.dropped
            ring.dropped = 0
        fresh.sort(key=lambda s: s.t0)
        with self._mu:
            room = _COLLECTED_CAP - len(self._collected)
            self._collected.extend(fresh[:max(room, 0)])
        return fresh

    def spans(self) -> List[Span]:
        """Everything collected so far (drains first)."""
        self.drain()
        with self._mu:
            return list(self._collected)

    def take(self) -> List[Span]:
        """Drain and return all collected spans, clearing the collector."""
        self.drain()
        with self._mu:
            out, self._collected = self._collected, []
            return out


# -- module API --------------------------------------------------------------

_active: Optional[Tracer] = None


def enabled() -> bool:
    return _active is not None


def tracer() -> Optional[Tracer]:
    return _active


def _install(t: Optional[Tracer]) -> None:
    """(Un)install the tracer into the instrumented modules' ``_TEL``
    slots.  Imports live here, lazily, to keep this module import-light."""
    from repro_torch import faults
    from repro_torch.core import runtime
    from repro_torch.state import kv, local
    runtime._TEL = t
    kv._TEL = t
    local._TEL = t
    faults._TEL = t


def enable() -> Tracer:
    """Arm tracing (idempotent).  Hook sites go live immediately; spans
    from calls already in flight pick up mid-lifecycle."""
    global _active
    if _active is None:
        _active = Tracer()
        _install(_active)
    return _active


def disable() -> None:
    global _active
    if _active is None:
        return
    _active = None
    _install(None)
