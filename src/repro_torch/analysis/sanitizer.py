"""Runtime data-plane sanitizer for the two-tier state fabric.

Opt-in (``FAASM_SANITIZE=1`` or the ``sanitize`` pytest marker via the
conftest fixture); **zero overhead when disabled**: the lock factories
below return the *raw* ``threading.RLock``/``RWLock`` objects at
construction time, and every hook site in the fabric is guarded by a
module-global ``if _SAN is not None`` — one pointer compare per call in
the disabled steady state, no wrapper frames, no indirection on the lock
fast path.

What it checks (the invariants are documented in ``docs/invariants.md``):

* **Lock order** — instrumented locks maintain a per-thread held-lock set
  and a global lock-*kind* order graph.  Acquiring kind B while holding
  kind A adds edge A→B; if a path B→…→A already exists, the acquisition
  is a deadlock-potential and is reported with **both** acquisition
  stacks (this one and the one that recorded the reverse ordering).
  Nesting two instances of the *same* kind (stripe inside stripe …) is
  reported too: homogeneous instances have no defined order.
* **Stripe ownership** — every ``GlobalTier`` buffer/meta touch asserts
  the calling thread holds that stripe's lock.
* **Torn writes** — per-(tier, key) generation counters are bumped by
  every mutating primitive (``write_from``/``add_inplace``/``apply_wire``
  /``set``…); ``readinto`` snapshots the generation before its memcpy and
  re-checks it after — a concurrent mutation in between is a torn
  zero-copy read.
* **Wire protocol** — per-key version monotonicity on every ``bump``;
  ``prev_version``/``version`` chain contiguity of frames entering the
  retained delta window; residual conservation on every quantised encode
  (``carried + residual ≈ true delta`` within tolerance).
* **Cancellation** — :func:`checkpoint_guard` (installed into
  ``repro_torch.cancellation``) reports any cancellation checkpoint reached
  while a stripe or key lock is held: a cancel raising there would leak
  the lock.

Instrumentation is decided at **lock construction**: call :func:`enable`
before building the tiers/runtime you want checked.  Reports never raise
at the fault site (the fabric keeps running, so one report doesn't
cascade); tests drain them with :func:`take_reports` and fail on any.

Import-light on purpose (stdlib + numpy): ``repro_torch.state``/``repro_torch.core``
import the factories from here at module import time, so this module must
never import them back at top level (``enable`` does, lazily).
"""
from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

__all__ = [
    "Report", "SanLock", "SanRWLock", "disable", "enable", "enabled",
    "make_mutex", "reports", "reset", "take_reports", "wrap_rwlock",
]

_REPORT_CAP = 200                # dedup'd reports kept before dropping
# residual conservation: |carried + residual - delta| <= ATOL + RTOL*max|delta|
RESIDUAL_RTOL = 1e-4
RESIDUAL_ATOL = 1e-5
# lock kinds the cancellation checkpoint must never observe held: a cancel
# exception under one would unwind past its release
_NO_CANCEL_KINDS = ("stripe", "key")


def _stack() -> str:
    """The current acquisition stack, minus the sanitizer's own frames."""
    frames = traceback.format_stack(limit=24)
    return "".join(f for f in frames if "/analysis/sanitizer" not in f)


@dataclass
class Report:
    """One invariant violation (kept, not raised — see module docstring)."""

    check: str                   # lock-order | stripe-ownership | torn-read |
    #                              wire-version | wire-window | wire-residual |
    #                              cancel-under-lock | telemetry-under-lock |
    #                              lock-misuse | attempt-fence
    message: str
    stack: str                   # where the violation was observed
    other_stack: Optional[str] = None   # lock-order: the reverse acquisition
    thread: str = ""

    def __str__(self) -> str:
        out = (f"[{self.check}] {self.message} (thread {self.thread})\n"
               f"--- acquisition stack ---\n{self.stack}")
        if self.other_stack:
            out += f"--- conflicting acquisition stack ---\n{self.other_stack}"
        return out


class _Held:
    """One lock held by a thread (entry in the per-thread held list)."""

    __slots__ = ("lock", "kind", "name", "mode", "count")

    def __init__(self, lock: Any, kind: str, name: str, mode: str):
        self.lock = lock
        self.kind = kind
        self.name = name
        self.mode = mode          # "mutex" | "read" | "write"
        self.count = 1


class _State:
    """All sanitizer bookkeeping; one instance per :func:`enable`."""

    def __init__(self):
        self._mu = threading.RLock()
        self._tls = threading.local()
        self.reports: List[Report] = []
        self._seen: Set[Tuple[str, str]] = set()
        # lock-kind order graph: src kind -> dst kind -> stack that added it
        self._edges: Dict[str, Dict[str, str]] = {}
        self._gens: Dict[Tuple[int, str], int] = {}       # torn-write counters
        self._versions: Dict[Tuple[int, str], int] = {}   # last version seen
        # attempt-fence shadow state: admitted (call, key, seq) effects and
        # the highest superseded epoch per logical call
        self._fence_applied: Set[Tuple[str, str, int]] = set()
        self._fence_dead: Dict[str, int] = {}

    # -- reporting ---------------------------------------------------------

    def report(self, check: str, message: str, *,
               other_stack: Optional[str] = None) -> None:
        key = (check, message)
        with self._mu:
            if key in self._seen or len(self.reports) >= _REPORT_CAP:
                return
            self._seen.add(key)
            self.reports.append(Report(
                check, message, _stack(), other_stack,
                threading.current_thread().name))

    def take_reports(self) -> List[Report]:
        with self._mu:
            out = self.reports
            self.reports = []
            self._seen.clear()
            return out

    def reset(self) -> None:
        """Forget everything (reports, order graph, counters) but stay
        enabled — per-test isolation for the conftest fixture."""
        with self._mu:
            self.reports = []
            self._seen.clear()
            self._edges.clear()
            self._gens.clear()
            self._versions.clear()
            self._fence_applied.clear()
            self._fence_dead.clear()

    # -- held-lock tracking / lock-order graph -----------------------------

    def _held(self) -> List[_Held]:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def pre_acquire(self, lock: Any, kind: str, name: str, mode: str) -> None:
        """Record the acquisition *before* blocking on the raw lock, so a
        deadlock-potential is reported even on the run that would hang."""
        held = self._held()
        for e in reversed(held):
            if e.lock is lock and e.mode == mode:
                e.count += 1         # re-entrant re-acquire: no new edges
                return
        if held:
            self._add_edges(held, lock, kind)
        held.append(_Held(lock, kind, name, mode))

    def cancel_acquire(self, lock: Any, mode: str) -> None:
        """Undo pre_acquire after a failed non-blocking acquire."""
        self.on_release(lock, mode, "?")

    def on_release(self, lock: Any, mode: str, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            e = held[i]
            if e.lock is lock and e.mode == mode:
                e.count -= 1
                if e.count == 0:
                    del held[i]
                return
        self.report("lock-misuse",
                    f"release of {name!r} ({mode}) not held by this thread")

    def _add_edges(self, held: List[_Held], lock: Any, kind: str) -> None:
        stack = _stack()
        with self._mu:
            for src in {e.kind for e in held}:
                if src == kind:
                    inst = next(e for e in held if e.kind == kind)
                    self.report(
                        "lock-order",
                        f"nested acquisition of two {kind!r} locks "
                        f"({inst.name!r} then {getattr(lock, 'name', kind)!r})"
                        " — homogeneous lock instances have no defined order")
                    continue
                dst = self._edges.setdefault(src, {})
                if kind in dst:
                    continue
                reverse = self._find_path(kind, src)
                dst[kind] = stack
                if reverse is not None:
                    self.report(
                        "lock-order",
                        f"lock-order cycle: acquiring {kind!r} while holding "
                        f"{src!r}, but {src!r} is already acquired after "
                        f"{kind!r} elsewhere (deadlock potential)",
                        other_stack=reverse)

    def _find_path(self, src: str, dst: str) -> Optional[str]:
        """Stack of the first edge on an existing src→…→dst path, else
        None.  Caller holds ``_mu``."""
        seen = {src}
        frontier = [(src, None)]
        while frontier:
            node, first = frontier.pop()
            for nxt, stk in self._edges.get(node, {}).items():
                if nxt in seen:
                    continue
                f = first if first is not None else stk
                if nxt == dst:
                    return f
                seen.add(nxt)
                frontier.append((nxt, f))
        return None

    def holds(self, lock: Any, mode: Optional[str] = None) -> bool:
        return any(e.lock is lock and (mode is None or e.mode == mode)
                   for e in self._held())

    # -- stripe ownership --------------------------------------------------

    def stripe_touch(self, lock: Any, key: str) -> None:
        """Assert the calling thread holds ``lock`` (the stripe mutex) for
        this buffer/meta touch.  Uninstrumented stripes (tier built before
        :func:`enable`) are skipped."""
        if not isinstance(lock, SanLock):
            return
        if not self.holds(lock):
            self.report(
                "stripe-ownership",
                f"GlobalTier buffer/meta touch on {key!r} without the "
                f"stripe lock held")

    def assert_write_held(self, lock: Any, what: str) -> None:
        """Assert the calling thread write-holds ``lock`` (a replica
        RW lock) — for ``*_locked`` helpers whose contract is 'caller
        holds the write lock'."""
        if not isinstance(lock, SanRWLock):
            return
        if not self.holds(lock, "write"):
            self.report("lock-misuse",
                        f"{what} entered without the replica write lock held")

    # -- torn-write detection (generation counters) ------------------------

    def gen_bump(self, owner: Any, key: str) -> None:
        k = (id(owner), key)
        with self._mu:
            self._gens[k] = self._gens.get(k, 0) + 1

    def read_begin(self, owner: Any, key: str) -> int:
        with self._mu:
            return self._gens.get((id(owner), key), 0)

    def read_end(self, owner: Any, key: str, token: int) -> None:
        with self._mu:
            now = self._gens.get((id(owner), key), 0)
        if now != token:
            self.report(
                "torn-read",
                f"zero-copy read of {key!r} overlapped {now - token} "
                f"concurrent mutation(s) — torn view")

    # -- wire-protocol checks ----------------------------------------------

    def version_bumped(self, owner: Any, key: str, old: int, new: int) -> None:
        if new <= old:
            self.report("wire-version",
                        f"non-monotonic write version on {key!r}: "
                        f"{old} -> {new}")
        with self._mu:
            self._versions[(id(owner), key)] = new

    def frame_applied(self, owner: Any, key: str, frame: Any) -> None:
        if frame.version <= frame.prev_version:
            self.report(
                "wire-version",
                f"frame on {key!r} stamps a non-advancing transition "
                f"{frame.prev_version} -> {frame.version}")

    def frame_recorded(self, owner: Any, key: str, frame: Any,
                       tail_version: Optional[int], floor: int) -> None:
        """A frame entering the retained delta window must chain onto the
        window tail (or, for an empty window, start at the floor)."""
        if tail_version is not None:
            if frame.prev_version != tail_version:
                self.report(
                    "wire-window",
                    f"retained window gap on {key!r}: frame "
                    f"{frame.prev_version}->{frame.version} appended after "
                    f"tail version {tail_version}")
        elif frame.prev_version < floor:
            self.report(
                "wire-window",
                f"retained window on {key!r} starts below its floor: frame "
                f"{frame.prev_version}->{frame.version}, floor {floor}")

    def check_residual(self, delta, carried, residual) -> None:
        """Residual conservation: what the wire carried plus the
        error-feedback residual must reconstruct the true delta."""
        delta = np.asarray(delta, np.float32).reshape(-1)
        carried = np.asarray(carried, np.float32).reshape(-1)[:delta.size]
        if residual is None:
            res = np.zeros(delta.size, np.float32)
        else:
            res = np.asarray(residual, np.float32).reshape(-1)[:delta.size]
        if not delta.size:
            return
        err = float(np.max(np.abs(carried + res - delta)))
        tol = RESIDUAL_ATOL + RESIDUAL_RTOL * float(np.max(np.abs(delta)))
        if err > tol:
            self.report(
                "wire-residual",
                f"residual conservation violated: max|carried + residual "
                f"- delta| = {err:.3g} > {tol:.3g}")

    # -- attempt fences ----------------------------------------------------

    def fence_superseded(self, call_id: str, epoch: int) -> None:
        """The runtime declared every epoch of ``call_id`` up to ``epoch``
        dead (requeue past a lost host, retry past a failed dispatch)."""
        with self._mu:
            if epoch > self._fence_dead.get(call_id, 0):
                self._fence_dead[call_id] = epoch

    def fence_write(self, call_id: str, epoch: int, key: str, seq: int,
                    admitted: bool) -> None:
        """Exactly-once shadow check on every fenced delta-push decision:
        the tier must never admit the same ``(call, key, seq)`` effect twice
        (a re-executed attempt double-applying its delta) nor any write
        from an epoch the runtime already superseded (a zombie attempt
        mutating state after its requeue)."""
        if not admitted:
            return
        with self._mu:
            dup = (call_id, key, seq) in self._fence_applied
            dead = epoch <= self._fence_dead.get(call_id, 0)
            self._fence_applied.add((call_id, key, seq))
        if dup:
            self.report(
                "attempt-fence",
                f"delta push #{seq} on {key!r} by call {call_id} admitted "
                f"twice (epoch {epoch}) — re-execution double-applied state")
        if dead:
            self.report(
                "attempt-fence",
                f"delta push on {key!r} admitted from superseded epoch "
                f"{epoch} of call {call_id} — zombie attempt wrote state")

    # -- cancellation ------------------------------------------------------

    def checkpoint_guard(self) -> None:
        held = [e for e in self._held() if e.kind in _NO_CANCEL_KINDS]
        if held:
            names = ", ".join(f"{e.kind}:{e.name}" for e in held)
            self.report(
                "cancel-under-lock",
                f"cancellation checkpoint reached while holding {names} — "
                f"a cancel raising here would leak the lock")

    # -- telemetry ---------------------------------------------------------

    def telemetry_drain_guard(self) -> None:
        """Span ring-buffer *writes* are lock-free and legal anywhere, but
        the collector drain walks every thread's ring and the shared
        collected list — stalling it under a stripe/key lock couples the
        observability plane into the fabric's hot locks (and an export
        callback touching state would deadlock).  Installed into
        ``repro_torch.telemetry.spans._SAN_GUARD``; ``Tracer.drain`` calls it."""
        held = [e for e in self._held() if e.kind in _NO_CANCEL_KINDS]
        if held:
            names = ", ".join(f"{e.kind}:{e.name}" for e in held)
            self.report(
                "telemetry-under-lock",
                f"telemetry collector drain reached while holding {names} — "
                f"drain/export must run outside fabric locks")


class SanLock:
    """Instrumented re-entrant mutex (drop-in for ``threading.RLock``)."""

    __slots__ = ("_raw", "kind", "name", "_san")

    def __init__(self, kind: str, name: Optional[str], san: _State):
        self._raw = threading.RLock()
        self.kind = kind
        self.name = name or kind
        self._san = san

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._san.pre_acquire(self, self.kind, self.name, "mutex")
        ok = self._raw.acquire(blocking, timeout)
        if not ok:
            self._san.cancel_acquire(self, "mutex")
        return ok

    def release(self) -> None:
        self._san.on_release(self, "mutex", self.name)
        self._raw.release()

    def __enter__(self) -> "SanLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class SanRWLock:
    """Instrumented wrapper around a ``repro_torch.state.kv.RWLock``."""

    __slots__ = ("_raw", "kind", "name", "_san")

    def __init__(self, raw: Any, kind: str, name: Optional[str], san: _State):
        self._raw = raw
        self.kind = kind
        self.name = name or kind
        self._san = san

    def acquire_read(self) -> None:
        self._san.pre_acquire(self, self.kind, self.name, "read")
        self._raw.acquire_read()

    def release_read(self) -> None:
        self._san.on_release(self, "read", self.name)
        self._raw.release_read()

    def acquire_write(self) -> None:
        self._san.pre_acquire(self, self.kind, self.name, "write")
        self._raw.acquire_write()

    def release_write(self) -> None:
        self._san.on_release(self, "write", self.name)
        self._raw.release_write()


# -- module API ------------------------------------------------------------

_active: Optional[_State] = None


def enabled() -> bool:
    return _active is not None


def make_mutex(kind: str, name: Optional[str] = None):
    """A mutex of the given order ``kind``.  Disabled: the raw
    ``threading.RLock`` — the sanitizer compiles out of the lock path."""
    if _active is None:
        return threading.RLock()
    return SanLock(kind, name, _active)


def wrap_rwlock(lock, kind: str, name: Optional[str] = None):
    """Wrap an ``RWLock`` for order/ownership tracking.  Disabled: returns
    ``lock`` unchanged."""
    if _active is None:
        return lock
    return SanRWLock(lock, kind, name, _active)


def _install(st: Optional[_State]) -> None:
    """(Un)install the hook state into the fabric modules.  Imports live
    here, not at module top level, to keep the factory import acyclic."""
    from repro_torch import cancellation
    from repro_torch.state import kv, local, wire
    from repro_torch.telemetry import spans
    kv._SAN = st
    local._SAN = st
    wire._SAN = st
    cancellation._SAN_GUARD = st.checkpoint_guard if st is not None else None
    spans._SAN_GUARD = (st.telemetry_drain_guard
                        if st is not None else None)


def enable() -> _State:
    """Turn the sanitizer on (idempotent).  Only locks constructed *after*
    this call are instrumented — enable before building tiers/runtimes."""
    global _active
    if _active is None:
        _active = _State()
        _install(_active)
    return _active


def disable() -> None:
    global _active
    if _active is None:
        return
    _active = None
    _install(None)


def reset() -> None:
    if _active is not None:
        _active.reset()


def reports() -> List[Report]:
    return list(_active.reports) if _active is not None else []


def take_reports() -> List[Report]:
    return _active.take_reports() if _active is not None else []
