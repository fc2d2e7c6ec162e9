"""Overload control plane: deadlines, admission control, retry budgets,
circuit breakers, and the backpressured broadcast primitives.

The runtime's defence against overload is assembled from five small,
independently testable mechanisms, all defined here and threaded through
``repro_torch.core`` / ``repro_torch.state``:

* :class:`Deadline` — an absolute expiry on the telemetry clock, stamped on
  a :class:`~repro_torch.core.runtime.Call` at ``invoke(deadline=...)`` and
  inherited by chained children (same absolute expiry ⇒ children get exactly
  the remaining budget).  Enforced at admission (already-expired work settles
  :data:`DEADLINE_RC` without dispatching), at dequeue (remaining budget
  below the function's floor ⇒ shed before wasting an executor slot), and
  mid-execution through the ``cancellation.checkpoint`` plane (behaves like
  a cooperative cancel; the PR 7 attempt fence keeps the interrupted
  attempt's state effects exactly-once).
* bounded host queues + :class:`AdmissionPolicy` — ``Host.submit`` refuses
  work beyond ``capacity + max_queue_depth`` by raising :class:`QueueFull`;
  the dispatcher then spills down the rendezvous ranking to a peer with
  room, or settles the call fast with :data:`SHED_RC`.
* :class:`RetryBudget` — a token bucket refilled as a *fraction of
  successes*, so re-execution after host loss can never amplify a fault
  storm into a retry storm: once the bucket is dry, lost calls settle failed
  immediately instead of backoff-looping.
* :class:`CircuitBreaker` — per-host closed→open→half-open breaker fed by
  call outcomes; the scheduler consults it alongside ``has_capacity()`` so
  a persistently failing host stops receiving traffic until a half-open
  probe succeeds.
* :class:`CoalescingQueue` — the bounded per-subscriber frame queue behind
  ``GlobalTier.broadcast``'s pump threads.  Same-key frames collapse to the
  newest (the skipped predecessor becomes a version gap the subscriber's
  ``prev_version`` check already tolerates — the next delta pull repairs
  it); overflow drops the subscriber back to pull-repair entirely.  Either
  way the *pusher* never blocks on a slow subscriber.

Disarmed cost discipline (same contract as ``faults``/``telemetry``, asserted
by ``scripts/check_jax_pin.py``): a runtime built without an
:class:`OverloadPolicy` carries ``overload is None`` / ``_retry_budget is
None`` / ``_breakers is None``, and a call without a deadline carries
``deadline is None`` — every hook site in the hot path reduces to one
pointer compare.  There is no process-global state in this module.

faasmlint's ``bounded-queue`` rule enforces that data-plane modules
(``core/``, ``state/``) never construct a raw unbounded ``queue.Queue``;
:func:`bounded_queue` is the blessed factory (depth explicit, shedding
semantics documented at the construction site).
"""
from __future__ import annotations

import queue
import threading
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from repro_torch.telemetry import clock as tclock

# Return codes surfaced to waiters.  SHED_RC predates this module (the
# degraded-serving path in launch/serve.py); it is canonical here now and
# re-exported there.  Both are negative so they can never collide with a
# function's own nonzero failure codes.
SHED_RC = -2          # refused at admission: bounded queue full, no peer had room
DEADLINE_RC = -3      # end-to-end deadline expired (admission, dequeue or mid-exec)

DEFAULT_NET_QUEUE_DEPTH = 1024   # virtual-socket mailboxes (runtime._net)
DEFAULT_BCAST_DEPTH = 8          # per-subscriber broadcast frames in flight


class QueueFull(RuntimeError):
    """A host's bounded admission queue refused a call.  The dispatcher
    catches this and spills to a peer or sheds with :data:`SHED_RC` —
    user code never sees it."""


def bounded_queue(maxsize: int = DEFAULT_NET_QUEUE_DEPTH) -> "queue.Queue":
    """The lint-blessed queue constructor for data-plane modules.

    Raw ``queue.Queue()`` (unbounded) in ``core/`` or ``state/`` is a
    faasmlint ``bounded-queue`` violation: an unbounded queue converts
    overload into unbounded memory growth and unbounded latency, invisibly.
    Constructing through this factory makes the depth an explicit, reviewed
    decision."""
    if maxsize <= 0:
        raise ValueError("bounded_queue needs a positive depth; use "
                         "queue.Queue() with a lint suppression if you "
                         "really mean unbounded")
    return queue.Queue(maxsize=maxsize)


# --------------------------------------------------------------------- deadlines

@dataclass(frozen=True)
class Deadline:
    """An absolute end-to-end expiry on the telemetry clock.

    Children of a deadlined call inherit the *same* object: the expiry is
    absolute, so an inherited deadline is exactly the parent's remaining
    budget — no per-hop re-derivation, no budget inflation across a chain.
    """

    expires_at: float          # absolute, repro_torch.telemetry.clock base
    budget_s: float            # original budget (introspection only)

    @classmethod
    def after(cls, budget_s: float) -> "Deadline":
        """Deadline ``budget_s`` seconds from now."""
        budget_s = float(budget_s)
        if budget_s <= 0.0:
            raise ValueError("deadline budget must be positive")
        return cls(expires_at=tclock.now() + budget_s, budget_s=budget_s)

    def remaining(self) -> float:
        """Seconds of budget left (negative once expired)."""
        return self.expires_at - tclock.now()

    def expired(self) -> bool:
        return tclock.now() >= self.expires_at


# --------------------------------------------------------------- admission policy

@dataclass
class AdmissionPolicy:
    """What to do with a call that hits a full host queue.

    ``spill=True`` (default): try peers down the rendezvous ranking first,
    shed only when nobody has room.  ``spill=False``: shed immediately —
    the latency-strict policy (a spilled call pays another placement and
    possibly a cold start).  Subclass and override :meth:`on_full` for
    anything richer (e.g. priority classes)."""

    spill: bool = True

    def on_full(self, call) -> str:
        """Return ``"spill"`` or ``"shed"`` for a call refused by its
        target host's bounded queue."""
        return "spill" if self.spill else "shed"


# ------------------------------------------------------------------ retry budget

class RetryBudget:
    """Token-bucket retry budget: retries can never exceed ~``ratio`` of
    successful traffic.

    Every successful call refills ``ratio`` tokens (capped at ``burst``);
    every re-execution spends one whole token.  A fault storm that kills
    more work than the cluster completes drains the bucket, after which
    lost calls settle failed immediately instead of amplifying the storm
    with backoff-retry loops.  All methods are thread-safe."""

    def __init__(self, ratio: float = 0.1, burst: float = 20.0,
                 initial: Optional[float] = None):
        if ratio < 0.0 or burst <= 0.0:
            raise ValueError("ratio must be >= 0 and burst > 0")
        self.ratio = float(ratio)
        self.burst = float(burst)
        self._tokens = float(burst if initial is None else initial)
        self._mu = threading.Lock()
        self.spent_total = 0
        self.denied_total = 0

    def try_spend(self) -> bool:
        """Take one token if available.  False ⇒ budget exhausted: the
        caller must settle the call failed, not retry."""
        with self._mu:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.spent_total += 1
                return True
            self.denied_total += 1
            return False

    def on_success(self) -> None:
        """Refill from a completed call (``ratio`` tokens, capped)."""
        with self._mu:
            self._tokens = min(self.burst, self._tokens + self.ratio)

    def fill_ratio(self) -> float:
        """Bucket fullness in [0, 1] (for the metrics gauge)."""
        with self._mu:
            return self._tokens / self.burst


# --------------------------------------------------------------- circuit breaker

class CircuitBreaker:
    """Per-host breaker: closed → open on failure-rate-over-window,
    half-open probes before readmitting.

    ``record(ok)`` feeds call outcomes into a sliding window of the last
    ``window`` calls; once at least ``min_volume`` outcomes are in and the
    failure fraction reaches ``failure_ratio``, the breaker opens for
    ``reset_timeout_s``.  While open, :meth:`allow` refuses placement.
    After the timeout it goes half-open and admits up to ``probes``
    in-flight probe calls: one probe success closes it (window reset), one
    probe failure re-opens it for another full timeout."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, window: int = 16, failure_ratio: float = 0.5,
                 min_volume: int = 4, reset_timeout_s: float = 0.25,
                 probes: int = 1):
        assert window > 0 and 0.0 < failure_ratio <= 1.0
        assert min_volume >= 1 and reset_timeout_s > 0.0 and probes >= 1
        self.window = window
        self.failure_ratio = failure_ratio
        self.min_volume = min_volume
        self.reset_timeout_s = reset_timeout_s
        self.probes = probes
        self._mu = threading.Lock()
        self._outcomes: deque = deque(maxlen=window)
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._probes_inflight = 0
        self.opened_total = 0

    @property
    def state(self) -> str:
        with self._mu:
            return self._state

    def _trip_locked(self) -> None:
        self._state = self.OPEN
        self._opened_at = tclock.now()
        self._probes_inflight = 0
        self._outcomes.clear()
        self.opened_total += 1

    def trip(self) -> None:
        """Force open (e.g. the host was declared dead outright)."""
        with self._mu:
            self._trip_locked()

    def allow(self) -> bool:
        """May the scheduler place a call on this host right now?
        A True answer in half-open state claims one probe slot; report the
        probe's outcome through :meth:`record`."""
        with self._mu:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if tclock.now() - self._opened_at < self.reset_timeout_s:
                    return False
                self._state = self.HALF_OPEN
                self._probes_inflight = 0
            # half-open: admit up to `probes` concurrent probe calls
            if self._probes_inflight < self.probes:
                self._probes_inflight += 1
                return True
            return False

    def record(self, ok: bool) -> None:
        """Feed one call outcome (True = success)."""
        with self._mu:
            if self._state == self.HALF_OPEN:
                self._probes_inflight = max(0, self._probes_inflight - 1)
                if ok:
                    self._state = self.CLOSED
                    self._outcomes.clear()
                else:
                    self._trip_locked()
                return
            if self._state == self.OPEN:
                return                    # zombie outcome from before the trip
            self._outcomes.append(ok)
            n = len(self._outcomes)
            if n >= self.min_volume:
                failures = sum(1 for o in self._outcomes if not o)
                if failures / n >= self.failure_ratio:
                    self._trip_locked()


# ------------------------------------------------------ backpressured broadcast

class CoalescingQueue:
    """Bounded per-subscriber frame queue with same-key coalescing.

    The broadcast pump drains this on its own thread, so the *pusher* only
    ever pays a dict insert under a short lock.  Three outcomes per put:

    * ``"queued"``    — new key, depth available.
    * ``"coalesced"`` — a frame for this key was already waiting and is
      replaced by the newer one (in place, preserving arrival order).  The
      replaced frame becomes a version gap at the subscriber, which its
      ``prev_version`` check skips and the next delta pull repairs.
    * ``"overflow"``  — at depth with all-distinct keys: the caller should
      drop this subscriber back to pull-repair entirely.

    ``drain()`` hands the pump everything queued, oldest first."""

    def __init__(self, depth: int = DEFAULT_BCAST_DEPTH):
        assert depth >= 1
        self.depth = depth
        self._mu = threading.Lock()
        self._items: "OrderedDict[str, object]" = OrderedDict()

    def put(self, key: str, item) -> str:
        with self._mu:
            if key in self._items:
                self._items[key] = item          # collapse to newest
                return "coalesced"
            if len(self._items) >= self.depth:
                return "overflow"
            self._items[key] = item
            return "queued"

    def drain(self) -> List[Tuple[str, object]]:
        with self._mu:
            items = list(self._items.items())
            self._items.clear()
        return items

    def __len__(self) -> int:
        with self._mu:
            return len(self._items)


# ----------------------------------------------------------------- policy bundle

@dataclass
class OverloadPolicy:
    """Everything the runtime needs to defend itself, in one bundle.

    ``FaasmRuntime(overload=OverloadPolicy(...))`` arms the plane; the
    default (no policy) leaves every hook disarmed at one pointer compare.

    * ``max_queue_depth`` — per-host bound on calls queued beyond running
      capacity; ``None`` keeps today's unbounded behaviour.
    * ``default_deadline_s`` — stamped on any invoke that doesn't carry its
      own deadline (chained children still inherit their parent's).
    * ``deadline_floor_s`` — dequeue shed floor when the function doesn't
      declare its own ``FunctionDef.deadline_floor_s``.
    * ``retry_budget`` / ``breaker`` — see :class:`RetryBudget` /
      :class:`CircuitBreaker`; ``breaker`` is a zero-arg factory called
      once per host.
    * ``admission`` — full-queue decision, see :class:`AdmissionPolicy`.
    """

    max_queue_depth: Optional[int] = None
    default_deadline_s: Optional[float] = None
    deadline_floor_s: float = 0.0
    retry_budget: Optional[RetryBudget] = None
    breaker: Optional[Callable[[], CircuitBreaker]] = None
    admission: AdmissionPolicy = field(default_factory=AdmissionPolicy)
