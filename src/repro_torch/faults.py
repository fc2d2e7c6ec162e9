"""Deterministic fault injection for the runtime and state fabric.

Mirrors the sanitizer's zero-overhead discipline: the module global
``_PLAN`` is ``None`` except while a :class:`FaultPlan` is armed, and every
injection site is a single call to :func:`point`, whose disarmed fast path
is one pointer compare.  Sites never branch on the global themselves —
faasmlint's ``fault-point`` rule flags any access to the plan internals
outside this file, so the full catalogue of injection sites is exactly the
set of ``faults.point(...)`` calls in the tree.

Fault points (see ``docs/fault_model.md`` for the catalogue and the
recovery contract each one exercises):

==================== ======== ==========================================
point                action   site
==================== ======== ==========================================
host-crash-pre-push  raise    ``LocalTier.push_delta`` entry, before any
                              global-tier effect (``HostCrash``)
host-crash-post-push raise    ``LocalTier.push_delta`` exit, after the
                              delta landed globally (``HostCrash``)
wire-frame-drop      drop     ``LocalTier._deliver`` — the broadcast
                              frame is lost before the subscriber
wire-frame-delay     delay    ``LocalTier._deliver`` — the frame arrives
                              late (races the next push)
subscriber-raise     raise    ``LocalTier._deliver`` — the subscriber
                              callback blows up mid-broadcast
codec-error          raise    ``Int8Codec.encode`` — the quantised
                              encode fails mid-push
slow-host            delay    ``Host._run`` dispatch and
                              ``Faaslet.reset_from_base`` — the host
                              straggles, provoking speculation
tier-pull-stall      delay    ``LocalTier.pull`` entry — a refresh
                              stalls while pushers race ahead
queue-flood          drop     ``Host.submit`` — the bounded admission
                              queue reports full, forcing the overload
                              spill/shed path (``repro_torch.overload``)
subscriber-stall     delay    ``LocalTier._deliver`` — the subscriber
                              stalls applying a broadcast frame; the
                              pump absorbs it, the pusher must not block
deadline-clock-skew  delay    ``Host._run`` dequeue deadline check — the
                              clock reads late, evaporating the call's
                              remaining budget before the floor check
==================== ======== ==========================================

A plan is a seeded schedule: each rule names a point, an Nth-hit trigger,
an optional repeat count and per-call / per-key / per-host filters.  Arm
with :func:`arm` (or the :func:`armed` context manager), disarm with
:func:`disarm`.  ``FaultPlan.random(seed)`` builds a randomized-but-
reproducible schedule for the chaos matrix.
"""
from __future__ import annotations

import contextlib
import random
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

FAULT_POINTS = frozenset({
    "host-crash-pre-push",
    "host-crash-post-push",
    "wire-frame-drop",
    "wire-frame-delay",
    "subscriber-raise",
    "codec-error",
    "slow-host",
    "tier-pull-stall",
    "queue-flood",
    "subscriber-stall",
    "deadline-clock-skew",
})

# Action class per point: raising points throw, delaying points sleep and
# let the site continue, dropping points return True so the site discards
# the in-flight artefact (or, for queue-flood, treats the admission queue
# as full).
_DELAYING = frozenset({"wire-frame-delay", "slow-host", "tier-pull-stall",
                       "subscriber-stall", "deadline-clock-skew"})
_DROPPING = frozenset({"wire-frame-drop", "queue-flood"})
_CRASHING = frozenset({"host-crash-pre-push", "host-crash-post-push"})


class FaultInjected(RuntimeError):
    """An armed fault fired at a raising point."""


class HostCrash(FaultInjected):
    """Injected host death: the runtime fails the host and requeues its
    in-flight calls instead of settling the victim call as failed."""


@dataclass
class FaultRule:
    """One trigger in a plan: fire on the nth..nth+times-1 matching hits."""
    point: str
    nth: int = 1
    times: int = 1
    call: Optional[str] = None
    key: Optional[str] = None
    host: Optional[str] = None
    delay_s: float = 0.01
    matched: int = 0
    fired: int = 0

    def matches(self, call, key, host):
        return ((self.call is None or self.call == call)
                and (self.key is None or self.key == key)
                and (self.host is None or self.host == host))


class FaultPlan:
    """A seeded, deterministic fault schedule."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rules: List[FaultRule] = []
        self.log: List[Tuple[str, Optional[str], Optional[str],
                             Optional[str]]] = []
        self._hits = {}
        self._mu = threading.Lock()

    def add(self, point: str, *, nth: int = 1, times: int = 1,
            call: Optional[str] = None, key: Optional[str] = None,
            host: Optional[str] = None, delay_s: float = 0.01) -> "FaultPlan":
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r}; "
                             f"known: {sorted(FAULT_POINTS)}")
        if nth < 1 or times < 1:
            raise ValueError("nth and times are 1-based and positive")
        self.rules.append(FaultRule(point, nth=nth, times=times, call=call,
                                    key=key, host=host, delay_s=delay_s))
        return self

    @classmethod
    def random(cls, seed: int, *, n_rules: int = 4, max_nth: int = 12,
               points: Tuple[str, ...] = ("wire-frame-drop",
                                          "wire-frame-delay",
                                          "subscriber-raise",
                                          "codec-error",
                                          "tier-pull-stall")) -> "FaultPlan":
        """Randomized-but-reproducible schedule over the recoverable
        points (host crashes are driven explicitly by the chaos killer)."""
        rng = random.Random(seed)
        plan = cls(seed)
        for _ in range(n_rules):
            plan.add(rng.choice(points), nth=rng.randint(1, max_nth),
                     times=rng.randint(1, 2),
                     delay_s=rng.uniform(0.0005, 0.008))
        return plan

    def hits(self, name: str) -> int:
        with self._mu:
            return self._hits.get(name, 0)

    def fired(self, name: Optional[str] = None) -> int:
        with self._mu:
            if name is None:
                return len(self.log)
            return sum(1 for p, _c, _k, _h in self.log if p == name)

    def _fire(self, name, call, key, host):
        if name not in FAULT_POINTS:
            raise ValueError(f"unregistered fault point {name!r}")
        action, delay = None, 0.0
        with self._mu:
            self._hits[name] = self._hits.get(name, 0) + 1
            for r in self.rules:
                if r.point != name or not r.matches(call, key, host):
                    continue
                r.matched += 1
                if r.nth <= r.matched < r.nth + r.times:
                    r.fired += 1
                    self.log.append((name, call, key, host))
                    if name in _DELAYING:
                        action, delay = "delay", r.delay_s
                    elif name in _DROPPING:
                        action = "drop"
                    else:
                        action = "raise"
                    break
        tel = _TEL
        if tel is not None and action is not None:
            tel.instant(f"fault.{name}", "fault", point=name, action=action,
                        key=key, target_host=host)
        if action == "delay":
            time.sleep(delay)
            return False
        if action == "drop":
            return True
        if action == "raise":
            exc = HostCrash if name in _CRASHING else FaultInjected
            ctx = ", ".join(f"{k}={v}" for k, v in
                            (("call", call), ("key", key), ("host", host))
                            if v is not None)
            raise exc(f"injected fault: {name}" + (f" ({ctx})" if ctx else ""))
        return False


# The one-compare disarmed fast path, same shape as the sanitizer's _SAN
# module globals.  Nothing outside this module may read it (lint rule
# `fault-point`); sites call point() unconditionally.
_PLAN: Optional[FaultPlan] = None

# Armed tracer (set by repro_torch.telemetry.spans._install): every *triggered*
# fault rule drops a `fault.<point>` instant span so chaos traces show
# where the schedule bit.  Ring write only — safe under any lock.
_TEL = None


def point(name: str, call: Optional[str] = None, key: Optional[str] = None,
          host: Optional[str] = None) -> bool:
    """Named injection site.  Disarmed: one pointer compare, returns False.

    Armed: counts the hit against the plan and, if a rule triggers, raises
    (crash/raise points), sleeps (delay points), or returns True (drop
    points — the caller discards the in-flight artefact).
    """
    plan = _PLAN
    if plan is None:
        return False
    return plan._fire(name, call, key, host)


def arm(plan: FaultPlan) -> FaultPlan:
    global _PLAN
    _PLAN = plan
    return plan


def disarm() -> None:
    global _PLAN
    _PLAN = None


def active() -> Optional[FaultPlan]:
    """The armed plan, if any (for tests/benchmarks; sites use point())."""
    return _PLAN


@contextlib.contextmanager
def armed(plan: FaultPlan):
    arm(plan)
    try:
        yield plan
    finally:
        disarm()
