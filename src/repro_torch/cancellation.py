"""Time-sliced cooperative cancellation for pure-compute loops.

Cooperative cancel is normally checked at host-interface calls (chain /
await / state pull-push).  A long pure-compute loop — e.g. a decode loop
dispatching jitted kernels for seconds — has no such checkpoint, so a
cancelled speculative twin used to run to completion in an executor slot.

This module closes that gap without making kernel dispatch pay a per-call
price: the runtime installs a per-thread cancel check around each function
execution, and the kernel dispatch wrappers call :func:`checkpoint` — a
thread-local read plus one ``time.monotonic`` compare.  The installed check
only actually runs once per ``slice_s`` of elapsed time, so cancellation is
honoured within a bounded slice while the steady-state cost stays at ~100ns
per dispatch.

A copy of ``repro.cancellation`` for the PyTorch port, which imports
nothing of ``repro``.  It lives at the package root so that importing it
from ``repro_torch.kernels.common`` pulls no runtime into a kernel import.
Keep it free of torch/runtime imports.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

DEFAULT_SLICE_S = 0.005          # max extra latency a cancel can see per slice

_tls = threading.local()

# the runtime sanitizer installs its checkpoint guard here (enable()):
# it reports any checkpoint reached while a stripe/key lock is held — a
# cancel raising under one would unwind past the release.  None (the
# default) keeps the disabled cost at a single module-global compare.
_SAN_GUARD: Optional[Callable[[], None]] = None


def install(check: Callable[[], None],
            slice_s: float = DEFAULT_SLICE_S,
            beat: Optional[Callable[[], None]] = None,
            budget: Optional[Callable[[], float]] = None) -> None:
    """Arm this thread's cancel checkpoint.  ``check`` raises (e.g.
    ``CallCancelled``) when the current call should stop.

    ``beat`` is an optional liveness callback (the host heartbeat) run once
    per elapsed slice *before* the cancel check: a pure-compute loop that
    only ever reaches these checkpoints would otherwise stop beating for
    the whole kernel and be declared dead by any ``heartbeat_timeout``
    shorter than one long dispatch.

    ``budget`` is an optional callable returning the call's remaining
    end-to-end deadline budget in seconds (``Deadline.remaining``).  When
    installed, the checkpoint tightens its slice as the budget runs down
    (to ~budget/4, floored at 0.5 ms), so a deadline lands within a small
    fraction of the remaining budget instead of up to a full default slice
    late.  Read once per *elapsed* slice, never per checkpoint — calls
    without a deadline pay nothing."""
    _tls.check = check
    _tls.beat = beat
    _tls.slice_s = slice_s
    _tls.budget = budget
    _tls.deadline = time.monotonic() + slice_s


def clear() -> None:
    """Disarm the checkpoint (call finished; executor thread is reused)."""
    _tls.check = None
    _tls.beat = None
    _tls.budget = None


def checkpoint() -> None:
    """Run the installed cancel check if the time slice elapsed.  No-op (one
    attribute read) on threads with nothing installed."""
    if _SAN_GUARD is not None:
        _SAN_GUARD()
    check: Optional[Callable[[], None]] = getattr(_tls, "check", None)
    if check is None:
        return
    now = time.monotonic()
    if now >= _tls.deadline:
        slice_s = _tls.slice_s
        budget = getattr(_tls, "budget", None)
        if budget is not None:
            # deadline-aware: approach the expiry in quarter-budget steps
            # so the cancel fires close to it, not a full slice late
            slice_s = max(min(slice_s, budget() / 4.0), 0.0005)
        _tls.deadline = now + slice_s
        beat = getattr(_tls, "beat", None)
        if beat is not None:
            beat()                   # stay alive before maybe raising
        check()
