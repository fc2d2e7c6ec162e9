"""The single monotonic clock the runtime stamps time with.

Every timestamp in the system — ``Call.t_submit``/``t_start``/``t_end``,
span boundaries, cold-start init timing, the serve/train step timers —
comes from this module, so deltas taken across stamping sites are always
differences on **one** clock.  Before this existed the three ``Call``
stamps were taken by three independent ``time.perf_counter()`` call sites
scattered through ``runtime.py``; that happened to share a clock by
accident, and nothing could assert it.  The faasmlint ``metric-naming``
rule now flags direct ``perf_counter`` use in data-plane modules so the
accident can't silently regress.

Two granularities, same underlying clock (``perf_counter`` /
``perf_counter_ns`` share a time base by definition):

* :func:`now` — float seconds, for coarse lifecycle stamps and span
  boundaries.
* :func:`now_ns` — integer nanoseconds, for fine durations (codec
  encode/decode cost) where float rounding at large magnitudes matters.
"""
from __future__ import annotations

import time

__all__ = ["now", "now_ns"]


def now() -> float:
    """Monotonic seconds (float).  The only sanctioned wall-time source
    for data-plane stamps."""
    return time.perf_counter()


def now_ns() -> int:
    """Monotonic nanoseconds (int), same time base as :func:`now`."""
    return time.perf_counter_ns()
