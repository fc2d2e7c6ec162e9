"""Chrome/Perfetto ``trace_event`` export for collected spans.

Open the output at https://ui.perfetto.dev (or ``chrome://tracing``):
rows ("threads") are hosts — every span lands on the row of the host its
attempt ran on — and wire frames crossing tiers are drawn as async
arrows (flow events) from the pushing span to each applying span, bound
by the frame's ``key@version`` identity.  Span ``args`` carry the trace
context (``call``/``fence``/``epoch``) plus the site tags (wire kind,
bytes, encode/decode ns, version transition, fault point …), so one
logical call's twin/retry/zombie attempts are visually siblings: same
``fence``, different ``epoch``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from repro_torch.telemetry import spans as _spans

__all__ = ["chrome_trace_events", "export_chrome"]

_PID = 1
# span names whose frames *produce* a wire flow vs *consume* one
_FLOW_SRC = ("wire.push",)
_FLOW_DST = ("wire.bcast", "wire.pull")


def _flow_id(span: _spans.Span) -> Optional[str]:
    tags = span.tags or {}
    key, version = tags.get("key"), tags.get("version")
    if key is None or version is None:
        return None
    return f"{key}@{version}"


def chrome_trace_events(span_list: List[_spans.Span]) -> List[Dict[str, Any]]:
    """Render spans to ``trace_event`` dicts (the ``traceEvents`` array)."""
    events: List[Dict[str, Any]] = []
    tids: Dict[str, int] = {}

    def tid_for(span: _spans.Span) -> int:
        row = span.host if span.host is not None else f"thread:{span.thread}"
        tid = tids.get(row)
        if tid is None:
            tid = tids[row] = len(tids) + 1
            events.append({"name": "thread_name", "ph": "M", "pid": _PID,
                           "tid": tid, "args": {"name": row}})
        return tid

    flow_seq: Dict[str, int] = {}
    for s in span_list:
        tid = tid_for(s)
        args: Dict[str, Any] = {}
        if s.call is not None:
            args["call"] = s.call
        if s.fence is not None:
            args["fence"] = s.fence
        if s.epoch is not None:
            args["epoch"] = s.epoch
        if s.tags:
            args.update(s.tags)
        ts = s.t0 * 1e6
        if s.t1 <= s.t0:
            events.append({"name": s.name, "cat": s.cat, "ph": "i",
                           "ts": ts, "pid": _PID, "tid": tid, "s": "t",
                           "args": args})
        else:
            events.append({"name": s.name, "cat": s.cat, "ph": "X",
                           "ts": ts, "dur": (s.t1 - s.t0) * 1e6,
                           "pid": _PID, "tid": tid, "args": args})
        fid = _flow_id(s)
        if fid is not None:
            if s.name in _FLOW_SRC:
                flow_seq[fid] = 1
                events.append({"name": "wire-frame", "cat": "wire",
                               "ph": "s", "id": fid, "ts": ts + 1e-3,
                               "pid": _PID, "tid": tid})
            elif s.name in _FLOW_DST and flow_seq.get(fid):
                events.append({"name": "wire-frame", "cat": "wire",
                               "ph": "f", "bp": "e", "id": fid, "ts": ts,
                               "pid": _PID, "tid": tid})
    return events


def export_chrome(path: str,
                  span_list: Optional[List[_spans.Span]] = None) -> int:
    """Write a Chrome/Perfetto JSON trace; returns the event count.

    ``span_list`` defaults to everything the active tracer has collected
    (drains first — never call while holding a stripe/key lock)."""
    if span_list is None:
        t = _spans.tracer()
        span_list = t.spans() if t is not None else []
    events = chrome_trace_events(span_list)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)
