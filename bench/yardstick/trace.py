"""The reduction of a ``torch.profiler`` trace to what the metrics read.

A traced window is a ``record_function`` span named ``WINDOW`` around
whole units of work (steps, batches) that end in a synchronise.  Within
it: the device's busy time (the union of its kernels, copies and sets),
the time and count of each kernel by its name, the ten device
operations that took most time, and the ten longest idle gaps on the
device, each named by the benchmark's own span (``bench.*``) that the
host was in when the gap began.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple

WINDOW = "bench.traced_window"
NAME_CHARS = 160          # of an operation's name in the breakdown
_NAME = re.compile(r"^(?:void\s+)?(?:(?:\w+|\(anonymous namespace\))::)*"
                   r"([A-Za-z_]\w*)")


def kernel_name(full: str) -> str:
    """A kernel's base name: ``void flash_tc_kernel<...>(...)`` ->
    ``flash_tc_kernel``."""
    m = _NAME.match(full.strip())
    return m.group(1) if m else full


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]     # base name -> (seconds, count)
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    def seconds(self, names) -> float:
        return sum(self.kernels.get(n, (0.0, 0))[0] for n in names)

    def count(self, names) -> int:
        return sum(self.kernels.get(n, (0.0, 0))[1] for n in names)


def _on_card(e) -> bool:
    from torch.autograd import DeviceType
    return e.device_type == DeviceType.CUDA


def _is_work(e) -> bool:
    """Work on the card; a span's shadow on the device's timeline (a user
    annotation, such as the benchmark's own ``bench.*``) is not work."""
    return (_on_card(e) and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench."))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events) -> Trace:
    """The trace of ``events`` (``profile.events()``, times in µs)."""
    spans = [e for e in events if e.name == WINDOW and not _on_card(e)]
    if not spans:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    t0, t1 = spans[0].time_range.start, spans[0].time_range.end
    dev = [(max(e.time_range.start, t0), min(e.time_range.end, t1), e.name)
           for e in events if _is_work(e)
           and e.time_range.end > t0 and e.time_range.start < t1]
    busy = _union([(a, b) for a, b, _ in dev])
    kernels: Dict[str, List[float]] = {}
    ops: Dict[str, float] = {}
    for a, b, name in dev:
        k = kernels.setdefault(kernel_name(name), [0.0, 0])
        k[0] += (b - a) / 1e6
        k[1] += 1
        short = name[:NAME_CHARS]
        ops[short] = ops.get(short, 0.0) + (b - a) / 1e6
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if not _on_card(e)
                  and e.name.startswith("bench.") and e.name != WINDOW)
    gaps, at = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > at:
            gaps.append((_doing(host, at), (a - at) / 1e6))
        at = max(at, b)
    return Trace(window_s=(t1 - t0) / 1e6,
                 busy_s=sum(b - a for a, b in busy) / 1e6,
                 kernels={k: (v[0], int(v[1])) for k, v in kernels.items()},
                 device_ops=sorted(ops.items(), key=lambda x: -x[1])[:10],
                 idle_gaps=sorted(gaps, key=lambda x: -x[1])[:10])


def _doing(host, t: float) -> str:
    """The innermost benchmark span that holds time ``t``."""
    best = None
    for a, b, name in host:
        if a <= t < b and (best is None or a >= best[0]):
            best = (a, b, name)
    return best[2] if best else "host"
