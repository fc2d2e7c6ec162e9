"""Named counters / gauges / log-bucketed histograms, one registry.

The registry is the single source of truth the scattered per-object
counters publish into: hot paths keep their cheap lock-local integers
(``GlobalTier`` stripe counters, ``Host.cold_starts``,
``LocalTier.codec_fallbacks``, ``WirePolicy.flips`` …) and a registered
**collector** snapshots them into gauges at scrape time — the Prometheus
client-library pattern, so reading metrics costs the hot path nothing.

Naming convention (enforced here *and* statically by the faasmlint
``metric-naming`` rule): ``faasm_<subsystem>_<name>_<unit>`` with the
unit suffix drawn from :data:`UNITS` — e.g. ``faasm_tier_copied_bytes``,
``faasm_serve_request_ms``, ``faasm_host_cold_starts_total``.

Histograms are HDR-style log-bucketed: bucket boundaries grow by
:data:`GROWTH` (2^(1/16) ≈ 4.4 % per bucket), so ``percentile`` answers
p50/p90/p99/p999 with bounded *relative* error (≤ ~2.2 %, the geometric
half-bucket) at O(1) memory per decade regardless of sample count.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Callable, Dict, List, Optional, Union

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "UNITS", "registry",
    "serve_http", "valid_name",
]

UNITS = ("seconds", "ms", "us", "ns", "bytes", "pages", "total", "count",
         "ratio", "rps")
_NAME_RE = re.compile(
    r"^faasm(_[a-z0-9]+)+_(" + "|".join(UNITS) + r")$")

GROWTH = 2.0 ** (1.0 / 16.0)     # per-bucket growth: ~4.4% relative width
_LOG_GROWTH = math.log(GROWTH)


def valid_name(name: str) -> bool:
    return _NAME_RE.match(name) is not None


def _check_name(name: str) -> str:
    if not valid_name(name):
        raise ValueError(
            f"metric name {name!r} violates the convention "
            f"faasm_<subsystem>_<name>_<unit> (unit one of {UNITS})")
    return name


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "help", "_mu", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._mu = threading.Lock()
        self._value = 0.0

    def inc(self, n: Union[int, float] = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._mu:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value (set, not accumulated)."""

    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, v: Union[int, float]) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Log-bucketed distribution with exact count/sum/min/max.

    Non-positive observations land in a dedicated zero bucket (values
    below :data:`GROWTH`'s resolution are indistinguishable from zero on
    a relative-error scale anyway)."""

    __slots__ = ("name", "help", "_mu", "_buckets", "_zero",
                 "count", "sum", "min", "max")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._mu = threading.Lock()
        self._buckets: Dict[int, int] = {}
        self._zero = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: Union[int, float]) -> None:
        v = float(v)
        with self._mu:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if v <= 0.0:
                self._zero += 1
            else:
                idx = int(math.floor(math.log(v) / _LOG_GROWTH))
                self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def percentile(self, p: float) -> float:
        """Value at quantile ``p`` in [0, 1]; geometric bucket midpoint,
        so relative error is bounded by the half-bucket (~2.2 %)."""
        with self._mu:
            if self.count == 0:
                return 0.0
            rank = p * (self.count - 1)
            seen = self._zero
            if rank < seen:
                return 0.0
            for idx in sorted(self._buckets):
                seen += self._buckets[idx]
                if rank < seen:
                    lo = GROWTH ** idx
                    return min(max(lo * math.sqrt(GROWTH), self.min),
                               self.max)
            return self.max

    def quantiles(self) -> Dict[str, float]:
        return {"0.5": self.percentile(0.50), "0.9": self.percentile(0.90),
                "0.99": self.percentile(0.99),
                "0.999": self.percentile(0.999)}


class Registry:
    """Get-or-create registry of named instruments + scrape collectors."""

    def __init__(self):
        self._mu = threading.Lock()
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}
        self._collectors: List[Callable[["Registry"], None]] = []

    def _get(self, cls, name: str, help: str):
        _check_name(name)
        with self._mu:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help)
            elif type(m) is not cls:
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, wanted {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def get(self, name: str):
        with self._mu:
            return self._metrics.get(name)

    def register_collector(self, fn: Callable[["Registry"], None]) -> None:
        """``fn(registry)`` runs at every scrape — snapshot your hot-path
        counters into gauges there, not on the hot path."""
        with self._mu:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn: Callable[["Registry"], None]) -> None:
        with self._mu:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def collect(self) -> None:
        with self._mu:
            collectors = list(self._collectors)
        for fn in collectors:
            fn(self)

    def snapshot(self) -> Dict[str, float]:
        """Scrape to a flat dict (histograms contribute their quantiles,
        count and sum) — what benchmarks and stats readers consume."""
        self.collect()
        out: Dict[str, float] = {}
        with self._mu:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if isinstance(m, Histogram):
                out[f"{name}_count"] = float(m.count)
                out[f"{name}_sum"] = m.sum
                for q, v in m.quantiles().items():
                    out[f"{name}{{quantile={q}}}"] = v
            else:
                out[name] = m.value
        return out

    def render_text(self) -> str:
        """Prometheus text exposition (histograms as summaries)."""
        self.collect()
        lines: List[str] = []
        with self._mu:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {m.value:g}")
            else:
                lines.append(f"# TYPE {name} summary")
                for q, v in m.quantiles().items():
                    lines.append(f'{name}{{quantile="{q}"}} {v:g}')
                lines.append(f"{name}_sum {m.sum:g}")
                lines.append(f"{name}_count {m.count}")
        return "\n".join(lines) + "\n"


_DEFAULT = Registry()


def registry() -> Registry:
    """The process-wide default registry (serve/train instruments live
    here; a :class:`FaasmRuntime` keeps its own and chains to this)."""
    return _DEFAULT


def serve_http(reg: Registry, port: int, host: str = "127.0.0.1"):
    """Expose ``reg.render_text()`` over HTTP (any GET path) in a daemon
    thread — the ``serve --metrics-port`` backend.  Returns the server;
    call ``.shutdown()`` to stop."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):                          # noqa: N802 (stdlib API)
            body = reg.render_text().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):              # quiet
            pass

    srv = ThreadingHTTPServer((host, port), _Handler)
    threading.Thread(target=srv.serve_forever, name="faasm-metrics",
                     daemon=True).start()
    return srv
