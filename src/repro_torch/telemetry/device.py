"""Device spans: the card's own time of the work a layer queues.

A host span (:mod:`repro_torch.telemetry.spans`) times what the host
does.  On the card the host only queues work, and a captured CUDA graph
runs no host code at all, so a layer's time there is the device's.
:func:`device_span` brackets the work the current stream queues between
its two ends with a pair of CUDA timing events, and reads their
``elapsed_time`` once the device has run both.

When a site does anything
-------------------------

* **Armed**: :func:`repro_torch.telemetry.enable`, or a ``torch.profiler``
  session that is recording (the condition under which
  ``record_function`` itself records).  Under the profiler each span is
  also a ``record_function`` range named ``faasm.<name>`` around the
  host's side of the work, so the program's boundaries sit on the
  profiler's clock beside the kernels they launch.
* **Inside a capture**: while a :class:`SpanRecorder` is open over a CUDA
  graph's capture, every span is recorded into the graph as a pair of
  event-record nodes, armed or not.  The recorder is the graph owner's:
  each armed replay re-times its spans, a disarmed one leaves them
  unread.
* **The caller's own**: a span given ``event``, the factory of its
  caller's timing events, is the caller's to read (the serving loop's
  prefill and decode steps, a fan-out call's copy and forward); with
  ``always`` it is taken armed or not, because the caller reads the time
  itself.

Otherwise a site costs one check and returns a shared no-op context.
Without the card (a CPU tensor, no timing events of a caller or a
recorder) a span times nothing: it is the profiler range alone.

Reading
-------

A span is read only once its end event has completed (``query()``);
the plane never waits on the device.  A caller reads its own spans after
a wait of its own (:meth:`_Span.read`) and publishes what it wants to.
A captured graph's owner reads the last armed replay's spans before the
next replay (:meth:`SpanRecorder.replaying`); a span that the later
replay overwrote before it could be read is dropped and counted in
``faasm_telemetry_device_spans_dropped_total``: never misread.  Every
scrape of the process registry reads what has completed of the rest, a
graph's last armed replay after its owner closed it included.

A span read goes into its histogram in the process registry,
``faasm_<name, dots as underscores>_ms`` (``train.flash_bwd`` is
``faasm_train_flash_bwd_ms``), and, while the tracer is enabled, into its
rings as a :class:`~repro_torch.telemetry.spans.Span` of category
``device``, tagged with the step or batch it belongs to, placed on the
host clock where its work was queued (a captured span: at its replay's
host call, offset by its start's distance from the graph's first span).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, List, Optional

import torch

from repro_torch.telemetry import clock
from repro_torch.telemetry import metrics as _metrics
from repro_torch.telemetry import spans as _spans

__all__ = ["DROPPED", "SpanRecorder", "armed", "cuda_event", "device_span",
           "histogram_name", "publish", "resolve"]

DROPPED = "faasm_telemetry_device_spans_dropped_total"
_EAGER_CAP = 4096          # unread spans outside any recorder, then dropped

_profiling = torch.autograd._profiler_enabled


def armed() -> bool:
    """The tracer is enabled, or a profiler session is recording."""
    return _spans._active is not None or _profiling()


def histogram_name(span: str) -> str:
    return "faasm_" + span.replace(".", "_") + "_ms"


def publish(name: str, ms: float, t0: float, **tags) -> None:
    """One device-clock reading of ``name``: into its histogram and, while
    the tracer is enabled, its rings (``t0`` on the host clock)."""
    _metrics.registry().histogram(
        histogram_name(name), f"device time of {name} (CUDA events)"
    ).observe(ms)
    tel = _spans._active
    if tel is not None:
        tel.record(name, "device", t0, t0 + ms / 1e3, **tags)


def _dropped(n: int) -> None:
    if n:
        _metrics.registry().counter(
            DROPPED, "device spans overwritten or unread before they "
            "could be read").inc(n)


def cuda_event() -> torch.cuda.Event:
    """A timing event on the card.  External: recorded inside a capture,
    it becomes an event-record node of the graph (one that times), not a
    dependency inside the capture."""
    return torch.cuda.Event(enable_timing=True, external=True)


# -- the capture recorders open now and the spans not yet read ---------------

_SHARED: tuple = ()          # the recorders open over a capture
_LOCK = threading.Lock()     # _SHARED, _PENDING, _EAGER
_PENDING: set = set()        # recorders with an armed replay not yet read
_EAGER: deque = deque()      # spans taken outside any recorder, unread


class _Off:
    """The disarmed site: no range, no events, nothing recorded."""

    __slots__ = ()
    start = end = ms = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def read(self) -> None:
        return None


_OFF = _Off()


def device_span(name: str, device=None, *, event=None, always: bool = False,
                **tags):
    """A context that times on the device the work queued inside it (see
    the module docstring for when it does).  ``device`` is the work's
    device: outside a capture, a span whose device is not the card times
    nothing.  ``event`` makes the span its caller's (timed with the
    caller's events, read by the caller alone), ``always`` takes such a
    span disarmed too.  The context's value has ``ms`` once read (``None``
    before, and where nothing was timed)."""
    if event is not None:
        if not (always or armed()):
            return _OFF
        return _Span(name, tags, event, None)
    if not (_SHARED or _spans._active is not None or _profiling()):
        return _OFF
    if _SHARED:
        rec = _SHARED[-1]
        return _Span(name, tags, rec.event, rec._add)
    if device is not None and torch.device(device).type == "cuda":
        return _Span(name, tags, cuda_event, _add_eager)
    return _Span(name, tags, None, None)


class _Span:
    __slots__ = ("name", "tags", "event", "keep", "start", "end", "t0", "ms",
                 "_range")

    def __init__(self, name: str, tags: dict, event, keep) -> None:
        self.name, self.tags = name, tags
        self.event = event    # makes the timing events; None: none
        self.keep = keep      # takes the span once recorded; None: the caller's
        self.start = self.end = self.ms = self._range = None

    def __enter__(self) -> "_Span":
        if _profiling():
            self._range = torch.profiler.record_function("faasm." + self.name)
            self._range.__enter__()
        event = self.event
        if self.keep is _add_eager and torch.cuda.is_current_stream_capturing():
            event = None        # a capture no recorder owns: nothing to read
        if event is not None:
            self.start, self.end = event(), event()
            self.start.record()
        self.t0 = clock.now()
        return self

    def __exit__(self, *exc) -> None:
        if self.end is not None:
            self.end.record()
            if self.keep is not None:
                self.keep(self)
        if self._range is not None:
            self._range.__exit__(*exc)

    def _elapsed(self) -> Optional[float]:
        """The span's ms once its end event has completed, else None."""
        if not self.end.query():
            return None
        return self.start.elapsed_time(self.end)

    def read(self) -> Optional[float]:
        """The caller's read of its own span, once its end event has
        completed (``ms``; None before, and where nothing was timed)."""
        if self.ms is None and self.end is not None:
            self.ms = self._elapsed()
        return self.ms


def _add_eager(span: _Span) -> None:
    """Keep ``span`` for a scrape, reading first the oldest that are done
    (one stream runs them in order), so the list stays short."""
    done, over = [], 0
    with _LOCK:
        _EAGER.append(span)
        while _EAGER and _EAGER[0] is not span:
            ms = _EAGER[0]._elapsed()
            if ms is None:
                break
            s = _EAGER.popleft()
            s.ms = ms
            done.append(s)
        while len(_EAGER) > _EAGER_CAP:
            _EAGER.popleft()
            over += 1
    for s in done:
        publish(s.name, s.ms, s.t0, **s.tags)
    _dropped(over)


def resolve() -> None:
    """Read every span whose events have completed, outside any recorder
    or of a recorder's armed replay not yet read; never waits.  Runs at
    every scrape of the process registry."""
    with _LOCK:
        done, kept = [], []
        for s in _EAGER:
            ms = s._elapsed()
            if ms is None:
                kept.append(s)
            else:
                s.ms = ms
                done.append(s)
        if done:
            _EAGER.clear()
            _EAGER.extend(kept)
        recorders = list(_PENDING)
    for s in done:
        publish(s.name, s.ms, s.t0, **s.tags)
    for rec in recorders:
        rec._resolve(final=False)


_metrics.registry().register_collector(lambda reg: resolve())


class SpanRecorder:
    """The owner of the device spans recorded into a CUDA graph while it
    is open over the graph's capture; ``event`` makes their timing events
    (:meth:`~repro_torch.launch.step_graphs.CudaCapture.event`, or a
    stand-in capture's).

    It takes the spans of every thread (a train step's backward runs on
    autograd's device thread), so it must be the only recorder open in
    the process, as a :class:`~repro_torch.kernels.common.LaunchLog` on
    every thread must.  Its spans are the graph's event-record nodes,
    taken armed or not, and re-timed by every replay.  The owner calls
    :meth:`replaying` before each replay and :meth:`replayed` after it."""

    def __init__(self, event: Callable[[], object]) -> None:
        self.event = event
        self.spans: List[_Span] = []     # in capture order
        self._unread: List[_Span] = []
        self._at = (0.0, {})             # an armed replay's host time, tags
        self._lock = threading.Lock()

    def __enter__(self) -> "SpanRecorder":
        global _SHARED
        with _LOCK:
            _SHARED = (*_SHARED, self)
        return self

    def __exit__(self, *exc) -> None:
        global _SHARED
        with _LOCK:
            _SHARED = tuple(r for r in _SHARED if r is not self)

    def _add(self, span: _Span) -> None:
        with self._lock:
            self.spans.append(span)

    def replaying(self) -> None:
        """Before a replay: read the last armed replay's spans that have
        completed and drop the rest, whose events this replay rewrites."""
        self._resolve(final=True)

    def replayed(self, t0: float, **tags) -> None:
        """After a replay queued at host time ``t0``: when armed, its spans
        wait to be read, tagged with ``tags``."""
        if not self.spans or not armed():
            return
        with self._lock:
            self._unread = list(self.spans)
            self._at = (t0, tags)
        with _LOCK:
            _PENDING.add(self)

    def _resolve(self, final: bool) -> None:
        traced = _spans._active is not None
        with self._lock:      # a replay waits: it would rewrite the events
            done, kept = [], []
            t0, tags = self._at
            anchor = self.spans[0].start if self.spans else None
            for s in self._unread:
                ms = s._elapsed()
                if ms is None:
                    kept.append(s)
                    continue
                s.ms = ms
                at = t0 + (anchor.elapsed_time(s.start) / 1e3 if traced
                           else 0.0)
                done.append((s, at))
            self._unread = [] if final else kept
            if not self._unread:
                with _LOCK:
                    _PENDING.discard(self)
        for s, at in done:
            publish(s.name, s.ms, at, **{**tags, **s.tags})
        _dropped(len(kept) if final else 0)
