"""The serving loop's compiled step: the prefill and one decode step, each
captured once as a CUDA graph and then replayed.

Counterpart of ``prefill = jax.jit(model.prefill)`` and ``decode =
jax.jit(model.decode_step)`` in ``repro.launch.serve``: the reference
compiles each step once per shape and then calls the compiled program;
here each step's kernels are recorded once on the card, and every later
step is one host call that replays the record.  The kernels and their
order are those of the eager loop (:func:`eager_generate`), which is what
the CPU runs: it has no graphs.  The VLM's patch embeddings and the
encoder's frames (``extra``) go to the prefill, as in the reference's
``prefill(params, tokens, cache, extra)``; a VLM's positions start after
its ``n_image_tokens`` patch embeddings.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, NamedTuple, Optional

import torch

from repro_torch import cancellation
from repro_torch.kernels.common import LaunchLog, resolve_device
from repro_torch.telemetry import clock as tclock
from repro_torch.telemetry.device import cuda_event, device_span, publish


@dataclasses.dataclass
class Generation:
    """One greedy generation: ``ids`` (B, new_tokens) int32, ``logits`` the
    (B, V) f32 logits that chose each id (when kept, else empty), and the
    seconds of the prefill and of the decode steps after it.  The graphed
    loop takes them on the device's clock (its batch's device spans), the
    eager loop on the host's (``telemetry.clock``, each after a sync)."""
    ids: torch.Tensor
    logits: List[torch.Tensor]
    prefill_s: float
    decode_s: float


def sync(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def eager_generate(model, params, tokens, new_tokens: int,
                   keep_logits: bool = False, extra=None) -> Generation:
    """Prefill ``tokens`` (B, S) (and ``extra``, the family's extra input)
    and decode greedily, op by op from Python, into a fresh cache of
    ``model.prefix_len`` + S + ``new_tokens`` positions.  The prefill and
    each decode step are device spans (``serve.prefill``,
    ``serve.decode_step``) while armed."""
    B, S = tokens.shape
    device = tokens.device
    cache = model.init_cache(B, model.prefix_len + S + new_tokens, device)
    sync(device)
    t0 = tclock.now()
    with device_span("serve.prefill", device):
        logits, cache, n = model.prefill(params, tokens, cache, extra)
    tok = torch.argmax(logits, -1).to(torch.int32)
    sync(device)
    t1 = tclock.now()
    out, kept = [tok], ([logits] if keep_logits else [])
    for i in range(new_tokens - 1):
        idx = torch.full((B,), n + i, dtype=torch.int32, device=device)
        with device_span("serve.decode_step", device):
            logits, cache = model.decode_step(params, tok, cache, idx)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out.append(tok)
        if keep_logits:
            kept.append(logits)
    sync(device)
    return Generation(torch.stack(out, dim=1), kept, t1 - t0,
                      tclock.now() - t1)


_CAPTURE_LOCK = threading.Lock()   # one capture at a time in the process


class CudaCapture:
    """How :class:`ServeGraphs` records its steps on the card: one capture
    stream and one memory pool, which its graphs share.  (A test hands
    :class:`ServeGraphs` a stand-in with the same three methods.)

    Captures take turns, one at a time in the process, as PyTorch's graph
    API expects; replays and other work need no turn.  A capture does not
    first sync the device and empty the allocator's cache as
    ``torch.cuda.graph`` does, which would wait for and disturb the other
    threads.  With ``thread_local`` (each executor slot of
    :class:`~repro_torch.launch.call_graphs.CallGraphs` owns one) it runs
    in CUDA's thread-local capture mode, so that the other threads of the
    process go on launching, allocating and syncing while it runs; else in
    the global mode, which fails it if any thread does something unsafe.
    ``stream``, when given, is the capture stream (else a new one from
    PyTorch's pool)."""

    def __init__(self, device: torch.device, thread_local: bool = False,
                 stream: Optional[torch.cuda.Stream] = None) -> None:
        self.stream = torch.cuda.Stream(device) if stream is None else stream
        self.pool = torch.cuda.graph_pool_handle()
        self.mode = "thread_local" if thread_local else "global"

    def on_stream(self, after_current: bool = True):
        """A context that queues work on the capture stream, after what the
        current stream has queued (the warm-up) unless ``after_current`` is
        False."""
        if after_current:
            self.stream.wait_stream(
                torch.cuda.current_stream(self.stream.device))
        return torch.cuda.stream(self.stream)

    def capture(self, body: Callable[[], None]) -> torch.cuda.CUDAGraph:
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool, capture_error_mode=self.mode)
            try:
                body()
            finally:
                graph.capture_end()
        return graph

    @staticmethod
    def event() -> torch.cuda.Event:
        """A timing event of its owner's device spans
        (``telemetry.device``), recorded on the stream current then."""
        return cuda_event()


class _Step(NamedTuple):
    graph: object                 # torch.cuda.CUDAGraph, or a test's stand-in
    launches: LaunchLog           # the kernels one replay launches


class ServeGraphs:
    """The prefill and one decode step of ``model`` at one (``batch``,
    ``prompt_len``, ``max_len``), captured once on the card and replayed, as
    one jitted shape of the reference.  A prompt of another shape, or more
    new tokens than the cache holds, raises: nothing re-captures.

    Static buffers: the prompt (B, S) int32; ``extra``, a copy of the
    family's extra input given at construction (the VLM's patch
    embeddings, the encoder's frames; None for the other families), which
    the prefill graph reads, so that these graphs serve that one input;
    ``tok`` (B,) int32, which each
    step reads and then overwrites with its argmax; ``idx`` (B,) int32, the
    position of the next token, which the prefill graph sets to
    ``model.prefix_len`` + S and each decode graph advances by 1 on the card, so that the host writes nothing
    between steps; the serving ``cache``; and ``logits`` (B, V) f32, which
    each step overwrites with its own.

    Before capture, one prefill and one decode step run eagerly on the
    capture stream: the kernels are built and loaded, cuBLAS has its
    handle and workspace for that stream, and decode attention (K6) has
    its last-block counters for it, which it refuses to make inside a
    capture.  Their launches count as usual; ``warmup_launches`` keeps
    them.  In a capture the wrappers' launches are recorded, not counted
    (:class:`~repro_torch.kernels.common.LaunchLog`), and each replay
    counts its graph's once, by kernel and key, so the launch counters
    read as after the eager loop.  Each replay is also one cancellation
    checkpoint, which a replay's kernels cannot reach.

    K6's counters belong to (device, capture stream), and the decode graph
    keeps the set it was captured with: run no eager K6 call on the capture
    stream while a replay runs.  Capture streams come from PyTorch's pool,
    so two objects may capture on one stream and share a set; that is
    safe while their replays run in series, as on the one stream that
    replays them here (the caller's current stream).  The two graphs share
    one memory pool: the prefill graph's scratch is the decode graph's,
    which holds because they never run at once and no step reads what the
    other left in the pool (the steps pass the token, position and cache
    in buffers made before capture).  :meth:`close` frees the graphs and
    then the pool's memory.

    Any failure of the warm-up, a capture or a replay raises; nothing runs
    the eager loop instead.  A step that syncs with the host inside a
    capture fails it, as does a kernel launched on another stream."""

    def __init__(self, model, params, batch: int, prompt_len: int,
                 max_len: int, device="cuda", *,
                 capture: Optional[CudaCapture] = None,
                 extra: Optional[torch.Tensor] = None) -> None:
        device = resolve_device(device)
        if capture is None:
            if device.type != "cuda":
                raise ValueError("CUDA graphs need the card; on the CPU run "
                                 "eager_generate")
            capture = CudaCapture(device)
        self.start = model.prefix_len + prompt_len   # the first decode
        if not 0 < prompt_len < max_len or self.start >= max_len:
            raise ValueError(f"prompt_len {prompt_len} after "
                             f"{model.prefix_len} patch embeddings, "
                             f"max_len {max_len}")
        self.model, self.params, self.device = model, params, device
        self.shape = (batch, prompt_len, max_len)
        self.prompt = torch.zeros((batch, prompt_len), dtype=torch.int32,
                                  device=device)
        self.extra = None if extra is None else extra.to(device, copy=True)
        self.tok = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.idx = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.logits = torch.zeros((batch, model.cfg.vocab_size),
                                  dtype=torch.float32, device=device)
        self.cache = model.init_cache(batch, max_len, device)
        self.replays = {"prefill": 0, "decode": 0}
        self.batches = 0                   # generate's calls
        self._event = capture.event        # the batch's timing events
        self._next: Optional[int] = None   # idx as the host knows it
        with torch.no_grad():
            with LaunchLog() as self.warmup_launches, capture.on_stream():
                self._prefill_body()
                self._decode_body()
            self._steps = {"prefill": self._capture(capture,
                                                    self._prefill_body),
                           "decode": self._capture(capture,
                                                   self._decode_body)}

    def _prefill_body(self) -> None:
        logits, _, n = self.model.prefill(self.params, self.prompt,
                                          self.cache, self.extra)
        self._emit(logits)
        self.idx.fill_(n)

    def _decode_body(self) -> None:
        logits, _ = self.model.decode_step(self.params, self.tok, self.cache,
                                           self.idx)
        self._emit(logits)
        self.idx.add_(1)

    def _emit(self, logits: torch.Tensor) -> None:
        self.logits.copy_(logits)
        self.tok.copy_(torch.argmax(self.logits, -1))

    @staticmethod
    def _capture(capture, body) -> _Step:
        with LaunchLog(capturing=True) as log:
            graph = capture.capture(body)
        return _Step(graph, log)

    def _replay(self, name: str) -> torch.Tensor:
        cancellation.checkpoint()
        step = self._steps[name]
        step.graph.replay()
        step.launches.replay()
        self.replays[name] += 1
        return self.logits

    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        """Replay the prefill on ``tokens`` (B, S) (and ``extra``); returns
        the last token's logits (``logits``, which the next step rewrites)
        and leaves their argmax in ``tok``."""
        B, S, _ = self.shape
        if tuple(tokens.shape) != (B, S):
            raise ValueError(f"prompt of shape {tuple(tokens.shape)}: these "
                             f"graphs were captured for ({B}, {S})")
        self.prompt.copy_(tokens)
        logits = self._replay("prefill")
        self._next = self.start
        return logits

    def step(self) -> torch.Tensor:
        """Replay one decode step on ``tok``; returns its logits
        (``logits``, which the next step rewrites) and leaves their argmax
        in ``tok``."""
        if self._next is None or self._next >= self.shape[2]:
            raise ValueError(f"decode at position {self._next}: prefill "
                             f"first; the cache holds {self.shape[2]}")
        logits = self._replay("decode")
        self._next += 1
        return logits

    @torch.no_grad()
    def generate(self, tokens: torch.Tensor, new_tokens: int,
                 keep_logits: bool = False) -> Generation:
        """One prefill replay, then ``new_tokens - 1`` decode replays, each
        step's token (and logits) copied out, and one sync at the end.

        The batch's device spans, read after that sync: ``serve.prefill``
        around the prefill replay and its copies out, always
        (``Generation.prefill_s``; the decode's seconds run from its end to
        the batch's last event); while armed, ``serve.decode_step`` around
        each decode replay and its copies out and, given at least one
        decode step, ``serve.host_wait``: the device time between the
        batch's first and last events in which none of its spans ran, i.e.
        the device waiting on this host (tagged with ``lead_ms``, the part
        before the prefill)."""
        max_len = self.shape[2]
        if not 1 <= new_tokens <= max_len - self.start:
            raise ValueError(f"{new_tokens} new tokens: these graphs hold "
                             f"1 to {max_len - self.start}")
        batch, event = self.batches, self._event
        self.batches += 1
        first = event()
        first.record()
        t0 = tclock.now()
        with device_span("serve.prefill", event=event, always=True,
                         batch=batch) as pre:
            logits = self.prefill(tokens)
            out = [self.tok.clone()]
            kept = [logits.clone()] if keep_logits else []
        steps = []
        for _ in range(new_tokens - 1):
            with device_span("serve.decode_step", event=event,
                             batch=batch) as step:
                logits = self.step()
                out.append(self.tok.clone())
                if keep_logits:
                    kept.append(logits.clone())
            steps.append(step)
        last = event()
        last.record()
        sync(self.device)
        publish("serve.prefill", pre.read(), pre.t0, batch=batch)
        timed = [s for s in steps if s.read() is not None]
        for s in timed:
            publish(s.name, s.ms, s.t0, batch=batch)
        if steps and len(timed) == len(steps):
            publish("serve.host_wait", first.elapsed_time(last) - pre.ms
                    - sum(s.ms for s in steps), t0, batch=batch,
                    lead_ms=first.elapsed_time(pre.start))
        return Generation(torch.stack(out, dim=1), kept, pre.ms / 1e3,
                          pre.end.elapsed_time(last) / 1e3)

    def close(self) -> None:
        """Free the graphs and so the memory of their pool."""
        for step in self._steps.values():
            step.graph.reset()
        self._steps = {}
