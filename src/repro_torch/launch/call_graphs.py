"""The Faaslet forward compiled for the card: one captured forward per
executor slot, fed from the call's pinned host leaves.

Counterpart of the reference's ``jax.jit(lambda p, t: model.logits(p, t))``
in ``repro.launch.serve.make_infer_function``, which the runtime keeps in
its ``ExecutableCache`` and every Faaslet call runs over ``jnp.asarray`` of
its own Proto-Faaslet's leaves.  Here the cache holds a
:class:`CallGraphs`: a pool of slots, one per executor, each with its own
stream, static parameter buffers and, for each prompt length it has seen,
the forward and its argmax captured once as a CUDA graph.  A call copies
its parameters into a free slot's buffers (the reference's per-call copy),
replays that slot's graph and reads the token back with one wait on the
slot's stream.  The CPU has no graphs: there the launcher runs the eager
forward (``launch/serve.py``).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import cancellation
from repro_torch.kernels.common import LaunchLog, resolve_device
from repro_torch.launch.step_graphs import CudaCapture
from repro_torch.models.weights import params_class
from repro_torch.telemetry import clock as tclock
from repro_torch.telemetry.device import device_span


_STREAMS: Dict[tuple, torch.cuda.Stream] = {}   # (device, slot) -> stream
_STREAMS_LOCK = threading.Lock()


def slot_stream(device: torch.device, index: int) -> torch.cuda.Stream:
    """The stream of slot ``index`` on ``device``, the same for every
    :class:`CallGraphs` of the process.  cuBLAS keeps a workspace (32 MiB
    on the H100) for each (thread's handle, stream) it ran on until the
    process ends, so a new stream for each rebuilt forward would leave one
    behind at every container cold start."""
    with _STREAMS_LOCK:
        key = (device, index)
        if key not in _STREAMS:
            _STREAMS[key] = torch.cuda.Stream(device)
        return _STREAMS[key]


_ALIGN = 256          # bytes: where each leaf of a flat buffer starts


def flat_layout(specs) -> tuple:
    """Pack leaves, ``(name, dtype, shape)`` each, into one flat buffer per
    dtype, each leaf on a 256-byte boundary (as an allocation would be, so
    that a kernel or cuBLAS finds its operands aligned as in the eager
    forward).  Returns (layout, sizes): ``(name, dtype, offset, shape)``
    per leaf in order, and each buffer's elements by dtype."""
    layout, sizes = [], {}
    for name, dtype, shape in specs:
        align = _ALIGN // dtype.itemsize
        offset = -(-sizes.get(dtype, 0) // align) * align
        layout.append((name, dtype, offset, tuple(shape)))
        sizes[dtype] = offset + int(np.prod(shape, dtype=np.int64))
    return tuple(layout), sizes


def flat_views(layout, flats: Mapping[torch.dtype, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """Each leaf of ``layout`` as a view into its dtype's flat buffer."""
    views = {}
    for name, dtype, offset, shape in layout:
        n = int(np.prod(shape, dtype=np.int64))
        views[name] = flats[dtype][offset:offset + n].view(shape)
    return views


def param_bytes(cfg) -> int:
    """The bytes of ``cfg``'s parameters: one slot's static buffers, and
    what each call copies to the card (0.93 GB for qwen1.5-0.5b, whose
    unembedding is its embedding; 0.26 GB for mamba2-130m)."""
    p = params_class(cfg)(cfg, device="meta")
    return sum(x.numel() * x.element_size() for x in p.parameters())


class CallResult(NamedTuple):
    """One call of :class:`CallGraphs`.  The times are the slot stream's,
    the call's device spans (``telemetry/device.py``, taken at every call
    with the slot capture's timing events): ``h2d_ms`` the copy of the
    parameters and the prompt (``serve.param_h2d``), ``forward_ms`` the
    replay and the token's copy back (``serve.call_forward``);
    ``capture_ms`` is the host's time to warm up and capture a prompt
    length the slot had not seen (0.0 when the call only replayed).
    ``logits`` are the last position's f32 logits when kept, else None."""
    token: int
    h2d_ms: float
    forward_ms: float
    capture_ms: float
    logits: Optional[torch.Tensor]


class _Forward(NamedTuple):
    graph: object                   # torch.cuda.CUDAGraph, or a test's stand-in
    launches: LaunchLog             # the kernels one replay launches
    prompt: torch.Tensor            # (1, S) int32 on the device
    host_prompt: torch.Tensor       # (1, S) int32, pinned on the card's host
    out: Dict[str, torch.Tensor]    # the graph's outputs: logits, tok


class _Slot:
    """One executor's share: its index, its capture (stream and memory
    pool), its static parameters (views into one flat device buffer per
    dtype, ``flats``), a pinned token buffer and its captured forwards by
    prompt length."""

    def __init__(self, index: int, capture, params: torch.nn.Module,
                 flats: Dict[torch.dtype, torch.Tensor],
                 host_tok: torch.Tensor) -> None:
        self.index = index              # its stream's (``slot_stream``)
        self.capture = capture
        self.params = params
        self.flats = flats
        self.host_tok = host_tok
        self.forwards: Dict[int, _Forward] = {}

    def release(self) -> None:
        """Free the graphs, then the buffers: the pool's memory goes back
        once no graph and no output tensor holds it."""
        for f in self.forwards.values():
            f.graph.reset()
        self.forwards = {}
        self.params = self.flats = self.host_tok = None


class CallGraphs:
    """The compiled Faaslet forward of ``model``: up to ``capacity`` slots
    (one per executor thread of the runtime), made when first needed.

    A call (``graphs(leaves, tokens)``) checks out a free slot, so no slot
    ever serves two calls at once (a call waits when all ``capacity`` are
    busy), and on the slot's stream: copies the leaves into the slot's
    parameters and the prompt into its static prompt, with
    ``non_blocking`` copies.  Leaves and parameters are packed alike
    (:func:`flat_layout`: ``launch/serve.py::HostLeaves``, pinned on the
    card's host, and the slot's flat device buffers), so that the copy is
    one transfer per dtype, not one per leaf from Python.  Then it replays
    the slot's graph of
    ``model.logits`` and its argmax for the prompt's length; copies the
    token back to pinned memory and waits for that stream alone.  A replay
    launches on the current stream, which is the slot's here.

    A prompt of a length the slot has not seen is captured first, as
    ``jax.jit`` traces a new shape: one eager forward on the slot's stream
    (its kernels built and loaded, cuBLAS's workspace made for that
    stream), its launches counted as usual and kept apart in
    ``warmup_launches``, then the capture, in CUDA's thread-local mode so
    that the other executors keep running (``CudaCapture(thread_local=
    True)``).  Nothing runs the forward eagerly in a call's place: a
    failed warm-up, capture or replay fails the call, and the slot is
    dropped.  Each replay is one cancellation checkpoint, and adds its
    graph's launches once (``LaunchLog.replay``).

    A slot's graphs share its memory pool.  They replay one at a time,
    each call reading its graph's outputs right after its own replay, and
    their inputs (parameters, prompt) lie in buffers made before any
    capture: so a replay that overwrites memory another graph of the slot
    left its outputs in is harmless.  :meth:`close` frees the idle slots at
    once and each busy one when its call returns it.

    ``capture_factory(i)`` makes the capture of slot ``i`` (a stand-in in
    the CPU tests); on the card a ``CudaCapture`` in thread-local mode on
    :func:`slot_stream` ``i``: a rebuilt forward's slot ``i`` takes the
    stream of the one it replaces.
    """

    def __init__(self, model, capacity: int, device="cuda", *,
                 capture_factory: Optional[Callable[[int], object]] = None
                 ) -> None:
        device = resolve_device(device)
        if capture_factory is None:
            if device.type != "cuda":
                raise ValueError("CUDA graphs need the card; on the CPU run "
                                 "the eager forward")
            capture_factory = lambda i: CudaCapture(
                device, thread_local=True, stream=slot_stream(device, i))
        if capacity < 1:
            raise ValueError(f"capacity {capacity}")
        self.model, self.device, self.capacity = model, device, capacity
        self.slot_bytes = param_bytes(model.cfg)
        meta = params_class(model.cfg)(model.cfg, device="meta")
        self.layout, self._sizes = flat_layout(
            (n, p.dtype, p.shape) for n, p in meta.named_parameters())
        if device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(device)
            if capacity * self.slot_bytes > free:
                raise RuntimeError(
                    f"{capacity} slots of {self.slot_bytes / 1e9:.2f} GB of "
                    f"parameters do not fit in the card's free "
                    f"{free / 1e9:.1f} GB")
        self._pin = device.type == "cuda"
        self._new_capture = capture_factory
        self._cv = threading.Condition()
        self._free: list = []           # idle slots, the last returned last
        self._made = 0                  # slots alive (busy or idle)
        self._indices = list(range(capacity - 1, -1, -1))  # not in use
        self._closed = False
        self.replays = 0
        self.captures = 0
        self.warmup_launches = LaunchLog()   # every warm-up's, merged

    # -- slots -----------------------------------------------------------------

    def _checkout(self, S: int) -> Optional[_Slot]:
        """A free slot, one that has captured length ``S`` first; None
        when a new slot may be made (counted as made)."""
        with self._cv:
            while not self._free and self._made >= self.capacity:
                self._cv.wait()
            if not self._free:
                self._made += 1
                return None
            for i in range(len(self._free) - 1, -1, -1):
                if S in self._free[i].forwards:
                    return self._free.pop(i)
            return self._free.pop()

    def _checkin(self, slot: Optional[_Slot], ok: bool) -> None:
        with self._cv:
            keep = ok and not self._closed
            if keep:
                self._free.append(slot)
            else:
                self._made -= 1
            self._cv.notify()
        if not keep and slot is not None:
            self._release(slot)

    def _release(self, slot: _Slot) -> None:
        slot.release()
        with self._cv:
            self._indices.append(slot.index)

    def _new_slot(self) -> _Slot:
        with self._cv:
            index = self._indices.pop()
        try:
            capture = self._new_capture(index)
        except BaseException:
            with self._cv:
                self._indices.append(index)
            raise
        with capture.on_stream(after_current=False):
            params = params_class(self.model.cfg)(self.model.cfg,
                                                  device="meta")
            flats = {dtype: torch.empty(n, dtype=dtype, device=self.device)
                     for dtype, n in self._sizes.items()}
            params.load_state_dict(flat_views(self.layout, flats),
                                   strict=True, assign=True)
        host_tok = torch.zeros(1, dtype=torch.int32, pin_memory=self._pin)
        return _Slot(index, capture, params, flats, host_tok)

    def _capture(self, slot: _Slot, prompt: torch.Tensor,
                 host_prompt: torch.Tensor) -> _Forward:
        out: Dict[str, torch.Tensor] = {}

        def body() -> None:
            logits = self.model.logits(slot.params, prompt)[0, -1]
            out["logits"] = logits
            out["tok"] = torch.argmax(logits).to(torch.int32).view(1)

        with LaunchLog() as warm:
            body()
        with LaunchLog(capturing=True) as launches:
            graph = slot.capture.capture(body)
        with self._cv:
            self.captures += 1
            self.warmup_launches.merge(warm)
        return _Forward(graph, launches, prompt, host_prompt, out)

    # -- a call ------------------------------------------------------------------

    @torch.no_grad()
    def __call__(self, leaves, tokens: np.ndarray,
                 keep_logits: bool = False) -> CallResult:
        """Serve one call: ``leaves`` the parameters, packed as
        ``serve.HostLeaves`` packs them (``layout`` and ``flats``; leaves
        packed for another model raise), ``tokens`` a (1, S) int32
        prompt."""
        tokens = np.ascontiguousarray(tokens, dtype=np.int32)
        if tokens.ndim != 2 or tokens.shape[0] != 1:
            raise ValueError(f"prompt of shape {tokens.shape}: one (1, S)")
        S = tokens.shape[1]
        slot = self._checkout(S)
        ok = False
        try:
            if slot is None:
                slot = self._new_slot()
            result = self._run(slot, leaves, tokens, keep_logits)
            ok = True
            return result
        finally:
            self._checkin(slot, ok)

    def _run(self, slot: _Slot, leaves, tokens: np.ndarray,
             keep_logits: bool) -> CallResult:
        if leaves.layout != self.layout:
            raise ValueError("the leaves are packed for another model")
        S = tokens.shape[1]
        cap = slot.capture
        with cap.on_stream(after_current=False):
            fwd = slot.forwards.get(S)
            if fwd is None:
                prompt = torch.zeros((1, S), dtype=torch.int32,
                                     device=self.device)
                host_prompt = torch.zeros((1, S), dtype=torch.int32,
                                          pin_memory=self._pin)
            else:
                prompt, host_prompt = fwd.prompt, fwd.host_prompt
            with device_span("serve.param_h2d", event=cap.event,
                             always=True) as h2d:
                for dtype, buf in slot.flats.items():   # one copy a dtype
                    buf.copy_(leaves.flats[dtype], non_blocking=True)
                host_prompt.numpy()[...] = tokens
                prompt.copy_(host_prompt, non_blocking=True)
            capture_ms = 0.0
            if fwd is None:               # the warm-up's time is neither
                t0 = tclock.now()
                fwd = self._capture(slot, prompt, host_prompt)
                capture_ms = (tclock.now() - t0) * 1e3
                slot.forwards[S] = fwd
            with device_span("serve.call_forward", event=cap.event,
                             always=True) as forward:
                cancellation.checkpoint()
                fwd.graph.replay()
                fwd.launches.replay()
                slot.host_tok.copy_(fwd.out["tok"], non_blocking=True)
                logits = fwd.out["logits"].clone() if keep_logits else None
        with self._cv:
            self.replays += 1
        forward.end.synchronize()         # the token's copy back
        return CallResult(int(slot.host_tok[0]), h2d.read(), forward.read(),
                          capture_ms, logits)

    def close(self) -> None:
        """Free every idle slot now and each busy one when its call returns
        it; a call that comes after still runs, on a slot freed after it."""
        with self._cv:
            self._closed = True
            idle, self._free = self._free, []
            self._made -= len(idle)
        for slot in idle:
            self._release(slot)

    @property
    def slots(self) -> int:
        """The slots alive, busy or idle."""
        with self._cv:
            return self._made
