"""The train step, captured once as a CUDA graph and then replayed.

Counterpart of ``jax.jit(step_fn)`` in ``repro.launch.steps`` and of the
``@jax.jit`` train steps of ``repro.launch.train`` and
``examples/train_lm.py``: the reference compiles its step once and then
calls the compiled program; here the step's kernels are recorded once on
the card, and every later step is one copy of the batch into static
buffers and one replay.  The training counterpart of
``launch/step_graphs.py``, on one device (the sharded step, ``DTensor``s
on a mesh, stays eager).

:class:`GraphedTrainStep` wraps an eager step, ``step(params, opt_state,
batch) -> (params, opt_state, out)`` that updates the parameters and the
optimizer's per-parameter state in place (``make_train_step``'s, or the
example's), ``out`` a tensor or a dict of tensors (``loss``,
``aux_loss``, ``grad_norm``).  Its first call runs the step eagerly on the
capture stream: the warm-up, which builds and loads the kernels and gives
cuBLAS and autograd's device thread their state for that stream.  The
second call captures the step on the parameters and state it is handed,
so a checkpoint restored before the loop is the one recorded, and replays
it; every later call replays.  The parameters and the state's modules are
the graph's own, updated in place by the recorded update; a state field
the step returns anew (``SGDState.step``, the counter that
``warmup_cosine`` reads on the card) is copied back into the captured
one inside the graph.  ``out`` comes back as copies of the graph's static
outputs, so a list of losses keeps one value a step.  The microbatch loop
of ``optim/grad_accum.py`` is Python, so it is recorded unrolled.

Launch counts: the capture's launches, those of autograd's device thread
(the remat recompute) among them, are recorded in a
:class:`~repro_torch.kernels.common.LaunchLog` open on every thread and
added once per replay, so the counters read as after the eager step.

Device spans: the step's own (``train.forward``, ``train.backward``,
``train.flash_bwd``, ``train.update``) are recorded into the graph by a
:class:`~repro_torch.telemetry.device.SpanRecorder` open over the capture
(on every thread), and each armed replay re-times them: a call reads the
previous armed replay's spans before it replays, and a scrape of the
registry reads the last one's, after :meth:`GraphedTrainStep.close` too.

A parameter's gradient accumulator keeps the stream it was made on, so
nothing may hold a tensor that autograd ties to a parameter (a
``p.cpu()`` without ``detach()``) from the caller's stream across the
capture: autograd would make that stream wait on the capture, which
fails it.  Any failure of the warm-up, the capture or a replay raises;
nothing runs the eager step instead.  The CPU runs the eager step (:func:`for_device`)
and builds no graph.
"""
from __future__ import annotations

import gc
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from repro_torch.kernels.common import LaunchLog, resolve_device
from repro_torch.launch.step_graphs import CudaCapture, sync
from repro_torch.telemetry import clock as tclock
from repro_torch.telemetry.device import SpanRecorder


def written(params: nn.Module, state) -> List[torch.Tensor]:
    """The tensors a train step writes in place: every parameter, then each
    field of the optimizer state (a tensor, or a module's parameters)."""
    out = list(params.parameters())
    for field in state:
        if isinstance(field, torch.Tensor):
            out.append(field)
        elif isinstance(field, nn.Module):
            out.extend(field.parameters())
    return out


def _copied(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return {k: v.clone() for k, v in out.items()}


class GraphedTrainStep:
    """``step`` (see the module docstring) captured on ``device`` at its
    second call and replayed from then on.  ``capture`` records the graph
    (:class:`~repro_torch.launch.step_graphs.CudaCapture` by default; a
    test hands in a stand-in with its ``on_stream``, ``capture`` and
    ``event``, the timing events of the step's spans).

    After the capture: ``launches``, the log of the kernels one replay
    launches; ``warmup_launches``, the eager warm-up's; ``capture_ms``,
    the host's time to capture (the allocator's cache emptied first);
    ``spans``, the recorder of the device spans captured in the step;
    ``replays``, the replays so far."""

    def __init__(self, step: Callable, device="cuda", *,
                 capture: Optional[CudaCapture] = None) -> None:
        device = resolve_device(device)
        if capture is None:
            if device.type != "cuda":
                raise ValueError("CUDA graphs need the card; on the CPU call "
                                 "the eager step")
            capture = CudaCapture(device)
        self.step, self.device, self._capture = step, device, capture
        self.graph = None
        self.launches: Optional[LaunchLog] = None
        self.warmup_launches: Optional[LaunchLog] = None
        self.capture_ms: Optional[float] = None
        self.spans: Optional[SpanRecorder] = None
        self.replays = 0
        self.closed = False
        self.params = self.state = self.batch = self.out = None

    def __call__(self, params, state, batch: Dict[str, Any]):
        if self.closed:
            raise RuntimeError("this captured train step was closed; call "
                               "its eager step (.step) or a new one")
        if self.warmup_launches is None:
            return self._warmup(params, state, batch)
        if self.graph is None:
            self._record(params, state, batch)
        elif params is not self.params or state is not self.state:
            raise ValueError("a captured train step replays on the "
                             "parameters and state it captured; pass what "
                             "it returned")
        else:
            self._load(batch)
        self.spans.replaying()
        t0 = tclock.now()
        self.graph.replay()
        self.spans.replayed(t0, step=self.replays)
        self.launches.replay()
        self.replays += 1
        return self.params, self.state, _copied(self.out)

    def _warmup(self, params, state, batch):
        """One eager step on the capture stream; the caller's stream then
        waits for it, and the host too (the batch's memory belongs to the
        caller's stream)."""
        with LaunchLog(all_threads=True) as log, self._capture.on_stream():
            out = self.step(params, state, batch)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).wait_stream(
                self._capture.stream)
            sync(self.device)
        self.warmup_launches = log
        return out

    def _record(self, params, state, batch: Dict[str, Any]) -> None:
        """Capture the step on ``params``, ``state`` and static copies of
        ``batch``'s tensors."""
        self.params, self.state = params, state
        self.batch = {k: v.clone() for k, v in batch.items()}
        if self.device.type == "cuda":
            # the warm-up's blocks sit in the allocator's cache, and the
            # graph's pool needs blocks of its own: one thread trains
            sync(self.device)
            gc.collect()
            torch.cuda.empty_cache()
        t0 = tclock.now()
        spans = SpanRecorder(self._capture.event)
        with LaunchLog(capturing=True, all_threads=True) as log, spans:
            self.graph = self._capture.capture(self._body)
        sync(self.device)
        self.capture_ms = (tclock.now() - t0) * 1e3
        self.launches, self.spans = log, spans

    def _body(self) -> None:
        params, state, out = self.step(self.params, self.state, self.batch)
        if self.out is None:              # the capture: the static outputs
            self.out = out
        elif isinstance(out, torch.Tensor):   # a run of the body again (a
            self.out.copy_(out)               # stand-in's replay) writes them
        else:
            for k, v in out.items():
                self.out[k].copy_(v)
        if params is not self.params:
            raise RuntimeError("the train step returned new parameters; a "
                               "captured step updates them in place")
        with torch.no_grad():
            for old, new in zip(self.state, state):
                if new is old:
                    continue
                if not (isinstance(old, torch.Tensor)
                        and isinstance(new, torch.Tensor)
                        and old.shape == new.shape
                        and old.dtype == new.dtype):
                    raise RuntimeError("the train step returned a new "
                                       "optimizer state module; a captured "
                                       "step updates it in place")
                old.copy_(new)

    def _load(self, batch: Dict[str, Any]) -> None:
        """Copy ``batch`` into the static buffers (same keys and shapes)."""
        if batch.keys() != self.batch.keys():
            raise ValueError(f"batch of {sorted(batch)}: the step was "
                             f"captured for {sorted(self.batch)}")
        for k, v in batch.items():
            if v.shape != self.batch[k].shape:
                raise ValueError(f"batch[{k!r}] of shape {tuple(v.shape)}: "
                                 f"the step was captured for "
                                 f"{tuple(self.batch[k].shape)}")
            self.batch[k].copy_(v)

    def close(self) -> None:
        """Free the graph and so the memory of its pool.  The step is done
        with: a later call raises (PyTorch refuses a capture into a pool
        whose graphs were all reset), and ``step`` stays the eager step.
        The last armed replay's spans stay for a scrape to read."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.out = self.batch = None
        self.closed = True


def for_device(step: Callable, device) -> Callable:
    """The train step the launchers run on ``device``: on the card the
    captured step, on the CPU ``step`` itself."""
    device = resolve_device(device)
    if device.type == "cuda":
        return GraphedTrainStep(step, device)
    return step
