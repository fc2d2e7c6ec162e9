"""Shared helpers for the port's kernels: constants and backend dispatch.

Counterpart of ``repro.kernels.common``.  There the backend is a choice of
implementation (``xla``/``pallas``/``pallas_interpret``); here the tensor's
device decides:

  * a CPU tensor goes to the kernel package's plain PyTorch version
    (``ref.py``) — the CPU has no kernel to run;
  * a CUDA tensor goes to the hand-written CUDA kernel, or the wrapper
    raises: nothing falls back to the plain version on the card;
  * any other device raises.

``backend="torch"`` forces the plain version on any device.  It is an
explicit reference mode for tests and for the comparison phase of
``chip_smoke.py``; no default or command-line path sets it.

Host numpy operands carry no device of their own: the caller names one
(:func:`resolve_device`), the counterpart of ``resolve_backend``'s
accelerator choice in the reference.

Two more kinds of operand reach the wrappers in a traced or sharded step:

  * a *fake* tensor (``FakeTensorMode``) has a shape and no data: :func:`dispatch` sends it to the ``"fake"`` route, where
    the wrapper returns outputs of the kernel's shapes and dtypes with no
    launch, and reports the kernel's FLOPs and bytes (its package's
    ``ops.cost``) to the counters open on this thread
    (:func:`report_cost`, ``distributed/cost_analysis.py``);
  * a ``DTensor``: :func:`local_operands` checks that its placements make
    each rank's local computation the whole answer (batch or heads
    sharded, or everything replicated), hands the wrapper the local
    shards, and :func:`from_local` wraps the local outputs back.
"""
from __future__ import annotations

import threading

import torch

from repro_torch import cancellation

BACKENDS = ("auto", "torch")

NEG_INF = float(-1e30)   # large-negative instead of -inf: keeps bf16 softmax NaN-free


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # enum DType in csrc/common.cuh
HEAD_DIMS = (16, 32, 64, 128)                       # the kernels' D instances


def check_operands(what: str, *tensors: torch.Tensor) -> None:
    """What the CUDA kernels take: one CUDA device, contiguous, 16-byte
    aligned (they read rows with 16-byte loads)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operand of shape {tuple(t.shape)} "
                             f"is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: operand not 16-byte aligned")


_LOGS = threading.local()     # the launch logs open on this thread
_SHARED_LOGS: tuple = ()      # the launch logs open on every thread
_SHARED_LOCK = threading.Lock()
_N_OPEN = 0                   # launch logs open on any thread


class LaunchCounter:
    """Launches of one kernel by this process, in all and by a key the
    wrapper names (a kernel with several shapes on one path counts each).
    The runtime's executor threads call the wrappers concurrently, so the
    count is taken under a lock (``n += 1`` alone is a read-modify-write
    that loses counts).  A launch made while this thread captures a CUDA
    graph (inside a capturing :class:`LaunchLog`) is not counted then:
    the log adds it at each replay of the graph.  A log opened with
    ``all_threads`` sees the launches of every thread: autograd runs a
    CUDA backward (a remat recompute's kernels) on a thread of its own."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0
        self._by_key: dict = {}

    def add(self, key=None) -> None:
        logs = getattr(_LOGS, "open", ()) + _SHARED_LOGS
        for log in logs:
            log._record(self, key)
        if not any(log.capturing for log in logs):
            self._add(key, 1)

    def _add(self, key, n: int) -> None:
        with self._lock:
            self._n += n
            if key is not None:
                self._by_key[key] = self._by_key.get(key, 0) + n

    def reset(self) -> None:
        with self._lock:
            self._n = 0
            self._by_key = {}

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def by_key(self) -> dict:
        """The launches counted under each key since the last reset."""
        with self._lock:
            return dict(self._by_key)


class LaunchLog:
    """The kernel launches this thread's wrappers make inside ``with log:``,
    by counter and key.

    With ``capturing`` (the body of a CUDA graph's capture) a launch is
    recorded, not run, so it reaches no counter's total then;
    :meth:`replay` adds the recorded launches once, by key, and is called
    once per replay of the graph.  Without it (an eager warm-up) the
    launches count as usual, and the log keeps a tally of its own.

    With ``all_threads`` the log takes the launches of every thread of the
    process while it is open (a train step's capture, whose backward runs
    on autograd's device thread); a log without it, this thread's only
    (a serving slot's capture, beside executors that launch eagerly).
    A capturing log on every thread must be the only launcher in the
    process: another thread's eager launch would be counted into the
    graph's replays instead of its own.  So it refuses to open while any
    other log is open, and no log opens while it is open; an eager launch
    on another thread without a log is not detected."""

    def __init__(self, capturing: bool = False,
                 all_threads: bool = False) -> None:
        self.capturing = capturing
        self.all_threads = all_threads
        self._n: dict = {}          # (counter, key) -> launches
        self._lock = threading.Lock()

    def __enter__(self) -> "LaunchLog":
        global _SHARED_LOGS, _N_OPEN
        with _SHARED_LOCK:
            if any(log.capturing for log in _SHARED_LOGS) or (
                    self.capturing and self.all_threads and _N_OPEN):
                raise RuntimeError("a capture that logs every thread's "
                                   "launches must be the only launch log "
                                   "open in the process")
            _N_OPEN += 1
            if self.all_threads:
                _SHARED_LOGS = (*_SHARED_LOGS, self)
        if not self.all_threads:
            _LOGS.open = (*getattr(_LOGS, "open", ()), self)
        return self

    def __exit__(self, *exc) -> None:
        global _SHARED_LOGS, _N_OPEN
        with _SHARED_LOCK:
            _N_OPEN -= 1
            if self.all_threads:
                _SHARED_LOGS = tuple(log for log in _SHARED_LOGS
                                     if log is not self)
        if not self.all_threads:
            _LOGS.open = tuple(log for log in _LOGS.open if log is not self)

    def _record(self, counter: LaunchCounter, key) -> None:
        with self._lock:
            self._n[(counter, key)] = self._n.get((counter, key), 0) + 1

    def replay(self) -> None:
        for (counter, key), n in self._n.items():
            counter._add(key, n)

    def merge(self, other: "LaunchLog") -> None:
        """Add ``other``'s tally to this log's (no counter moves).  A log
        shared by threads is merged into under the caller's lock."""
        for k, n in other._n.items():
            self._n[k] = self._n.get(k, 0) + n

    def count(self, counter: LaunchCounter) -> int:
        """The launches of ``counter``'s kernel in the log, all keys."""
        return sum(n for (c, _), n in self._n.items() if c is counter)

    def by_key(self, counter: LaunchCounter) -> dict:
        """The launches of ``counter``'s kernel in the log, by key (as
        :meth:`LaunchCounter.by_key`, which leaves out ``None``)."""
        return {k: n for (c, k), n in self._n.items()
                if c is counter and k is not None}


def refuse_grad(what: str, roadmap: str, *tensors: torch.Tensor) -> None:
    """Raise for a CUDA call that autograd would need a backward for: the
    kernel has none on the card yet (``roadmap`` names the entry that
    brings one), and a call that gave no gradient would train silently
    wrong."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: the kernel has no backward on the card yet (ROADMAP "
            f"{roadmap!r}); call it under torch.no_grad()")


def resolve_device(device) -> torch.device:
    """The device a runtime or state tier was asked for: ``cuda`` (which
    must exist) or ``cpu``; anything else raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "(--device cpu) to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: use cuda or cpu "
                         f"(--device cuda|cpu)")
    return dev


def dispatch(backend: str | None, x: torch.Tensor) -> str:
    """``"torch"`` (plain version), ``"cuda"`` (the kernel) or ``"fake"``
    (the kernel's shapes, no launch: ``x`` has no data) for ``x``.

    Every kernel wrapper passes through here, which makes it the
    time-sliced cancellation checkpoint for long compute loops, as
    ``repro.kernels.common.resolve_backend`` is.  A CUDA graph's replay
    runs no wrapper, so the code that replays one calls the checkpoint
    itself, once per replay (``launch/step_graphs.py``)."""
    cancellation.checkpoint()
    b = backend or "auto"
    if b not in BACKENDS:
        raise ValueError(f"backend {b!r} not in {BACKENDS}")
    if b == "torch":
        return "torch"
    if is_fake(x):
        return "fake"
    if x.device.type == "cpu":
        return "torch"
    if x.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel for tensors on {x.device}; "
                     f"use a CUDA or CPU tensor")


# -- fake tensors: shapes without data ---------------------------------------

def is_fake(x: torch.Tensor) -> bool:
    """A ``FakeTensor`` (``FakeTensorMode``): a shape on a device, no data.
    A tensor on the meta device is not one: it names no device, and
    :func:`dispatch` refuses it."""
    if type(x) is torch.Tensor or type(x) is torch.nn.Parameter:
        return False
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


_COST_SINKS = threading.local()      # the cost counters open on this thread


def open_cost_sink(sink) -> None:
    """Add ``sink`` (it has ``kernel(name, flops, nbytes)``) to this
    thread's open counters; :func:`close_cost_sink` removes it."""
    _COST_SINKS.open = (*getattr(_COST_SINKS, "open", ()), sink)


def close_cost_sink(sink) -> None:
    _COST_SINKS.open = tuple(s for s in getattr(_COST_SINKS, "open", ())
                             if s is not sink)


def report_cost(name: str, flops: float, nbytes: float) -> None:
    """A fake-route call of kernel ``name``: its FLOPs and bytes by its
    package's ``ops.cost``, for every counter open on this thread.  No
    launch is counted."""
    for sink in getattr(_COST_SINKS, "open", ()):
        sink.kernel(name, flops, nbytes)


# -- DTensor operands -----------------------------------------------------------

def as_dtensor(x):
    """``x`` if it is a ``DTensor``, else None (a plain tensor never
    imports ``torch.distributed``)."""
    if type(x) is torch.Tensor or type(x) is torch.nn.Parameter:
        return None
    from torch.distributed.tensor import DTensor
    return x if isinstance(x, DTensor) else None


def local_operands(what: str, operands, batch_dims, head_dims, seq_dims=()):
    """The local shards of a kernel's ``DTensor`` operands, where each
    rank's local computation is the whole answer for its shard.

    ``batch_dims[i]`` and ``head_dims[i]`` name operand i's batch and head
    dims (None where it has none); ``seq_dims[i]`` its key/cache sequence
    dim.  On each mesh dim every operand must be:

      * replicated (every rank computes the same thing), or
      * sharded on its batch dim (operands without one replicated), or
      * sharded on its head dim; key/value operands replicated there while
        the queries are sharded by heads (fewer KV heads than ranks, GQA)
        are sliced to the KV heads the rank's query heads read.

    An operand held whole on a mesh dim that another operand's shards
    split takes its gradient back as a partial sum over that dim (each
    rank's share, from its own rows or heads).

    A key/value operand sharded along its sequence is all-gathered on that
    mesh dim first (sequence-parallel attention is not computed shard by
    shard).  Anything else raises, naming the placement.  Returns (local
    tensors, the mesh, the first operand's placements), or None when no
    operand is a ``DTensor``."""
    dts = [as_dtensor(x) for x in operands]
    if not any(d is not None for d in dts):
        return None
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = next(d for d in dts if d is not None).device_mesh
    if any(d is None for d in dts):
        raise ValueError(f"{what}: DTensor and plain operands mixed")
    seq = dict(enumerate(seq_dims)) if seq_dims else {}
    ops = list(dts)
    for i, d in enumerate(ops):            # gather sequence shards first
        s = seq.get(i)
        pl = list(d.placements)
        if s is not None and any(isinstance(p, Shard) and p.dim == s
                                 for p in pl):
            ops[i] = d.redistribute(mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == s else p
                for p in pl])
    slices = {}                  # operand -> (mesh dim, its size, group G)
    for m in range(mesh.ndim):
        pls = [d.placements[m] for d in ops]
        for i, p in enumerate(pls):
            if isinstance(p, Partial) or not isinstance(p, (Shard, Replicate)):
                raise ValueError(f"{what}: operand {i} is {p} on mesh dim "
                                 f"{m}; the kernel takes Shard or Replicate")
        shard = [p.dim if isinstance(p, Shard) else None for p in pls]
        if all(s is None for s in shard):
            continue
        if all(s == b for s, b in zip(shard, batch_dims)
               if s is not None or b is not None):
            continue
        if all(s == h for s, h in zip(shard, head_dims)
               if s is not None or h is not None):
            continue
        # queries sharded by heads, some key/value operands replicated
        if shard[0] is not None and shard[0] == head_dims[0] and all(
                s is None or s == h for s, h in zip(shard, head_dims)):
            n = mesh.size(m)
            H = ops[0].shape[head_dims[0]]
            for i, (s, h) in enumerate(zip(shard, head_dims)):
                if s is None and h is not None and i:
                    K = ops[i].shape[h]
                    Hl, G = H // n, H // K
                    if Hl % G and G % Hl or i in slices:
                        raise ValueError(
                            f"{what}: {H} query heads over {n} ranks do not "
                            f"split into whole KV groups of {G} on one mesh "
                            f"dim")
                    slices[i] = (m, n, G)
            continue
        raise ValueError(f"{what}: placements {[d.placements for d in ops]} "
                         f"on mesh dim {m} shard neither the batch nor the "
                         f"heads of every operand")
    # an operand held whole on a mesh dim that splits the computation
    # gets back a partial sum there: its rank's share of the gradient
    split = {m for m in range(mesh.ndim)
             if any(isinstance(d.placements[m], Shard) for d in ops)}
    locs = []
    for i, d in enumerate(ops):
        grad_pl = [Partial() if m in split and isinstance(p, Replicate)
                   else p for m, p in enumerate(d.placements)]
        t = d.to_local(grad_placements=grad_pl)
        if i not in slices:
            locs.append(t)
            continue
        m, n, G = slices[i]
        Hl, c = ops[0].shape[head_dims[0]] // n, mesh.get_coordinate()[m]
        first, last = c * Hl // G, ((c + 1) * Hl - 1) // G
        locs.append(t.narrow(head_dims[i], first, last - first + 1))
    return locs, mesh, ops[0].placements


def batch_only(x, *dims):
    """A ``DTensor`` with every shard off ``dims`` (its batch dim, and any
    dim a computation is local in, as a depthwise convolution is in its
    channels) gathered; ``x`` as it is if it is plain or has none."""
    d = as_dtensor(x)
    if d is None:
        return x
    from torch.distributed.tensor import Replicate, Shard
    want = [p if not isinstance(p, Shard) or p.dim in dims
            else Replicate() for p in d.placements]
    return d if want == list(d.placements) else d.redistribute(
        d.device_mesh, want)


def from_local(t: torch.Tensor, mesh, placements, shape) -> torch.Tensor:
    """A kernel's local output as a ``DTensor`` of global ``shape`` with
    ``placements`` (made contiguous, as its global strides say; no check
    across ranks)."""
    from torch.distributed.tensor import DTensor
    t = t.contiguous()
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))
