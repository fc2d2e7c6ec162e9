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


class LaunchCounter:
    """Launches of one kernel by this process, in all and by a key the
    wrapper names (a kernel with several shapes on one path counts each).
    The runtime's executor threads call the wrappers concurrently, so the
    count is taken under a lock (``n += 1`` alone is a read-modify-write
    that loses counts).  A launch made while this thread captures a CUDA
    graph (inside a capturing :class:`LaunchLog`) is not counted then:
    the log adds it at each replay of the graph."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0
        self._by_key: dict = {}

    def add(self, key=None) -> None:
        logs = getattr(_LOGS, "open", ())
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
    launches count as usual, and the log keeps a tally of its own."""

    def __init__(self, capturing: bool = False) -> None:
        self.capturing = capturing
        self._n: dict = {}          # (counter, key) -> launches

    def __enter__(self) -> "LaunchLog":
        _LOGS.open = (*getattr(_LOGS, "open", ()), self)
        return self

    def __exit__(self, *exc) -> None:
        _LOGS.open = tuple(log for log in _LOGS.open if log is not self)

    def _record(self, counter: LaunchCounter, key) -> None:
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
    """``"torch"`` (plain version) or ``"cuda"`` (the kernel) for ``x``.

    Every kernel wrapper passes through here, which makes it the
    time-sliced cancellation checkpoint for long compute loops, as
    ``repro.kernels.common.resolve_backend`` is.  A CUDA graph's replay
    runs no wrapper, so the code that replays one calls the checkpoint
    itself, once per replay (``launch/step_graphs.py``)."""
    cancellation.checkpoint()
    b = backend or "auto"
    if b not in BACKENDS:
        raise ValueError(f"backend {b!r} not in {BACKENDS}")
    if b == "torch" or x.device.type == "cpu":
        return "torch"
    if x.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel for tensors on {x.device}; "
                     f"use a CUDA or CPU tensor")
