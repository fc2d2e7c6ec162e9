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
"""
from __future__ import annotations

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


def dispatch(backend: str | None, x: torch.Tensor) -> str:
    """``"torch"`` (plain version) or ``"cuda"`` (the kernel) for ``x``.

    Every kernel wrapper passes through here, which makes it the
    time-sliced cancellation checkpoint for long compute loops, as
    ``repro.kernels.common.resolve_backend`` is."""
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
