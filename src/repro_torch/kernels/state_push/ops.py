"""Wrappers for the fused state push (kernels K1–K4), for values of any shape.

Counterpart of ``repro.kernels.state_push.ops``.  Values are flattened to
f32 and padded to (rows, 128); the pad region quantises to zero delta, so
applying a padded push is a no-op on the pad.

Where each operand goes:

* **torch tensors** go by their own device (``kernels.common.dispatch``):
  a CPU tensor to the plain version in :mod:`.ref`, a CUDA tensor to the
  kernels of ``csrc/state_push.cu``, or an error.  An encode returns the
  wire buffers (codes, scales) as host numpy and keeps the error-feedback
  residual on the operands' device: the device replica owns that debt.
* **host numpy operands** carry no device, so the caller names one.  On
  ``device="cuda"`` (the default) they are copied to the card, encoded there
  in one shot and the results come back as numpy — the reference's Pallas
  branch.  On ``device="cpu"`` the encodes take the numpy host codec
  (:mod:`.hostcodec`), as on the reference's ``xla`` backend; the other
  entry points run the plain version on the CPU.

``backend="torch"`` forces the plain version (tests and ``chip_smoke.py``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.common import (LaunchCounter, cdiv, check_operands,
                                        dispatch)
from repro_torch.kernels.state_push import hostcodec
from repro_torch.kernels.state_push import ref as _ref

LANES = 128
FP8_MAX = _ref.FP8_MAX

# launches of each kernel (chip_smoke reads them); K1 and K4 share one
# source but count apart
LAUNCHES = {"quantize_delta": LaunchCounter(), "quantize_fp8": LaunchCounter(),
            "apply_delta": LaunchCounter(), "push": LaunchCounter()}

_P = ctypes.c_void_p
_QUANT_ARGS = [_P] * 5 + [ctypes.c_int, ctypes.c_float, ctypes.c_int, _P]
_APPLY_ARGS = [_P] * 4 + [ctypes.c_int, ctypes.c_int, _P]
_PUSH_ARGS = [_P] * 4 + [ctypes.c_int, _P]


# -- operands ------------------------------------------------------------------

def _to_rows(x: torch.Tensor):
    """Flatten to f32 and zero-pad to whole 128-lane rows: ((R,128), numel)."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    rows = max(1, cdiv(n, LANES))
    if rows * LANES != n:
        flat = F.pad(flat, (0, rows * LANES - n))
    return flat.contiguous().view(rows, LANES), n


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``a`` (e4m3fn codes as torch's float8 type)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = np.array(a)              # torch.from_numpy wants writable memory
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _on(x, device) -> torch.Tensor:
    """``x`` as a tensor on ``device`` (numpy arrays are copied there)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return _from_numpy(np.asarray(x)).to(device)


def _f32(x):
    """Numpy operands of an encode as f32 (the rows are f32 either way)."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _host(x: torch.Tensor) -> np.ndarray:
    """A tensor's values as host numpy (e4m3fn as ``ml_dtypes``' type)."""
    x = x.detach().cpu()
    if x.dtype == torch.float8_e4m3fn:
        return x.view(torch.uint8).numpy().view(hostcodec.fp8_dtype())
    return x.numpy()


def _device_of(x, device) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device(device)


def _host_codec(x, backend, device) -> bool:
    """Numpy operands on the CPU: the host codec's case."""
    return (not isinstance(x, torch.Tensor)
            and torch.device(device).type == "cpu"
            and (backend or "auto") == "auto")


# -- the kernels, on (R, 128) f32 rows ------------------------------------------

def _check_rows(what: str, *xs: torch.Tensor) -> None:
    shape = xs[0].shape
    for x in xs:
        if x.dim() != 2 or x.shape[1] != LANES or x.shape != shape:
            raise ValueError(f"{what}: rows must be (R, {LANES}) alike, got "
                             f"{[tuple(t.shape) for t in xs]}")
    check_operands(what, *xs)


def quantize_rows(lr: torch.Tensor, br: torch.Tensor | None = None, *,
                  qmax: float = 127.0, fp8: bool = False,
                  with_residual: bool = False, backend: str | None = None):
    """K1 (``fp8=False``) or K4 on (R, 128) f32 rows; ``br=None`` is a zero
    base.  Returns ``(q (R,128) int8 | float8_e4m3fn, scales (R,1) f32,
    residual (R,128) f32 | None)`` on the rows' device."""
    if dispatch(backend, lr) == "torch":
        q, s = (_ref.quantize_fp8_ref(lr, br) if fp8
                else _ref.quantize_delta_ref(lr, br, float(qmax)))
        resid = _ref.residual_ref(lr, br, q, s) if with_residual else None
        return q, s, resid
    return _quantize_cuda(lr, br, float(qmax), fp8, with_residual)


def _quantize_cuda(lr, br, qmax, fp8, with_residual):
    what = "quantize_fp8" if fp8 else "quantize_delta"
    ins = (lr,) if br is None else (lr, br)
    if any(x.dtype != torch.float32 for x in ins):
        raise ValueError(f"{what}: rows must be float32")
    _check_rows(what, *ins)
    R = lr.shape[0]
    q = torch.empty((R, LANES), device=lr.device,
                    dtype=torch.float8_e4m3fn if fp8 else torch.int8)
    s = torch.empty((R, 1), dtype=torch.float32, device=lr.device)
    resid = torch.empty_like(lr) if with_residual else None
    fn = _build.function("state_push", "state_push_quantize", _QUANT_ARGS)
    rc = fn(lr.data_ptr(), None if br is None else br.data_ptr(), q.data_ptr(),
            s.data_ptr(), None if resid is None else resid.data_ptr(), R,
            FP8_MAX if fp8 else qmax, int(fp8),
            torch.cuda.current_stream(lr.device).cuda_stream)
    _build.check("state_push", rc)
    LAUNCHES[what].add()
    return q, s, resid


def apply_rows(gr: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, *,
               backend: str | None = None) -> torch.Tensor:
    """K2: ``gr + q·scales`` on (R, 128) f32 rows into a new tensor (never
    in place); q holds int8 or e4m3fn codes."""
    if dispatch(backend, gr) == "torch":
        return _ref.apply_delta_ref(gr, q, scales)
    return _apply_cuda(gr, q, scales)


def _apply_cuda(gr, q, scales):
    if gr.dtype != torch.float32 or scales.dtype != torch.float32 or \
            q.dtype not in (torch.int8, torch.float8_e4m3fn):
        raise ValueError(f"apply_delta: dtypes {gr.dtype}, {q.dtype}, "
                         f"{scales.dtype}")
    if q.shape != gr.shape or tuple(scales.shape) != (gr.shape[0], 1):
        raise ValueError(f"apply_delta: rows {tuple(gr.shape)}, codes "
                         f"{tuple(q.shape)}, scales {tuple(scales.shape)}")
    _check_rows("apply_delta", gr)
    check_operands("apply_delta", gr, q, scales)
    out = torch.empty_like(gr)
    fn = _build.function("state_push", "state_push_apply", _APPLY_ARGS)
    rc = fn(gr.data_ptr(), q.data_ptr(), scales.data_ptr(), out.data_ptr(),
            gr.shape[0], int(q.dtype == torch.float8_e4m3fn),
            torch.cuda.current_stream(gr.device).cuda_stream)
    _build.check("state_push", rc)
    LAUNCHES["apply_delta"].add()
    return out


def push_rows(lr: torch.Tensor, br: torch.Tensor, gr: torch.Tensor, *,
              backend: str | None = None) -> torch.Tensor:
    """K3: ``gr + (lr − br)`` on (R, 128) f32 rows into a new tensor."""
    if dispatch(backend, lr) == "torch":
        return _ref.push_ref(lr, br, gr)
    return _push_cuda(lr, br, gr)


def _push_cuda(lr, br, gr):
    if any(x.dtype != torch.float32 for x in (lr, br, gr)):
        raise ValueError("push: rows must be float32")
    _check_rows("push", lr, br, gr)
    out = torch.empty_like(gr)
    fn = _build.function("state_push", "state_push_push", _PUSH_ARGS)
    rc = fn(lr.data_ptr(), br.data_ptr(), gr.data_ptr(), out.data_ptr(),
            lr.shape[0], torch.cuda.current_stream(lr.device).cuda_stream)
    _build.check("state_push", rc)
    LAUNCHES["push"].add()
    return out


# -- entry points (those of repro.kernels.state_push.ops) -----------------------

def _encode(eff, base, *, qmax, fp8, backend, device, with_residual):
    dev = _device_of(eff, device)
    lr, n = _to_rows(_on(_f32(eff), dev))
    br = None if base is None else _to_rows(_on(_f32(base), dev))[0]
    q, s, resid = quantize_rows(lr, br, qmax=qmax, fp8=fp8,
                                with_residual=with_residual, backend=backend)
    if resid is not None:
        resid = resid.reshape(-1)[:n]
        if not isinstance(eff, torch.Tensor):
            resid = _host(resid)
    return _host(q), _host(s), n, resid


def encode_quant(eff, base, *, qmax: int = 127, backend: str | None = None,
                 device="cuda", with_residual: bool = True):
    """Fused wire encode for the integer tiers: quantise ``eff − base``
    (``base=None``: zero base) to signed codes in ``[-qmax, qmax]`` and
    (optionally) the error-feedback residual, in one pass.  Returns
    ``(q int8 (R,128), scales f32 (R,1), numel, residual (numel,) | None)``:
    codes and scales as host numpy; the residual as numpy for numpy
    operands and as a tensor on the operands' device for tensors."""
    if _host_codec(eff, backend, device) and \
            (base is None or hostcodec.usable(eff, base)):
        q, s, n, resid = hostcodec.encode_quant(np.asarray(eff), base,
                                                qmax=qmax)
        return q, s, n, (resid if with_residual else None)
    return _encode(eff, base, qmax=float(qmax), fp8=False, backend=backend,
                   device=device, with_residual=with_residual)


def encode_fp8(eff, base, *, backend: str | None = None, device="cuda",
               with_residual: bool = True):
    """fp8 (e4m3fn) twin of :func:`encode_quant` — same operand routing.
    The host codes need ``ml_dtypes`` (``hostcodec.fp8_dtype``)."""
    if _host_codec(eff, backend, device) and \
            (base is None or hostcodec.usable(eff, base)):
        q, s, n, resid = hostcodec.encode_fp8(np.asarray(eff), base)
        return q, s, n, (resid if with_residual else None)
    return _encode(eff, base, qmax=FP8_MAX, fp8=True, backend=backend,
                   device=device, with_residual=with_residual)


def quantize_delta(local, base, *, backend: str | None = None,
                   qmax: int = 127, device="cuda"):
    """Any-shape fused delta quantisation.  Returns (q (R,128) int8, scales
    (R,1), original_numel) — the wire format of a compressed push — as
    numpy for numpy operands, as tensors for tensors."""
    if _host_codec(local, backend, device) and hostcodec.usable(local, base):
        q, s, n, _ = hostcodec.encode_quant(local, base, qmax=qmax)
        return q, s, n
    dev = _device_of(local, device)
    lr, n = _to_rows(_on(_f32(local), dev))
    br, _ = _to_rows(_on(_f32(base), dev))
    q, s, _ = quantize_rows(lr, br, qmax=float(qmax), backend=backend)
    if isinstance(local, torch.Tensor):
        return q, s, n
    return _host(q), _host(s), n


def dequantize(q, scales, numel: int):
    """Decode a wire tuple back to the flat f32 delta of length ``numel``.

    The pad region (rows*128 − numel) quantises to zero-delta, so the trim
    here drops only zeros."""
    if isinstance(q, np.ndarray) and isinstance(scales, np.ndarray):
        return hostcodec.decode_rows(q, scales, numel)
    return (q.to(torch.float32) * scales).reshape(-1)[:numel]


def wire_nbytes(q, scales) -> int:
    """Bytes the compressed push actually moves: int8 payload + f32 scales."""
    return _numel(q) + _numel(scales) * 4


def _numel(x) -> int:
    return int(x.numel()) if isinstance(x, torch.Tensor) else int(np.size(x))


def _apply_wire(value, q, scales, backend, device):
    """Shared decode/apply: ``value + q·scale`` (any shape), one fused pass,
    into a new value.  The single home of the wire-apply dispatch for both
    directions — :func:`apply_delta` (push: global buffer) and
    :func:`apply_pull` (pull/broadcast: replica or device value)."""
    dev = _device_of(value, device)
    v = _on(value, dev)
    gr, n = _to_rows(v)
    out = apply_rows(gr, _on(q, dev), _on(scales, dev).to(torch.float32),
                     backend=backend)
    out = out.reshape(-1)[:n].reshape(v.shape).to(v.dtype)
    return out if isinstance(value, torch.Tensor) else _host(out)


def apply_delta(global_val, q, scales, *, backend: str | None = None,
                device="cuda"):
    """Apply a compressed push to a value of any shape."""
    return _apply_wire(global_val, q, scales, backend, device)


def encode_pull(new, base, *, backend: str | None = None, device="cuda"):
    """Pull-direction encode: quantise ``new − base`` (the delta a warm
    replica at ``base`` needs to catch up to ``new``) with the same fused
    quantise kernel the push wire uses.  Returns the ``(q, scales, numel)``
    wire tuple — the symmetric twin of :func:`quantize_delta`."""
    return quantize_delta(new, base, backend=backend, device=device)


def apply_pull(value, q, scales, *, backend: str | None = None,
               device="cuda"):
    """Pull-direction decode/apply: ``replica + q·scale`` (any shape).

    Applies a pulled (or peer-broadcast) wire tuple onto a replica value —
    host- or device-resident — in one fused pass, returning a new value;
    the pad region quantises to zero-delta so the trim is a no-op beyond
    ``numel``.  Same kernel as :func:`apply_delta`, dispatched from the
    opposite side of the tier boundary."""
    return _apply_wire(value, q, scales, backend, device)


def push(local, base, global_val, *, backend: str | None = None,
         device="cuda"):
    """Uncompressed fused push: global + (local − base) (any shape), into a
    new value."""
    dev = _device_of(global_val, device)
    g = _on(global_val, dev)
    lr, n = _to_rows(_on(_f32(local), dev))
    br, _ = _to_rows(_on(_f32(base), dev))
    gr, _ = _to_rows(g)
    out = push_rows(lr, br, gr, backend=backend)
    out = out.reshape(-1)[:n].reshape(g.shape).to(g.dtype)
    return out if isinstance(global_val, torch.Tensor) else _host(out)
