"""Plain PyTorch versions of the fused two-tier state push (Faasm §4.2).

Counterpart of ``repro.kernels.state_push.ref``.  A push moves
``delta = local - base`` from the local tier to the global tier; the
compressed variant quantises the delta with one f32 scale per 128-lane row.
These run the CPU path and are what the CUDA kernels (``csrc/state_push.cu``)
are held against on the card.

Divisions by ``qmax`` divide by a tensor on the operand's device: a Python
scalar divisor lets PyTorch's CUDA path multiply by its reciprocal instead,
which can move a scale by one ULP.  So on either device the scales equal the
numpy host codec's (``hostcodec``) and the CUDA kernel's bitwise.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0  # float8_e4m3fn max finite; no inf — overflow casts to NaN


def _row_scale(delta: torch.Tensor, qmax: float) -> torch.Tensor:
    absmax = delta.abs().amax(dim=1, keepdim=True)
    div = torch.tensor(qmax, dtype=torch.float32, device=delta.device)
    return torch.clamp_min(absmax / div, 1e-12)


def _delta(local, base):
    d = local.to(torch.float32)
    return d if base is None else d - base.to(torch.float32)


def quantize_delta_ref(local, base, qmax: float = 127.0):
    """local/base: (R, 128) (``base=None`` is a zero base).  Returns
    (q int8 (R,128), scales f32 (R,1)).

    ``qmax`` selects the integer tier: 127 for the int8 wire, 7 for the
    int4 wire (codes stay int8 here; nibble-packing is a host-side wire
    concern).  ``torch.round`` rounds half to even, as ``jnp.round``."""
    delta = _delta(local, base)
    scale = _row_scale(delta, qmax)
    q = torch.clamp(torch.round(delta / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def quantize_fp8_ref(local, base):
    """fp8 (e4m3fn) twin of :func:`quantize_delta_ref`.

    Codes are clipped to ±``FP8_MAX`` before the cast: e4m3fn has no inf,
    so an unclipped |code| > 448 would become NaN on the wire."""
    delta = _delta(local, base)
    scale = _row_scale(delta, FP8_MAX)
    q = torch.clamp(delta / scale, -FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return q, scale


def residual_ref(local, base, q, scale):
    """The error-feedback carry of an encode: ``delta - q·scale``."""
    return _delta(local, base) - q.to(torch.float32) * scale


def apply_delta_ref(global_val, q, scale):
    """global_val: (R, 128); q: (R,128) int8 or e4m3fn; scale: (R,1).
    Returns the new global, in global_val's dtype."""
    return (global_val.to(torch.float32)
            + q.to(torch.float32) * scale).to(global_val.dtype)


def push_ref(local, base, global_val):
    """Uncompressed fused push: global += (local - base)."""
    delta = local.to(torch.float32) - base.to(torch.float32)
    return (global_val.to(torch.float32) + delta).to(global_val.dtype)
