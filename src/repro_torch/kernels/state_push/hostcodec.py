"""Host-native fused wire codec — pure numpy, no JAX import.

``kernels/state_push/ops.py`` is the right home for device-resident values,
but for host-resident numpy replicas the JAX dispatch round-trip *is* the
cost: at 64 KB the eager ``_to_rows`` → jit → ``np.asarray`` chain has a
~1.7 ms floor that dwarfs the math.  This module is the fast path
``ops.quantize_delta`` takes when both operands are plain ``np.ndarray`` on
an ``xla`` (host) backend: one chunked pass that fuses delta, per-row absmax
scale, quantise, dequantise and error-feedback residual, writing straight
into preallocated wire buffers.

Chunking (``chunk_rows`` 128-lane rows at a time) keeps the working set in
cache and doubles as the pipelining unit: each chunk's quantised payload is
complete — and readable by a wire writer — while the next chunk is still
being encoded, because scales are per-row and chunk boundaries sit on row
boundaries (the output is bitwise identical for any chunk size).

Kept JAX-free on purpose: ``scripts/check_jax_pin.py`` exercises these entry
points *before* importing jax to prove the host wire path cannot be stalled
by device runtime initialisation.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

LANES = 128
DEFAULT_CHUNK_ROWS = 1024  # 512 KB of f32 per chunk — L2-resident on host CPUs

# float8_e4m3fn: max finite 448, no inf — values beyond +-448 cast to NaN, so
# the encoder must clip codes before the cast.  ml_dtypes ships with jax but
# the import is gated so a numpy-only environment still gets int8/int4 tiers.
FP8_MAX = 448.0
try:
    from ml_dtypes import float8_e4m3fn as _fp8_dtype
except ImportError:  # pragma: no cover - ml_dtypes ships with the pinned jax
    _fp8_dtype = None


def fp8_available() -> bool:
    return _fp8_dtype is not None


def fp8_dtype():
    if _fp8_dtype is None:
        raise RuntimeError("ml_dtypes not available: fp8 wire tier disabled")
    return _fp8_dtype


def rows_for(numel: int) -> int:
    return max(1, -(-numel // LANES))


def _flat_f32(x: np.ndarray) -> np.ndarray:
    flat = x.reshape(-1)
    if flat.dtype != np.float32:
        flat = flat.astype(np.float32)
    return flat


def encode_quant(eff: np.ndarray, base: Optional[np.ndarray] = None, *,
                 qmax: int = 127, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 ) -> Tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """Fused quantise of ``eff - base`` to signed codes in ``[-qmax, qmax]``.

    ``base=None`` means a zero base (pull-direction encode of a ready-made
    delta) — no zeros array is materialised.  Returns
    ``(q int8 (R,128), scales f32 (R,1), numel, residual f32 (numel,))``
    where ``residual = delta - q*scales`` is the error-feedback carry.  The pad
    region (rows*128 − numel) encodes to zero-delta so applying it is a no-op.
    """
    eff_f = _flat_f32(eff)
    base_f = _flat_f32(base) if base is not None else None
    n = eff_f.size
    rows = rows_for(n)
    q = np.empty((rows, LANES), np.int8)
    scales = np.empty((rows, 1), np.float32)
    residual = np.empty(rows * LANES, np.float32)
    cr = max(1, min(chunk_rows, rows))
    scratch = np.empty((cr, LANES), np.float32)
    qmax_f = np.float32(qmax)
    eps = np.float32(1e-12)
    for r0 in range(0, rows, cr):
        r1 = min(r0 + cr, rows)
        i0, i1 = r0 * LANES, min(r1 * LANES, n)
        m = i1 - i0
        ch = scratch[: r1 - r0]
        flat = ch.reshape(-1)
        if base_f is None:
            np.copyto(flat[:m], eff_f[i0:i1])
        else:
            np.subtract(eff_f[i0:i1], base_f[i0:i1], out=flat[:m])
        if m < flat.size:
            flat[m:] = 0.0
        sc = scales[r0:r1]
        np.max(np.abs(ch), axis=1, keepdims=True, out=sc)
        np.divide(sc, qmax_f, out=sc)
        np.maximum(sc, eps, out=sc)
        rch = residual[r0 * LANES: r1 * LANES].reshape(r1 - r0, LANES)
        np.copyto(rch, ch)                      # stash delta
        np.divide(ch, sc, out=ch)
        np.rint(ch, out=ch)
        np.clip(ch, -qmax_f, qmax_f, out=ch)
        qc = q[r0:r1]
        qc[...] = ch                            # integral f32 -> int8
        np.multiply(qc, sc, out=ch)             # dequantised carry
        np.subtract(rch, ch, out=rch)           # residual = delta - deq
    return q, scales, n, residual[:n]


def encode_fp8(eff: np.ndarray, base: Optional[np.ndarray] = None, *,
               chunk_rows: int = DEFAULT_CHUNK_ROWS,
               ) -> Tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """Fused fp8 (e4m3fn) encode of ``eff - base`` (``base=None`` → zero base).

    Returns ``(q fp8 (R,128), scales f32 (R,1), numel, residual f32 (numel,))``.
    Codes are clipped to ±``FP8_MAX`` *before* the cast — e4m3fn has no inf,
    so an unclipped overflow would silently become NaN on the wire.
    """
    dt = fp8_dtype()
    eff_f = _flat_f32(eff)
    base_f = _flat_f32(base) if base is not None else None
    n = eff_f.size
    rows = rows_for(n)
    q = np.empty((rows, LANES), dt)
    scales = np.empty((rows, 1), np.float32)
    residual = np.empty(rows * LANES, np.float32)
    cr = max(1, min(chunk_rows, rows))
    scratch = np.empty((cr, LANES), np.float32)
    fmax = np.float32(FP8_MAX)
    eps = np.float32(1e-12)
    for r0 in range(0, rows, cr):
        r1 = min(r0 + cr, rows)
        i0, i1 = r0 * LANES, min(r1 * LANES, n)
        m = i1 - i0
        ch = scratch[: r1 - r0]
        flat = ch.reshape(-1)
        if base_f is None:
            np.copyto(flat[:m], eff_f[i0:i1])
        else:
            np.subtract(eff_f[i0:i1], base_f[i0:i1], out=flat[:m])
        if m < flat.size:
            flat[m:] = 0.0
        sc = scales[r0:r1]
        np.max(np.abs(ch), axis=1, keepdims=True, out=sc)
        np.divide(sc, fmax, out=sc)
        np.maximum(sc, eps, out=sc)
        rch = residual[r0 * LANES: r1 * LANES].reshape(r1 - r0, LANES)
        np.copyto(rch, ch)
        np.divide(ch, sc, out=ch)
        np.clip(ch, -fmax, fmax, out=ch)
        qc = q[r0:r1]
        qc[...] = ch                            # f32 -> fp8 (rounds to e4m3fn)
        np.multiply(qc.astype(np.float32), sc, out=ch)
        np.subtract(rch, ch, out=rch)
    return q, scales, n, residual[:n]


def decode_rows(payload: np.ndarray, scales: np.ndarray, numel: int
                ) -> np.ndarray:
    """Decode a (R,128) payload (int8 or fp8) back to the flat f32 delta."""
    return (payload.astype(np.float32) * scales).reshape(-1)[:numel]


def pack_int4(q: np.ndarray) -> np.ndarray:
    """Pack (R,128) int8 codes in [-7,7] into (R,64) uint8 nibble pairs.

    Lane 2k goes to the low nibble, lane 2k+1 to the high nibble."""
    lo = q[:, 0::2].astype(np.uint8) & 0x0F
    hi = (q[:, 1::2].astype(np.uint8) & 0x0F) << 4
    return lo | hi


def unpack_int4(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_int4`: (R,64) uint8 → (R,128) int8 in [-8,7]."""
    rows = packed.shape[0]
    q = np.empty((rows, 2 * packed.shape[1]), np.int8)
    # shift-left-then-arithmetic-shift-right sign-extends the nibble
    q[:, 0::2] = (packed << 4).astype(np.int8) >> 4
    q[:, 1::2] = packed.astype(np.int8) >> 4
    return q


def encode_exact(eff: np.ndarray, base: np.ndarray, *,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS) -> np.ndarray:
    """Chunked exact delta: flat f32 ``eff - base`` into a fresh buffer.

    The chunk loop exists for symmetry with the quantised encoders — each
    completed chunk of the output is final while later chunks encode."""
    eff_f = _flat_f32(eff)
    base_f = _flat_f32(base)
    n = eff_f.size
    out = np.empty(n, np.float32)
    step = max(LANES, chunk_rows * LANES)
    for i0 in range(0, n, step):
        i1 = min(i0 + step, n)
        np.subtract(eff_f[i0:i1], base_f[i0:i1], out=out[i0:i1])
    return out


def usable(eff, base) -> bool:
    """True when both operands can take the host-native path: plain numpy
    (or scalar-strided views) — never device arrays, which must stay on
    device end to end."""
    return (type(eff) is np.ndarray or isinstance(eff, np.ndarray)) and \
           (type(base) is np.ndarray or isinstance(base, np.ndarray))
