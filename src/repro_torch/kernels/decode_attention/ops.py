"""Decode attention: the CUDA kernel on the card, the plain version on
the CPU.

Counterpart of ``repro.kernels.decode_attention.ops.decode_attention``.  A
CUDA tensor goes to ``csrc/decode_attention.cu`` (the port of the Pallas
kernel, as split-KV flash-decoding); a CPU tensor, or ``backend="torch"``,
to :func:`ref.decode_attention_ref`.  The lengths stay on the device: the
wrapper never reads them, so a decode step has no host sync.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (DTYPE_CODES, HEAD_DIMS,
                                        LaunchCounter, check_operands, cdiv,
                                        dispatch, round_up)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

LAUNCHES = LaunchCounter()  # wrapper calls that launched the kernels

CHUNK = 32        # keys per chunk in the kernel; a split is a multiple of it
BLOCKS_PER_SM = 4  # split the cache until the grid has this many blocks per SM
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def decode_attention(q, k, v, lengths, *, scale: float | None = None,
                     backend: str | None = None):
    """q: (B, H, D); k/v: (B, S, K, D); lengths: (B,) int32 -> (B, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if dispatch(backend, q) == "torch":
        return decode_attention_ref(q, k, v, lengths, scale=scale)
    return _decode_cuda(q, k, v, lengths, float(scale))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_plan(B: int, K: int, S: int, n_sm: int) -> tuple:
    """(split_len, n_splits) for a cache of S positions: enough splits that
    B*K*n_splits blocks fill ``BLOCKS_PER_SM`` blocks per SM, each split a
    whole number of chunks.  Depends on the cache capacity only, never on
    the lengths, which stay on the card."""
    want = min(max(cdiv(BLOCKS_PER_SM * n_sm, B * K), 1), cdiv(S, CHUNK))
    split_len = round_up(cdiv(S, want), CHUNK)
    return split_len, cdiv(S, split_len)


def _decode_cuda(q, k, v, lengths, scale):
    B, H, D = q.shape
    if k.ndim != 4 or v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    S, K = k.shape[1], k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"decode_attention: {H} query heads over {K} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes one of "
                         f"{tuple(DTYPE_CODES)}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"decode_attention: lengths must be ({B},) int32, "
                         f"got {tuple(lengths.shape)} {lengths.dtype}")
    check_operands("decode_attention", q, k, v, lengths)
    out = torch.empty_like(q)
    if out.numel() == 0 or S == 0:
        return out.zero_()
    split_len, n_splits = split_plan(B, K, S, _sm_count(q.device.index))
    G = H // K
    part_acc = torch.empty((B, K, n_splits, G, D), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, K, n_splits, G, 2), dtype=torch.float32,
                          device=q.device)
    fn = _build.function("decode_attention", "decode_attention_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            B, S, H, K, D, DTYPE_CODES[q.dtype], split_len, n_splits, scale,
            stream)
    _build.check("decode_attention", rc)
    LAUNCHES.add()
    return out
