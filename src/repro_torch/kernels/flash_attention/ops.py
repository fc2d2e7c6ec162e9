"""Flash-attention forward: the CUDA kernel on the card, the plain version
on the CPU.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention``.  A
CUDA tensor goes to ``csrc/flash_attention.cu`` (the port of the Pallas
kernel); a CPU tensor, or ``backend="torch"``, to :func:`ref.attention_ref`.
The TPU path's padding to its (8, 128) tiles is gone: the kernel masks the
ragged edges itself.  The backward pass comes with the training slice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (DTYPE_CODES, HEAD_DIMS,
                                        LaunchCounter, check_operands,
                                        dispatch)
from repro_torch.kernels.flash_attention.ref import attention_ref

LAUNCHES = LaunchCounter()      # kernel launches (chip_smoke reads it)

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    q_offset: int = 0, backend: str | None = None):
    """(B, Sq, H, D) x (B, Sk, K, D)^2 -> (B, Sq, H, D).  Shapes and masking
    as in :func:`ref.attention_ref`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if dispatch(backend, q) == "torch":
        return attention_ref(q, k, v, causal=causal, scale=scale,
                             q_offset=q_offset)
    return _flash_cuda(q, k, v, causal, float(scale), int(q_offset))


def _flash_cuda(q, k, v, causal, scale, q_offset):
    B, Sq, H, D = q.shape
    if k.ndim != 4 or v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    Sk, K = k.shape[1], k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"flash_attention: {H} query heads over {K} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes one of "
                         f"{tuple(DTYPE_CODES)}")
    check_operands("flash_attention", q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, K, D, DTYPE_CODES[q.dtype], int(causal), q_offset,
            scale, stream)
    _build.check("flash_attention", rc)
    LAUNCHES.add()
    return out
