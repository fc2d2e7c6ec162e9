"""Flash attention: the CUDA kernel's forward on the card, the plain version
on the CPU; under autograd, the plain flash backward.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention``.  A
CUDA tensor goes to ``csrc/flash_attention.cu`` (the port of the Pallas
kernel: bf16 at head dim 64 and 128 on the tensor cores, every other dtype
and width on the CUDA cores; the C entry point picks by dtype and D); a
CPU tensor, or ``backend="torch"``, to :func:`ref.attention_ref`.
The TPU path's padding to its (8, 128) tiles is gone: the kernel masks the
ragged edges itself.

Training: on a CUDA tensor in grad mode, when an operand requires grad,
the call goes through :class:`FlashAttentionFn`.  Its forward is the
kernel, which also writes each row's log-sum-exp (the reference's saved
``m`` and ``l``); its backward is :func:`ref.flash_attention_bwd`, the
counterpart of the reference's ``_flash_xla_bwd`` (plain jnp there: the
Pallas kernel is forward only).  On the CPU, autograd differentiates
:func:`ref.attention_ref`.  Nothing falls back: a kernel that fails to
build or launch raises in training as in serving.

A fake tensor (a traced step: ``distributed/cost_analysis.py``) takes the
kernel's route without a launch: the output (and statistics) of the
kernel's shapes, and :func:`cost` reported.  ``DTensor`` operands run the
kernel on their local shards where the placements make that the whole
answer (``common.local_operands``: batch or heads sharded).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (DTYPE_CODES, HEAD_DIMS,
                                        LaunchCounter, check_operands,
                                        dispatch, from_local, is_fake,
                                        local_operands, report_cost)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_bwd)
from repro_torch.telemetry.device import device_span

LAUNCHES = LaunchCounter()      # kernel launches, by (Sq, Sk, H, K, D, causal)

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])
BLOCK_K = 512        # the backward's KV tile: the reference's default block_k


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    q_offset: int = 0, backend: str | None = None):
    """(B, Sq, H, D) x (B, Sk, K, D)^2 -> (B, Sq, H, D).  Shapes and masking
    as in :func:`ref.attention_ref`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    shards = local_operands("flash_attention", (q, k, v), (0, 0, 0),
                            (2, 2, 2), (None, 1, 1))
    if shards is not None:
        (ql, kl, vl), mesh, pl = shards
        out = flash_attention(ql, kl, vl, causal=causal, scale=scale,
                              q_offset=q_offset, backend=backend)
        return from_local(out, mesh, pl, q.shape)
    if dispatch(backend, q) == "torch":
        return attention_ref(q, k, v, causal=causal, scale=scale,
                             q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, float(scale),
                                      int(q_offset))
    return _flash_cuda(q, k, v, causal, float(scale), int(q_offset))[0]


class FlashAttentionFn(torch.autograd.Function):
    """The kernel's forward, saving ``(q, k, v, out, lse)``; the plain
    flash backward (:func:`ref.flash_attention_bwd`) from them, one
    device span (``train.flash_bwd``) a call."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset):
        out, lse = _flash_cuda(q, k, v, causal, scale, q_offset, stats=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, q_offset = ctx.args
        with device_span("train.flash_bwd", q.device):
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                             causal=causal, scale=scale,
                                             q_offset=q_offset,
                                             block_k=BLOCK_K)
        return dq, dk, dv, None, None, None


def causal_pairs(Sq: int, Sk: int, causal: bool, q_offset: int = 0) -> int:
    """Query-key pairs one (row, head) of K5 scores: under the causal mask
    query i (at absolute position ``q_offset + i``) sees keys 0 ..
    q_offset + i, at most Sk; without it Sq x Sk."""
    if not causal:
        return Sq * Sk
    full = max(0, min(Sq, Sk - q_offset))       # rows below the last key
    pairs = full * q_offset + full * (full + 1) // 2
    return pairs + (Sq - full) * Sk


def cost(B: int, Sq: int, Sk: int, H: int, K: int, D: int, causal: bool,
         itemsize: int, q_offset: int = 0, stats: bool = False) -> tuple:
    """(FLOPs, bytes) of one K5 call: QK^T and PV over the visible pairs
    (4 D per pair and head), and q, k, v read and the output written once
    (with ``stats``, the (B, H, Sq) f32 log-sum-exp too)."""
    flops = 4 * D * B * H * causal_pairs(Sq, Sk, causal, q_offset)
    nbytes = itemsize * (2 * B * Sq * H * D + 2 * B * Sk * K * D)
    return flops, nbytes + (4 * B * H * Sq if stats else 0)


def _flash_cuda(q, k, v, causal, scale, q_offset, stats: bool = False):
    """The kernel call: (out, lse), lse the rows' (B, H, Sq) f32
    log-sum-exp when ``stats`` is asked for, else None.  On a fake tensor,
    no launch: empty outputs of the kernel's shapes and :func:`cost`
    reported."""
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
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if stats else None)
    if is_fake(q):
        report_cost("flash_attention", *cost(B, Sq, Sk, H, K, D, causal,
                                             q.element_size(), q_offset,
                                             stats))
        return out, lse
    check_operands("flash_attention", q, k, v)   # TMA needs 16-byte aligned
    if out.numel() == 0:
        return out, lse
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Sq, Sk, H, K, D, DTYPE_CODES[q.dtype], int(causal), q_offset,
            scale, stream)
    _build.check("flash_attention", rc)
    LAUNCHES.add((Sq, Sk, H, K, D, bool(causal)))
    return out, lse
