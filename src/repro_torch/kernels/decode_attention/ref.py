"""Plain PyTorch single-token decode attention over a KV cache.

Mirrors ``repro.kernels.decode_attention.ref.decode_attention_ref``.  It is
the CPU path of :func:`~repro_torch.kernels.decode_attention.decode_attention`,
the reference the CUDA kernel is held against, and ``backend="torch"``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF


def decode_attention_ref(q, k, v, lengths, *, scale: float | None = None):
    """One new token per sequence attends to its KV cache.

    Args:
      q: (B, H, D) — current-token queries
      k, v: (B, S, K, D) — KV cache (positions >= lengths[b] are garbage)
      lengths: (B,) int32 — valid cache lengths (inclusive of current token)

    Returns: (B, H, D) in q.dtype.
    """
    B, H, D = q.shape
    _, S, K, _ = k.shape
    G = H // K
    if scale is None:
        scale = D ** -0.5
    qg = (q.float() * scale).reshape(B, K, G, D)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    mask = torch.arange(S, device=q.device)[None, :] >= lengths[:, None]  # (B, S)
    logits = logits.masked_fill(mask[:, None, None], NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(B, H, D).to(q.dtype)
