"""Plain PyTorch flash attention (GQA, causal, query offset).

Mirrors ``repro.kernels.flash_attention.ref.attention_ref``: materialises
the full (Sq, Sk) score matrix in f32.  It is the CPU path of
:func:`~repro_torch.kernels.flash_attention.flash_attention`, the
reference the CUDA kernel is held against, and ``backend="torch"``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF


def attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None,
                  q_offset: int = 0, kv_len=None):
    """Reference attention.

    Args:
      q: (B, Sq, H, D)
      k, v: (B, Sk, K, D) with H % K == 0 (GQA)
      causal: lower-triangular masking in absolute positions
      scale: logit scale (default 1/sqrt(D))
      q_offset: absolute position of q[0] (decode: cache length)
      kv_len: optional (B,) valid KV lengths (positions >= kv_len are masked)

    Returns: (B, Sq, H, D) in q.dtype.
    """
    B, Sq, H, D = q.shape
    Bk, Sk, K, Dk = k.shape
    assert (B, D) == (Bk, Dk) and H % K == 0, (q.shape, k.shape)
    G = H // K
    if scale is None:
        scale = D ** -0.5

    qg = (q.float() * scale).reshape(B, Sq, K, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())

    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]   # (Sq, 1)
    k_pos = torch.arange(Sk, device=q.device)[None, :]              # (1, Sk)
    mask = torch.zeros((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask | (k_pos > q_pos)
    if kv_len is not None:
        mask = mask[None] | (k_pos[None] >= kv_len[:, None, None])  # (B, Sq, Sk)
        logits = logits.masked_fill(mask[:, None, None], NEG_INF)
    else:
        logits = logits.masked_fill(mask[None, None, None], NEG_INF)

    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)
