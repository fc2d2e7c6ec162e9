"""Plain PyTorch flash attention (GQA, causal, query offset) and its
backward.

:func:`attention_ref` mirrors ``repro.kernels.flash_attention.ref.
attention_ref``: it materialises the full (Sq, Sk) score matrix in f32.  It
is the CPU path of :func:`~repro_torch.kernels.flash_attention.
flash_attention` (autograd differentiates it there), the reference the
CUDA kernel is held against, and ``backend="torch"``.  With
``return_stats`` it also returns each row's log-sum-exp, the statistics
the kernel writes for training.

:func:`flash_attention_bwd` is the FlashAttention-2 backward of
``repro.kernels.flash_attention.ops._flash_xla_bwd``: tile by tile over
the keys, each tile's probabilities recomputed from the forward's
statistics.  It is the backward of the kernel's autograd function on the
card; the reference's backward is plain jnp too (its Pallas kernel is
forward only).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import NEG_INF, round_up


def attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None,
                  q_offset: int = 0, kv_len=None, return_stats: bool = False):
    """Reference attention.

    Args:
      q: (B, Sq, H, D)
      k, v: (B, Sk, K, D) with H % K == 0 (GQA)
      causal: lower-triangular masking in absolute positions
      scale: logit scale (default 1/sqrt(D))
      q_offset: absolute position of q[0] (decode: cache length)
      kv_len: optional (B,) valid KV lengths (positions >= kv_len are masked)
      return_stats: also return each row's log-sum-exp

    Returns: (B, Sq, H, D) in q.dtype; with ``return_stats`` also the
    (B, H, Sq) f32 log-sum-exp of each row's scaled, masked scores in
    natural-log units (a row with no valid key gets about -1e30).
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

    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    total = p.sum(dim=-1, keepdim=True)
    p = p / total
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    out = out.reshape(B, Sq, H, D).to(q.dtype)
    if not return_stats:
        return out
    return out, (m + torch.log(total)).reshape(B, H, Sq)


def _mm(a, b):
    """Batched ``a @ b`` of operands in the compute dtype with f32 products
    and sums: the reference's ``einsum(..., preferred_element_type=f32)``.
    On the card a bf16 product goes to cuBLAS with an f32 result
    (``out_dtype``); the CPU has no such kernel, so there the operands are
    widened first, which gives the same function (a bf16 x bf16 product is
    exact in f32)."""
    if a.dtype != torch.float32 and a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def flash_attention_bwd(q, k, v, out, stats, dout, *, causal: bool = True,
                        scale: float | None = None, q_offset: int = 0,
                        block_k: int = 512):
    """(dq, dk, dv) of flash attention, as ``_flash_xla_bwd`` computes them.

    ``stats`` is the forward's (B, H, Sq) f32 log-sum-exp (the kernel's, or
    :func:`attention_ref`'s with ``return_stats``).  As in the reference:
    q is scaled in f32 and rounded to its dtype, k, v, out and dout are
    taken in q's dtype, products and sums are f32; over KV tiles of
    ``block_k`` keys (fewer when Sk is shorter; the last tile padded and
    masked), ``Di = rowsum(out * dout)``, ``p = exp(s - lse)`` (the
    reference's ``exp(s - m) / l``), ``ds = p * (dp - Di)`` rounded to the
    dtype, ``dq += scale * ds k``, ``dk = ds^T (q * scale)``, ``dv = p^T
    dout``.  Under a causal mask a tile is taken only against the query
    rows that can see one of its keys: the others' probabilities are
    exactly 0 there, so what they would add is 0.
    """
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    if scale is None:
        scale = D ** -0.5
    if Sk == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    cdt, f32 = q.dtype, torch.float32
    block_k = min(block_k, Sk)
    Sk_p = round_up(Sk, block_k)
    # batch (b, kv head), rows (g, q): the reference's "bkgq" layout
    kp = F.pad(k, (0, 0, 0, 0, 0, Sk_p - Sk)).to(cdt).permute(0, 2, 1, 3)
    vp = F.pad(v, (0, 0, 0, 0, 0, Sk_p - Sk)).to(cdt).permute(0, 2, 1, 3)
    heads = lambda x: x.reshape(B, Sq, K, G, D).permute(0, 2, 3, 1, 4)
    qg = heads((q.float() * scale).to(cdt))                  # (B,K,G,Sq,D)
    dog = heads(dout.to(cdt))
    Di = (heads(out.to(cdt)).float() * dog.float()).sum(-1)  # (B,K,G,Sq)
    lse = stats.reshape(B, K, G, Sq)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    dq = torch.zeros((B, K, G, Sq, D), dtype=f32, device=q.device)
    dk = torch.zeros((B, K, Sk_p, D), dtype=f32, device=q.device)
    dv = torch.zeros((B, K, Sk_p, D), dtype=f32, device=q.device)
    for start in range(0, Sk_p, block_k):
        lo = min(Sq, max(0, start - q_offset)) if causal else 0
        if lo == Sq:
            continue
        n = Sq - lo
        kt = kp[:, :, start:start + block_k].reshape(B * K, block_k, D)
        vt = vp[:, :, start:start + block_k].reshape(B * K, block_k, D)
        qt = qg[:, :, :, lo:].reshape(B * K, G * n, D)
        dot = dog[:, :, :, lo:].reshape(B * K, G * n, D)
        k_pos = start + torch.arange(block_k, device=q.device)
        mask = (k_pos >= Sk)[None, :]                        # padding
        if causal:
            mask = mask | (k_pos[None, :] > q_pos[lo:, None])    # (n, bk)
        s = _mm(qt, kt.transpose(1, 2)).view(B, K, G, n, block_k)
        s.masked_fill_(mask, NEG_INF)
        p = torch.exp(s - lse[..., lo:, None])               # exact softmax
        pc = p.to(cdt).view(B * K, G * n, block_k)
        dv[:, :, start:start + block_k] = _mm(pc.transpose(1, 2), dot).view(
            B, K, block_k, D)
        dp = _mm(dot, vt.transpose(1, 2)).view(B, K, G, n, block_k)
        ds = (p * (dp - Di[..., lo:, None])).to(cdt).view(B * K, G * n,
                                                            block_k)
        dq[:, :, :, lo:] += scale * _mm(ds, kt).view(B, K, G, n, D)
        # qt already carries `scale`, so dk = ds^T (q * scale) = ds^T qt
        dk[:, :, start:start + block_k] = _mm(ds.transpose(1, 2), qt).view(
            B, K, block_k, D)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    dk = dk[:, :, :Sk].permute(0, 2, 1, 3)
    dv = dv[:, :, :Sk].permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
