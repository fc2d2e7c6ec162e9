"""GQA attention: parameters, full-sequence, prefill and decode paths, and
the encoder/decoder's cross-attention.

Counterpart of ``repro.models.attention``.  Dispatches to the
flash-attention and decode-attention kernel packages.  KV caches are (B, S_max, K, D) per
layer; decode writes the new token's K/V at per-sequence positions
(sequences in a serving batch have different lengths — the Faasm serving
runtime batches unrelated requests).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.execution import ExecConfig
from repro_torch.models.layers import empty_param, rms_head_norm, rope_apply


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
        self.wq = empty_param((d, qd), cfg, device)
        self.wk = empty_param((d, kvd), cfg, device)
        self.wv = empty_param((d, kvd), cfg, device)
        self.wo = empty_param((qd, d), cfg, device)
        if cfg.qkv_bias:
            self.bq = empty_param((qd,), cfg, device)
            self.bk = empty_param((kvd,), cfg, device)
            self.bv = empty_param((kvd,), cfg, device)
        if cfg.o_bias:
            self.bo = empty_param((d,), cfg, device)
        if cfg.qk_norm:
            self.q_norm = empty_param((cfg.head_dim,), cfg, device)
            self.k_norm = empty_param((cfg.head_dim,), cfg, device)


def _project_qkv(p: Attention, cfg: ModelConfig, x, positions):
    """x: (B, S, d) -> q (B,S,H,D), k/v (B,S,K,D) with rope + qk-norm applied."""
    B, S, _ = x.shape
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_head_norm(p.q_norm, q, cfg.norm_eps)
        k = rms_head_norm(p.k_norm, k, cfg.norm_eps)
    if cfg.use_rope and positions is not None:
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p: Attention, y, B, S, cfg):
    out = y.reshape(B, S, cfg.q_dim) @ p.wo
    if cfg.o_bias:
        out = out + p.bo
    return out


def attn_apply_full(p: Attention, cfg: ModelConfig, ec: ExecConfig, x, *,
                    positions=None, causal=True) -> torch.Tensor:
    """Full-sequence attention (``Model.logits``).  x: (B, S, d)."""
    B, S, _ = x.shape
    if positions is None and cfg.use_rope:
        positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    y = flash_attention(q, k, v, causal=causal, backend=ec.backend)
    return _out_proj(p, y, B, S, cfg)


def attn_apply_prefill(p: Attention, cfg: ModelConfig, ec: ExecConfig, x,
                       cache_k, cache_v, *, positions=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill: causal attention + write K/V into the cache prefix.

    cache_k/v: (B, S_max, K, D), written in place.  Returns (out, k_cache,
    v_cache)."""
    B, S, _ = x.shape
    if positions is None and cfg.use_rope:
        positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    y = flash_attention(q, k, v, causal=True, backend=ec.backend)
    cache_k[:, :S] = k
    cache_v[:, :S] = v
    return _out_proj(p, y, B, S, cfg), cache_k, cache_v


def attn_apply_decode(p: Attention, cfg: ModelConfig, ec: ExecConfig, x,
                      cache_k, cache_v, index
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step.  x: (B, 1, d); index: (B,) int32 position of the new
    token.  Returns (out (B,1,d), cache_k, cache_v)."""
    B = x.shape[0]
    positions = index[:, None] if cfg.use_rope else None      # (B, 1)
    q, k, v = _project_qkv(p, cfg, x, positions)
    # in place: JAX's .at[].set returned a new cache, here the step writes
    # the one the caller holds (no copy of the whole cache per token)
    batch_ix = torch.arange(B, device=x.device)
    cache_k[batch_ix, index] = k[:, 0].to(cache_k.dtype)
    cache_v[batch_ix, index] = v[:, 0].to(cache_v.dtype)
    lengths = index + 1
    y = decode_attention(q[:, 0], cache_k.to(q.dtype), cache_v.to(q.dtype),
                         lengths, backend=ec.backend)
    return _out_proj(p, y[:, None], B, 1, cfg), cache_k, cache_v


# ---------------------------------------------------------------------------
# Cross-attention (encoder/decoder)
# ---------------------------------------------------------------------------

def cross_attn_init(cfg: ModelConfig, device=None) -> Attention:
    """The cross-attention's parameters: a self-attention's (filled by
    ``weights``)."""
    return Attention(cfg, device=device)


def cross_attn_precompute(p: Attention, cfg: ModelConfig, enc_out):
    """K/V over the encoder's output, once per request.  enc_out: (B, F, d)
    -> k, v (B, F, K, D)."""
    B, F, _ = enc_out.shape
    k = enc_out @ p.wk
    v = enc_out @ p.wv
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    return (k.reshape(B, F, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, F, cfg.n_kv_heads, cfg.head_dim))


def cross_attn_apply(p: Attention, cfg: ModelConfig, ec: ExecConfig, x, ck,
                     cv) -> torch.Tensor:
    """Decoder cross-attention (no masking).  x: (B, S, d); ck/cv: (B, F,
    K, D)."""
    B, S, _ = x.shape
    q = x @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    y = flash_attention(q, ck.to(q.dtype), cv.to(q.dtype), causal=False,
                        backend=ec.backend)
    return _out_proj(p, y, B, S, cfg)
