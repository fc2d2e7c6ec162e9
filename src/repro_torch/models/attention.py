"""GQA attention: parameters, full-sequence, prefill and decode paths, and
the encoder/decoder's cross-attention.

Counterpart of ``repro.models.attention``.  Dispatches to the
flash-attention and decode-attention kernel packages.  KV caches are (B, S_max, K, D) per
layer; decode writes the new token's K/V at per-sequence positions
(sequences in a serving batch have different lengths — the Faasm serving
runtime batches unrelated requests).  On a mesh (``DTensor`` operands) a
projection whose output dim is sharded over more ranks than it has heads
is gathered before it is split into heads (:func:`split_heads`), and a
decode step writes each rank's cache shard locally (:func:`write_at`).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import as_dtensor
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.execution import ExecConfig
from repro_torch.models.layers import (empty_param, reduced, rms_head_norm,
                                       rope_apply, same_layout_grad)


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


def split_heads(t, *shape):
    """``t.reshape(*shape)``, the last dim split into (heads, head_dim).
    A ``DTensor`` whose last dim is sharded over more ranks than there are
    heads (fewer KV heads than the ``model`` axis, where the reference's
    rule still shards the projection's columns) is gathered on those mesh
    dims first: a shard must hold whole heads."""
    d = as_dtensor(t)
    if d is not None:
        from torch.distributed.tensor import Replicate, Shard
        last = t.ndim - 1
        n = math.prod(d.device_mesh.size(m) for m, p in
                      enumerate(d.placements)
                      if isinstance(p, Shard) and p.dim == last)
        if shape[-2] % n:
            t = d.redistribute(d.device_mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == last else p
                for p in d.placements])
    return t.reshape(*shape)


def write_at(cache, index, new) -> None:
    """``cache[b, index[b]] = new[b]`` for every row b, in place: one
    decode step's K or V.  cache: (B, S_max, K, D); index: (B,); new:
    (B, K, D).  On a mesh each rank writes its own shard: its rows, its
    heads, and, where the cache's sequence is sharded, the positions it
    holds (a write that lands on another rank's positions is a no-op
    here)."""
    dc = as_dtensor(cache)
    if dc is None:
        batch_ix = torch.arange(new.shape[0], device=new.device)
        cache[batch_ix, index] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = dc.device_mesh
    # new's (B, K, D) in the cache's layout, its sequence dim dropped
    want = [Shard({0: 0, 2: 1, 3: 2}[p.dim]) if isinstance(p, Shard)
            and p.dim != 1 else Replicate() for p in dc.placements]
    nl = as_dtensor(new).redistribute(mesh, want).to_local()
    il = as_dtensor(index).redistribute(mesh, [
        p if isinstance(p, Shard) and p.dim == 0 else Replicate()
        for p in want]).to_local()
    cl = dc.to_local()
    S_l, lo = cl.shape[1], 0
    coord = mesh.get_coordinate()
    for m, p in enumerate(dc.placements):     # nested sequence shards
        if isinstance(p, Shard) and p.dim == 1:
            lo = lo * mesh.size(m) + coord[m]
    lo *= S_l
    pos = il.long() - lo
    mine = ((pos >= 0) & (pos < S_l))[:, None, None]
    pos = pos.clamp(0, S_l - 1)
    rows = torch.arange(cl.shape[0], device=cl.device)
    cl[rows, pos] = torch.where(mine, nl.to(cl.dtype), cl[rows, pos])


def _project_qkv(p: Attention, cfg: ModelConfig, x, positions):
    """x: (B, S, d) -> q (B,S,H,D), k/v (B,S,K,D) with rope + qk-norm applied."""
    B, S, _ = x.shape
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = split_heads(q, B, S, cfg.n_heads, cfg.head_dim)
    k = split_heads(k, B, S, cfg.n_kv_heads, cfg.head_dim)
    v = split_heads(v, B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_head_norm(p.q_norm, q, cfg.norm_eps)
        k = rms_head_norm(p.k_norm, k, cfg.norm_eps)
    if cfg.use_rope and positions is not None:
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p: Attention, y, B, S, cfg):
    # the heads flattened keep their layout in the backward too: a split
    # into heads that a mesh dim does not divide cannot be undone sharded
    out = reduced(same_layout_grad(y.reshape(B, S, cfg.q_dim)) @ p.wo)
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
    write_at(cache_k, index, k[:, 0])
    write_at(cache_v, index, v[:, 0])
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
    return (split_heads(k, B, F, cfg.n_kv_heads, cfg.head_dim),
            split_heads(v, B, F, cfg.n_kv_heads, cfg.head_dim))


def cross_attn_apply(p: Attention, cfg: ModelConfig, ec: ExecConfig, x, ck,
                     cv) -> torch.Tensor:
    """Decoder cross-attention (no masking).  x: (B, S, d); ck/cv: (B, F,
    K, D)."""
    B, S, _ = x.shape
    q = x @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    q = split_heads(q, B, S, cfg.n_heads, cfg.head_dim)
    y = flash_attention(q, ck.to(q.dtype), cv.to(q.dtype), causal=False,
                        backend=ec.backend)
    return _out_proj(p, y, B, S, cfg)
