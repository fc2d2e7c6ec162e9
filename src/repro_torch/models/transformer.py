"""Decoder-only transformer: the dense family.

Dense branch of ``repro.models.transformer``, with the same functions,
signatures and return values.  The JAX package stacks the layers on a
leading axis and runs them with ``lax.scan``; here they are an
``nn.ModuleList`` walked by a Python loop, and the KV cache keeps the
stacked (L, B, S_max, K, D) layout so each layer writes its slice in
place.  ``remat`` is dropped (serving does not differentiate) and so is
``seq_shard_constraint`` (a no-op on one device).  The MoE and VLM
branches raise until their slices are ported.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import (Attention, attn_apply_decode,
                                          attn_apply_full, attn_apply_prefill)
from repro_torch.models.execution import ExecConfig


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP 'Modules to port': MoE and VLM come in later slices)")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = L.RMSNorm(cfg, device=device)
        self.mlp = L.MLP(cfg, device=device)


class Transformer(nn.Module):
    """Parameters of the dense decoder, named as the JAX parameter tree:
    ``embed`` (+ ``unembed`` when untied), ``layers.<i>.{ln1,attn,ln2,mlp}``,
    ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _require_dense(cfg)
        self.cfg = cfg
        self.embed = L.empty_param((cfg.vocab_size, cfg.d_model), cfg, device)
        if not cfg.tie_embeddings:
            self.unembed = L.empty_param((cfg.d_model, cfg.vocab_size), cfg, device)
        self.layers = nn.ModuleList(DenseBlock(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg, device=device)


def _ffn(lp: DenseBlock, cfg, h):
    return L.mlp_apply(lp.mlp, cfg, L.norm_apply(lp.ln2, cfg, h))


def block_full(lp: DenseBlock, cfg: ModelConfig, ec: ExecConfig, h,
               positions=None):
    h = h + attn_apply_full(lp.attn, cfg, ec, L.norm_apply(lp.ln1, cfg, h),
                            positions=positions)
    return h + _ffn(lp, cfg, h)


def block_prefill(lp: DenseBlock, cfg, ec, h, ck, cv, positions=None):
    a, ck, cv = attn_apply_prefill(lp.attn, cfg, ec,
                                   L.norm_apply(lp.ln1, cfg, h), ck, cv,
                                   positions=positions)
    h = h + a
    return h + _ffn(lp, cfg, h), ck, cv


def block_decode(lp: DenseBlock, cfg, ec, h, ck, cv, index):
    a, ck, cv = attn_apply_decode(lp.attn, cfg, ec,
                                  L.norm_apply(lp.ln1, cfg, h), ck, cv, index)
    h = h + a
    return h + _ffn(lp, cfg, h), ck, cv


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_params(key: torch.Generator, cfg: ModelConfig, device=None) -> Transformer:
    """Random parameters drawn from ``key`` (a ``torch.Generator`` on
    ``device``), with the JAX package's distributions."""
    from repro_torch.models.weights import init_params as _init
    return _init(cfg, key, device)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _embed_inputs(params: Transformer, cfg: ModelConfig, tokens,
                  image_embeds=None):
    if image_embeds is not None:
        raise NotImplementedError("image embeddings: the VLM family is not "
                                  "ported yet (ROADMAP 'Modules to port')")
    return L.embed_apply(params, cfg, tokens)


def forward_hidden(params: Transformer, cfg: ModelConfig, ec: ExecConfig,
                   tokens, image_embeds=None, train: bool = True):
    """Returns (h (B, S, d) post-final-norm, aux_loss).  ``train`` is kept
    for the signature; it selected remat and sharding, both dropped."""
    h = _embed_inputs(params, cfg, tokens, image_embeds)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device) if cfg.use_rope else None
    for lp in params.layers:
        h = block_full(lp, cfg, ec, h, positions)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return L.norm_apply(params.final_norm, cfg, h), aux


def forward_logits(params: Transformer, cfg: ModelConfig, ec: ExecConfig,
                   tokens, image_embeds=None):
    h, _ = forward_hidden(params, cfg, ec, tokens, image_embeds, train=False)
    return L.logits_apply(params, cfg, h)


# ---------------------------------------------------------------------------
# KV-cache serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    _require_dense(cfg)
    kv = lambda: torch.zeros((cfg.n_layers, batch, max_len, cfg.n_kv_heads,
                              cfg.head_dim), dtype=L.dt(cfg.dtype),
                             device=device)
    return {"k": kv(), "v": kv()}


def prefill(params: Transformer, cfg: ModelConfig, ec: ExecConfig, tokens,
            cache, image_embeds=None):
    """Left-aligned prefill.  Returns (last-token logits, cache, seq_len);
    the cache is written in place."""
    h = _embed_inputs(params, cfg, tokens, image_embeds)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device) if cfg.use_rope else None
    for i, lp in enumerate(params.layers):
        h, _, _ = block_prefill(lp, cfg, ec, h, cache["k"][i], cache["v"][i],
                                positions)
    h = L.norm_apply(params.final_norm, cfg, h)
    logits = L.logits_apply(params, cfg, h[:, -1:])[:, 0]
    return logits, cache, S


def decode_step(params: Transformer, cfg: ModelConfig, ec: ExecConfig, token,
                cache, index):
    """One serve step.  token: (B,) int32; index: (B,) int32 position of
    this token.  Returns (logits (B, V), cache); the cache is written in
    place."""
    h = _embed_inputs(params, cfg, token[:, None])
    for i, lp in enumerate(params.layers):
        h, _, _ = block_decode(lp, cfg, ec, h, cache["k"][i], cache["v"][i],
                               index)
    h = L.norm_apply(params.final_norm, cfg, h)
    logits = L.logits_apply(params, cfg, h)[:, 0]
    return logits, cache
