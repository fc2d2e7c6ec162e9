"""Decoder-only transformer: the dense and MoE families.

Dense and MoE branches of ``repro.models.transformer``, with the same
functions, signatures and return values.  The JAX package stacks the
layers on a leading axis and runs them with ``lax.scan``; here they are an
``nn.ModuleList`` walked by a Python loop, and the KV cache keeps the
stacked (L, B, S_max, K, D) layout so each layer writes its slice in
place.  MoE configs with ``first_k_dense`` keep those leading dense layers
in ``first_layers`` (unstacked in the reference too) with their own
``first_k``/``first_v`` cache, written in place as well.  ``remat`` is
dropped (serving does not differentiate) and so is
``seq_shard_constraint`` (a no-op on one device).  The VLM branch raises
until its slice is ported.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import (Attention, attn_apply_decode,
                                          attn_apply_full, attn_apply_prefill)
from repro_torch.models.execution import ExecConfig
from repro_torch.models.moe import MoE, moe_apply


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family == "vlm":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP 'Modules to port': VLM comes in a later slice)")


def _n_first(cfg: ModelConfig) -> int:
    return cfg.first_k_dense if cfg.n_experts else 0


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, d_ff=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = L.RMSNorm(cfg, device=device)
        self.mlp = L.MLP(cfg, d_ff, device=device)


class MoEBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = L.RMSNorm(cfg, device=device)
        self.moe = MoE(cfg, device=device)


class Transformer(nn.Module):
    """Parameters of the decoder, named as the JAX parameter tree:
    ``embed`` (+ ``unembed`` when untied), ``first_layers.<i>.{ln1,attn,
    ln2,mlp}`` (MoE configs with ``first_k_dense``),
    ``layers.<i>.{ln1,attn,ln2,mlp|moe}``, ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        self.embed = L.empty_param((cfg.vocab_size, cfg.d_model), cfg, device)
        if not cfg.tie_embeddings:
            self.unembed = L.empty_param((cfg.d_model, cfg.vocab_size), cfg, device)
        n_first = _n_first(cfg)
        if n_first:
            self.first_layers = nn.ModuleList(
                DenseBlock(cfg, device, d_ff=cfg.dense_d_ff or cfg.d_ff)
                for _ in range(n_first))
        block = MoEBlock if cfg.n_experts else DenseBlock
        self.layers = nn.ModuleList(block(cfg, device)
                                    for _ in range(cfg.n_layers - n_first))
        self.final_norm = L.RMSNorm(cfg, device=device)


def _first_layers(params: Transformer):
    return getattr(params, "first_layers", ())


def _ffn(lp, cfg, ec, h):
    """Second half of a block: returns (delta, aux); a dense block has no
    aux (None, where the reference adds a zero: no launch per layer)."""
    x = L.norm_apply(lp.ln2, cfg, h)
    if isinstance(lp, MoEBlock):
        return moe_apply(lp.moe, cfg, ec, x)
    return L.mlp_apply(lp.mlp, cfg, x), None


def block_full(lp, cfg: ModelConfig, ec: ExecConfig, h, positions=None):
    h = h + attn_apply_full(lp.attn, cfg, ec, L.norm_apply(lp.ln1, cfg, h),
                            positions=positions)
    delta, aux = _ffn(lp, cfg, ec, h)
    return h + delta, aux


def block_prefill(lp, cfg, ec, h, ck, cv, positions=None):
    a, ck, cv = attn_apply_prefill(lp.attn, cfg, ec,
                                   L.norm_apply(lp.ln1, cfg, h), ck, cv,
                                   positions=positions)
    h = h + a
    delta, _ = _ffn(lp, cfg, ec, h)
    return h + delta, ck, cv


def block_decode(lp, cfg, ec, h, ck, cv, index):
    a, ck, cv = attn_apply_decode(lp.attn, cfg, ec,
                                  L.norm_apply(lp.ln1, cfg, h), ck, cv, index)
    h = h + a
    delta, _ = _ffn(lp, cfg, ec, h)
    return h + delta, ck, cv


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
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in (*_first_layers(params), *params.layers):
        h, a = block_full(lp, cfg, ec, h, positions)
        if a is not None:
            aux = aux + a
    return L.norm_apply(params.final_norm, cfg, h), aux


def forward_logits(params: Transformer, cfg: ModelConfig, ec: ExecConfig,
                   tokens, image_embeds=None):
    h, _ = forward_hidden(params, cfg, ec, tokens, image_embeds, train=False)
    return L.logits_apply(params, cfg, h)


# ---------------------------------------------------------------------------
# KV-cache serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    _require_ported(cfg)
    n_first = _n_first(cfg)
    kv = lambda n: torch.zeros((n, batch, max_len, cfg.n_kv_heads,
                                cfg.head_dim), dtype=L.dt(cfg.dtype),
                               device=device)
    cache = {"k": kv(cfg.n_layers - n_first), "v": kv(cfg.n_layers - n_first)}
    if n_first:
        cache["first_k"] = kv(n_first)
        cache["first_v"] = kv(n_first)
    return cache


def prefill(params: Transformer, cfg: ModelConfig, ec: ExecConfig, tokens,
            cache, image_embeds=None):
    """Left-aligned prefill.  Returns (last-token logits, cache, seq_len);
    the cache is written in place."""
    h = _embed_inputs(params, cfg, tokens, image_embeds)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device) if cfg.use_rope else None
    for i, lp in enumerate(_first_layers(params)):
        h, _, _ = block_prefill(lp, cfg, ec, h, cache["first_k"][i],
                                cache["first_v"][i], positions)
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
    for i, lp in enumerate(_first_layers(params)):
        h, _, _ = block_decode(lp, cfg, ec, h, cache["first_k"][i],
                               cache["first_v"][i], index)
    for i, lp in enumerate(params.layers):
        h, _, _ = block_decode(lp, cfg, ec, h, cache["k"][i], cache["v"][i],
                               index)
    h = L.norm_apply(params.final_norm, cfg, h)
    logits = L.logits_apply(params, cfg, h)[:, 0]
    return logits, cache
