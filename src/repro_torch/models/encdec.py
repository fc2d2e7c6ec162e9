"""Encoder/decoder transformer backbone (Whisper-style).

Counterpart of ``repro.models.encdec``, with the same functions,
signatures and return values.  The audio conv frontend is a stub, as in
the reference: the inputs are precomputed frame embeddings (B, n_frames,
d_model).  Both stacks add fixed sinusoidal positions.  The reference
stacks each stack's layers on a leading axis and scans them; here they are
``nn.ModuleList``s walked by a Python loop.  The serving cache keeps the
reference's stacked layout, (L, B, S_max, K, D) for the self-attention's
``k``/``v`` and (L, B, n_frames, K, D) for the cross-attention's
``ck``/``cv``, which the prefill computes once per request; every layer
writes its slices in place.  The cache also holds what the decode step
would otherwise build at every step: ``pos``, the decoder's (S_max, d)
f32 position table, which the step indexes on the device at the new
tokens' positions, and ``cross_len``, the (B,) int32 cross-attention
lengths (n_frames for every sequence).  So a decode step reads no value
on the host and can be captured in a CUDA graph.  Training runs each
layer of both stacks under ``ExecConfig.remat``, as the reference's scan
bodies.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models import layers as L
from repro_torch.models.attention import (Attention, attn_apply_decode,
                                          attn_apply_full, attn_apply_prefill,
                                          cross_attn_apply, cross_attn_init,
                                          cross_attn_precompute, split_heads)
from repro_torch.models.execution import ExecConfig
from repro_torch.models.transformer import DenseBlock, _maybe_remat


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg, device=device)
        self.self_attn = Attention(cfg, device=device)
        self.ln2 = L.RMSNorm(cfg, device=device)
        self.cross_attn = cross_attn_init(cfg, device=device)
        self.ln3 = L.RMSNorm(cfg, device=device)
        self.mlp = L.MLP(cfg, device=device)


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.layers = nn.ModuleList(DenseBlock(cfg, device)
                                    for _ in range(cfg.n_enc_layers))
        self.ln_post = L.RMSNorm(cfg, device=device)


class EncDec(nn.Module):
    """Parameters, named as the JAX parameter tree: ``embed`` (+
    ``unembed`` when untied), ``encoder.layers.<i>.{ln1,attn,ln2,mlp}``,
    ``encoder.ln_post``, ``layers.<i>.{ln1,self_attn,ln2,cross_attn,ln3,
    mlp}``, ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = L.empty_param((cfg.vocab_size, cfg.d_model), cfg, device)
        if not cfg.tie_embeddings:
            self.unembed = L.empty_param((cfg.d_model, cfg.vocab_size), cfg,
                                         device)
        self.encoder = Encoder(cfg, device)
        self.layers = nn.ModuleList(DecBlock(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg, device=device)


Params = EncDec      # the family's parameter module (weights.params_class)


def init_params(key: torch.Generator, cfg: ModelConfig, device=None) -> EncDec:
    """Random parameters drawn from ``key`` (a ``torch.Generator`` on
    ``device``), with the JAX package's distributions."""
    from repro_torch.models.weights import init_params as _init
    return _init(cfg, key, device)


def _enc_block(lp: DenseBlock, cfg, ec, h):
    h = h + attn_apply_full(lp.attn, cfg, ec, L.norm_apply(lp.ln1, cfg, h),
                            causal=False)
    return h + L.mlp_apply(lp.mlp, cfg, L.norm_apply(lp.ln2, cfg, h))


def encode(params: EncDec, cfg: ModelConfig, ec: ExecConfig, frames,
           train: bool = False):
    """frames: (B, F, d) stubbed conv-frontend output."""
    h = frames.to(L.dt(cfg.dtype))
    h = h + L.sinusoidal_positions(h.shape[1], cfg.d_model,
                                   h.device).to(h.dtype)
    block = _maybe_remat(_enc_block, ec) if train else _enc_block
    for lp in params.encoder.layers:
        h = block(lp, cfg, ec, L.same_layout_grad(h))
    return L.norm_apply(params.encoder.ln_post, cfg, h)


def _dec_block_full(lp: DecBlock, cfg, ec, h, enc_out):
    h = h + attn_apply_full(lp.self_attn, cfg, ec,
                            L.norm_apply(lp.ln1, cfg, h), causal=True)
    ck, cv = cross_attn_precompute(lp.cross_attn, cfg, enc_out)
    h = h + cross_attn_apply(lp.cross_attn, cfg, ec,
                             L.norm_apply(lp.ln2, cfg, h), ck, cv)
    return h + L.mlp_apply(lp.mlp, cfg, L.norm_apply(lp.ln3, cfg, h))


def forward_hidden(params: EncDec, cfg: ModelConfig, ec: ExecConfig, tokens,
                   frames=None, train: bool = True):
    """Returns (h (B, S, d) post-final-norm, aux_loss 0)."""
    enc_out = L.same_layout_grad(encode(params, cfg, ec, frames, train=train))
    h = L.embed_apply(params, cfg, tokens)
    h = h + L.sinusoidal_positions(h.shape[1], cfg.d_model,
                                   h.device).to(h.dtype)
    block = _maybe_remat(_dec_block_full, ec) if train else _dec_block_full
    for lp in params.layers:
        h = block(lp, cfg, ec, L.same_layout_grad(h), enc_out)
    return (L.norm_apply(params.final_norm, cfg, L.same_layout_grad(h)),
            torch.zeros((), dtype=torch.float32, device=h.device))


def forward_train(params: EncDec, cfg: ModelConfig, ec: ExecConfig, batch):
    """batch: tokens/targets/mask and frames tensors.  Returns (loss + aux,
    metrics)."""
    h, aux = forward_hidden(params, cfg, ec, batch["tokens"],
                            batch.get("frames"), train=True)
    loss = L.chunked_loss(params, cfg, h, batch["targets"], batch["mask"],
                          ec.loss_chunk)
    return loss + aux, {"loss": loss, "aux_loss": aux}


def forward_logits(params: EncDec, cfg: ModelConfig, ec: ExecConfig, tokens,
                   frames=None):
    h, _ = forward_hidden(params, cfg, ec, tokens, frames, train=False)
    return L.logits_apply(params, cfg, h)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    kv = lambda s: torch.zeros((cfg.n_layers, batch, s, cfg.n_kv_heads,
                                cfg.head_dim), dtype=L.dt(cfg.dtype),
                               device=device)
    return {"k": kv(max_len), "v": kv(max_len),
            "ck": kv(cfg.n_frames), "cv": kv(cfg.n_frames),
            "pos": L.sinusoidal_positions(max_len, cfg.d_model, device),
            "cross_len": torch.full((batch,), cfg.n_frames, dtype=torch.int32,
                                    device=device)}


def prefill(params: EncDec, cfg: ModelConfig, ec: ExecConfig, tokens, cache,
            frames=None):
    """Encode ``frames``, run the decoder over ``tokens`` and fill the
    cache (in place).  Returns (last-token logits, cache, S)."""
    enc_out = encode(params, cfg, ec, frames)
    h = L.embed_apply(params, cfg, tokens)
    S = tokens.shape[1]
    h = h + cache["pos"][:S].to(h.dtype)     # sinusoidal_positions(S)
    for i, lp in enumerate(params.layers):
        a, _, _ = attn_apply_prefill(lp.self_attn, cfg, ec,
                                     L.norm_apply(lp.ln1, cfg, h),
                                     cache["k"][i], cache["v"][i])
        h = h + a
        ck, cv = cross_attn_precompute(lp.cross_attn, cfg, enc_out)
        h = h + cross_attn_apply(lp.cross_attn, cfg, ec,
                                 L.norm_apply(lp.ln2, cfg, h), ck, cv)
        h = h + L.mlp_apply(lp.mlp, cfg, L.norm_apply(lp.ln3, cfg, h))
        cache["ck"][i] = ck
        cache["cv"][i] = cv
    h = L.norm_apply(params.final_norm, cfg, h)
    logits = L.logits_apply(params, cfg, h[:, -1:])[:, 0]
    return logits, cache, S


def cross_attn_decode(p: Attention, cfg: ModelConfig, ec: ExecConfig, x, ck,
                      cv, lengths):
    """One decode step's cross-attention over the prefill's ``ck``/``cv``
    (B, F, K, D).  x: (B, 1, d); lengths: (B,) int32."""
    B = x.shape[0]
    q = x @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    q = split_heads(q, B, cfg.n_heads, cfg.head_dim)
    y = decode_attention(q, ck.to(q.dtype), cv.to(q.dtype), lengths,
                         backend=ec.backend)
    y = L.reduced(y.reshape(B, 1, cfg.q_dim) @ p.wo)
    if cfg.o_bias:
        y = y + p.bo
    return y


def decode_step(params: EncDec, cfg: ModelConfig, ec: ExecConfig, token,
                cache, index):
    """One serve step.  token: (B,) int32; index: (B,) int32 position of
    this token.  Returns (logits (B, V), cache); the cache is written in
    place."""
    h = L.embed_apply(params, cfg, token[:, None])
    h = h + cache["pos"][index][:, None].to(h.dtype)
    for i, lp in enumerate(params.layers):
        a, _, _ = attn_apply_decode(lp.self_attn, cfg, ec,
                                    L.norm_apply(lp.ln1, cfg, h),
                                    cache["k"][i], cache["v"][i], index)
        h = h + a
        h = h + cross_attn_decode(lp.cross_attn, cfg, ec,
                                  L.norm_apply(lp.ln2, cfg, h),
                                  cache["ck"][i], cache["cv"][i],
                                  cache["cross_len"])
        h = h + L.mlp_apply(lp.mlp, cfg, L.norm_apply(lp.ln3, cfg, h))
    h = L.norm_apply(params.final_norm, cfg, h)
    logits = L.logits_apply(params, cfg, h)[:, 0]
    return logits, cache
