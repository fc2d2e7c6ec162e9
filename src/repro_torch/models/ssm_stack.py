"""Attention-free Mamba2 stack (mamba2-130m) and Zamba2-style hybrid.

Counterpart of ``repro.models.ssm_stack``, with the same functions,
signatures and return values.  The hybrid applies one *shared*
transformer block (its weights tied across all applications, the Zamba2
parameter-sharing trick) before every ``attn_every`` Mamba2 layers: the
layers form static groups, each the shared block then its Mamba layers.
The JAX package stacks the layers and scans each group; here they are an
``nn.ModuleList`` walked by a Python loop.  Training (``forward_train``)
runs each Mamba layer and each shared-block application under
``ExecConfig.remat``, as the reference's scan body and shared block do;
serving's forward never rematerialises.  Serving state: per layer the
conv tail (L, B, W-1, conv_ch) in the activation dtype and the SSD state
(L, B, H, P, N) in f32; the hybrid adds one KV cache per shared-block
application, (A, B, max_len, K, D).  Prefill and decode write every part
of the cache in place, as the transformer's KV cache is written.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.execution import ExecConfig
from repro_torch.models.ssm import (Mamba2, mamba_apply_full,
                                    mamba_init_state, mamba_step)
from repro_torch.models.transformer import (DenseBlock, _maybe_remat,
                                            block_decode, block_full,
                                            block_prefill)


def n_attn_apps(cfg: ModelConfig) -> int:
    return math.ceil(cfg.n_layers / cfg.attn_every) if cfg.attn_every else 0


def _groups(cfg: ModelConfig):
    """Static (start, end) layer ranges, one group per shared-attn application."""
    if not cfg.attn_every:
        return [(0, cfg.n_layers)]
    k = cfg.attn_every
    return [(i, min(i + k, cfg.n_layers)) for i in range(0, cfg.n_layers, k)]


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln = L.RMSNorm(cfg, device=device)
        self.mamba = Mamba2(cfg, device=device)


class SSMStack(nn.Module):
    """Parameters named as the JAX parameter tree: ``embed`` (+ ``unembed``
    when untied), ``layers.<i>.{ln,mamba}``, ``shared_block.{ln1,attn,ln2,
    mlp}`` (hybrid only) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = L.empty_param((cfg.vocab_size, cfg.d_model), cfg, device)
        if not cfg.tie_embeddings:
            self.unembed = L.empty_param((cfg.d_model, cfg.vocab_size), cfg, device)
        self.layers = nn.ModuleList(MambaLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared_block = DenseBlock(cfg, device)
        self.final_norm = L.RMSNorm(cfg, device=device)


Params = SSMStack        # the family's parameter module (weights.params_class)


def _shared(params: SSMStack):
    return getattr(params, "shared_block", None)


def _positions(cfg: ModelConfig, S: int, device):
    return torch.arange(S, device=device) if cfg.use_rope else None


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(key: torch.Generator, cfg: ModelConfig, device=None) -> SSMStack:
    """Random parameters drawn from ``key`` (a ``torch.Generator`` on
    ``device``), with the JAX package's distributions."""
    from repro_torch.models.weights import init_params as _init
    return _init(cfg, key, device)


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def _mamba_block_full(lp: MambaLayer, cfg, ec, h, return_state=False):
    x = L.norm_apply(lp.ln, cfg, h)
    if return_state:
        y, state = mamba_apply_full(lp.mamba, cfg, ec, x, return_state=True)
        return h + y, state
    return h + mamba_apply_full(lp.mamba, cfg, ec, x)


def forward_hidden(params: SSMStack, cfg: ModelConfig, ec: ExecConfig,
                   tokens, image_embeds=None, train: bool = True):
    """Returns (h (B, S, d) post-final-norm, aux_loss 0).  With ``train``
    each Mamba layer and each shared-block application runs under
    ``ec.remat``, as the reference's scan body and shared block do."""
    h = L.embed_apply(params, cfg, tokens)
    positions = _positions(cfg, h.shape[1], h.device)
    shared = _shared(params)

    def mamba(lp, h):
        return _mamba_block_full(lp, cfg, ec, h)

    def attn(h):
        return block_full(shared, cfg, ec, h, positions)[0]

    if train:
        mamba, attn = _maybe_remat(mamba, ec), _maybe_remat(attn, ec)
    for (a, b) in _groups(cfg):
        if shared is not None:
            h = attn(L.same_layout_grad(h))
        for lp in params.layers[a:b]:
            h = mamba(lp, L.same_layout_grad(h))
    return (L.norm_apply(params.final_norm, cfg, L.same_layout_grad(h)),
            torch.zeros((), dtype=torch.float32, device=h.device))


def forward_train(params: SSMStack, cfg: ModelConfig, ec: ExecConfig, batch):
    """batch: tokens/targets/mask tensors.  Returns (loss + aux, metrics)."""
    h, aux = forward_hidden(params, cfg, ec, batch["tokens"], train=True)
    loss = L.chunked_loss(params, cfg, h, batch["targets"], batch["mask"],
                          ec.loss_chunk)
    return loss + aux, {"loss": loss, "aux_loss": aux}


def forward_logits(params: SSMStack, cfg: ModelConfig, ec: ExecConfig, tokens,
                   image_embeds=None):
    h, _ = forward_hidden(params, cfg, ec, tokens, train=False)
    return L.logits_apply(params, cfg, h)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    conv0, ssm0 = mamba_init_state(cfg, batch, device)
    Ln = cfg.n_layers
    cache = {"conv": conv0.expand((Ln,) + conv0.shape).contiguous(),
             "ssm": ssm0.expand((Ln,) + ssm0.shape).contiguous()}
    if cfg.family == "hybrid":
        kv = lambda: torch.zeros((n_attn_apps(cfg), batch, max_len,
                                  cfg.n_kv_heads, cfg.head_dim),
                                 dtype=L.dt(cfg.dtype), device=device)
        cache["k"] = kv()
        cache["v"] = kv()
    return cache


def prefill(params: SSMStack, cfg: ModelConfig, ec: ExecConfig, tokens, cache,
            image_embeds=None):
    """Left-aligned prefill.  Returns (last-token logits, cache, seq_len);
    the cache is written in place."""
    h = L.embed_apply(params, cfg, tokens)
    S = tokens.shape[1]
    positions = _positions(cfg, S, h.device)
    shared = _shared(params)
    for g, (a, b) in enumerate(_groups(cfg)):
        if shared is not None:
            h, _, _ = block_prefill(shared, cfg, ec, h, cache["k"][g],
                                    cache["v"][g], positions)
        for i in range(a, b):
            h, (conv, ssm) = _mamba_block_full(params.layers[i], cfg, ec, h,
                                               return_state=True)
            cache["conv"][i].copy_(conv)
            cache["ssm"][i].copy_(ssm)
    h = L.norm_apply(params.final_norm, cfg, h)
    logits = L.logits_apply(params, cfg, h[:, -1:])[:, 0]
    return logits, cache, S


def decode_step(params: SSMStack, cfg: ModelConfig, ec: ExecConfig, token,
                cache, index):
    """One serve step.  token: (B,) int32; index: (B,) int32 position of
    this token (read by the shared block's attention).  Returns (logits
    (B, V), cache); the cache is written in place."""
    h = L.embed_apply(params, cfg, token[:, None])
    shared = _shared(params)
    for g, (a, b) in enumerate(_groups(cfg)):
        if shared is not None:
            h, _, _ = block_decode(shared, cfg, ec, h, cache["k"][g],
                                   cache["v"][g], index)
        for i in range(a, b):
            lp = params.layers[i]
            x = L.norm_apply(lp.ln, cfg, h[:, 0])
            y, (conv, ssm) = mamba_step(lp.mamba, cfg,
                                        (cache["conv"][i], cache["ssm"][i]), x)
            cache["conv"][i].copy_(conv)
            cache["ssm"][i].copy_(ssm)
            h = h + y[:, None]
    h = L.norm_apply(params.final_norm, cfg, h)
    logits = L.logits_apply(params, cfg, h)[:, 0]
    return logits, cache
