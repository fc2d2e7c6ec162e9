"""Shared neural-net layers: norms, RoPE, MLPs, embeddings, chunked loss.

The port's counterpart of ``repro.models.layers``.  Each layer is an ``nn.Module``
that holds its parameters in the JAX package's layout (``x @ w`` with
``w`` of shape (in, out)), and a plain function on tensors that applies
it, taking the module as ``p`` as the JAX functions take a dict.
``seq_shard_constraint`` is dropped: it constrains GSPMD sharding and is
a no-op on one device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig


def dt(cfg_dtype: str) -> torch.dtype:
    return getattr(torch, cfg_dtype)


def trunc_normal(shape, std: float, dtype, *, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Normal draw truncated to [-2, 2], times ``std``, drawn in f32 and
    cast — the distribution of ``repro.models.layers.trunc_normal``."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    x = torch.erfinv((lo + u * (hi - lo)) * 2 - 1) * math.sqrt(2)
    return (x.clamp_(-2.0, 2.0) * std).to(dtype)


def empty_param(shape, cfg: ModelConfig, device) -> nn.Parameter:
    """Uninitialised parameter; ``weights`` fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dt(cfg.param_dtype),
                                    device=device), requires_grad=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """RMSNorm ``scale``; with ``cfg.norm_type == "layernorm"`` it also
    holds a ``bias`` and :func:`norm_apply` centres, as in the JAX package."""

    def __init__(self, cfg: ModelConfig, dim: Optional[int] = None, device=None):
        super().__init__()
        d = dim or cfg.d_model
        self.scale = empty_param((d,), cfg, device)
        self.bias = empty_param((d,), cfg, device) if cfg.norm_type == "layernorm" else None


def norm_apply(p: RMSNorm, cfg: ModelConfig, x):
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p.scale.float() + p.bias.float()
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p.scale.float()
    return y.to(x.dtype)


def rms_head_norm(scale, x, eps: float):
    """Per-head RMSNorm over the last (head_dim) axis — Qwen3 qk_norm."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * scale.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (GPT-NeoX rotate-half convention)
# ---------------------------------------------------------------------------

def rope_apply(x, positions, theta: float):
    """x: (B, S, H, D); positions: (S,) or (B, S) absolute positions."""
    B, S, H, D = x.shape
    half = D // 2
    inv_freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                       device=x.device) / half)
    pos = positions.float()
    if pos.ndim == 1:
        pos = pos[None, :]                                   # (1, S)
    ang = pos[..., None] * inv_freq                           # (B?, S, half)
    cos = torch.cos(ang)[:, :, None, :]                       # (B?, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (n, d), in f32."""
    half = d // 2
    inv = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / max(half - 1, 1))
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, d_ff: Optional[int] = None, device=None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        if cfg.mlp_act == "silu":
            self.w_gate = empty_param((d, f), cfg, device)
        self.w_up = empty_param((d, f), cfg, device)
        self.w_down = empty_param((f, d), cfg, device)
        if cfg.mlp_bias:
            self.b_up = empty_param((f,), cfg, device)
            self.b_down = empty_param((d,), cfg, device)


def mlp_apply(p: MLP, cfg: ModelConfig, x):
    if cfg.mlp_act == "silu":
        h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    else:
        h = x @ p.w_up
        if cfg.mlp_bias:
            h = h + p.b_up
        h = F.gelu(h, approximate="tanh")        # jax.nn.gelu's default
    y = h @ p.w_down
    if cfg.mlp_bias:
        y = y + p.b_down
    return y


# ---------------------------------------------------------------------------
# Embedding / unembedding with chunked fused loss
# ---------------------------------------------------------------------------

def embed_apply(p, cfg: ModelConfig, tokens):
    return p.embed[tokens].to(dt(cfg.dtype))


def unembed_matrix(p, cfg: ModelConfig):
    return p.embed.T if cfg.tie_embeddings else p.unembed


def logits_apply(p, cfg: ModelConfig, h):
    """f32 logits, as every caller of the JAX package asks for them."""
    w = unembed_matrix(p, cfg)
    return (h @ w.to(h.dtype)).float()


def softmax_xent(logits, targets, mask):
    """Masked cross-entropy: (sum of the masked rows' nll, sum of the mask).
    logits: (..., V), taken in f32; targets int; mask {0,1}."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return nll.sum(), mask.sum()


def chunked_loss(p, cfg: ModelConfig, h, targets, mask, chunk: int):
    """Fused unembed + cross-entropy over sequence chunks.

    Keeps the full (B, S, V) logit tensor from ever existing: each chunk's
    logits live inside one checkpointed call and are recomputed in the
    backward pass (the reference's scan body under ``jax.checkpoint``).
    One chunk when ``chunk <= 0``, ``S <= chunk`` or ``S % chunk != 0``, as
    there.  h: (B, S, d); targets/mask: (B, S).  Returns the mean nll over
    the mask (its sum at least 1).
    """
    B, S, d = h.shape
    if chunk <= 0 or S <= chunk or S % chunk != 0:
        nll, denom = softmax_xent(logits_apply(p, cfg, h), targets, mask)
        return nll / denom.clamp_min(1.0)

    def body(h_c, t_c, m_c):
        return softmax_xent(logits_apply(p, cfg, h_c), t_c, m_c)

    nll = denom = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, chunk):
        n, m = checkpoint(body, h[:, i:i + chunk], targets[:, i:i + chunk],
                          mask[:, i:i + chunk], use_reentrant=False)
        nll, denom = nll + n, denom + m
    return nll / denom.clamp_min(1.0)
