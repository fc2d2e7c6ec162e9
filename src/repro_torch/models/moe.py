"""Mixture-of-experts layer (DeepSeek-style fine-grained: shared + routed top-k).

Port of ``repro.models.moe``, with the same functions, signatures and
return values.  Two dispatch implementations, selected by
``ExecConfig.moe_impl`` (decode steps by ``moe_decode_impl``):

* ``einsum`` — GShard grouped capacity dispatch with one-hot einsums:
  the same slot-major priority, capacity ``C`` and group padding as the
  reference, so the same tokens are dropped.  Plain PyTorch on every
  device (the reference leaves it to XLA).
* ``sorted`` — dropless sort-by-expert + grouped matmul through
  ``kernels/moe_gmm`` (K7 on the card).  No host sync: the group sizes
  stay on the device.

Where PyTorch differs from JAX:

* The router runs in f32 (``x.float() @ router``, the router itself kept
  f32 whatever ``param_dtype`` is).  A CUDA f32 matmul is full f32 only
  while ``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's
  default; a caller that turns TF32 on changes the routing.
* ``jax.lax.top_k`` puts the lower index first among equal values; here
  a stable descending sort does the same (``torch.topk`` promises no
  order among ties).  ``jnp.argsort`` is stable, so the expert sort is
  ``torch.argsort(stable=True)``.
* The scatter back of ``_moe_sorted``: the reference adds each token's
  k weighted expert outputs into a zero row with a bf16 ``.at[tok].add``.
  ``index_add_`` would do the same on the card with atomics, whose order,
  and so whose bf16 rounding, changes from run to run, and the model
  amplifies a one-ulp difference into other tokens (a routing flip).
  Here the k rows of each token are gathered back into (T, k, d) and
  summed over k (in f32 inside ``sum``, rounded once instead of after
  every add): the same function, and the same result from run to run.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm import gmm
from repro_torch.models.execution import ExecConfig
from repro_torch.models.layers import empty_param


class SharedExperts(nn.Module):
    """The always-on experts, fused into one gated MLP of width
    ``moe_d_ff * n_shared_experts``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, fs = cfg.d_model, cfg.moe_d_ff * cfg.n_shared_experts
        self.w_gate = empty_param((d, fs), cfg, device)
        self.w_up = empty_param((d, fs), cfg, device)
        self.w_down = empty_param((fs, d), cfg, device)


class MoE(nn.Module):
    """``router`` (d, E) f32; ``w_gate``/``w_up`` (E, d, f), ``w_down``
    (E, f, d); ``shared`` when the config has shared experts."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.router = nn.Parameter(torch.empty((d, E), dtype=torch.float32,
                                               device=device),
                                   requires_grad=False)
        self.w_gate = empty_param((E, d, f), cfg, device)
        self.w_up = empty_param((E, d, f), cfg, device)
        self.w_down = empty_param((E, f, d), cfg, device)
        self.shared = (SharedExperts(cfg, device) if cfg.n_shared_experts
                       else None)


def router_topk(p: MoE, cfg: ModelConfig,
                x2d) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing.  x2d: (T, d).  Returns (gates (T,k) f32, idx (T,k)
    int32, aux)."""
    logits = x2d.float() @ p.router                                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)    # renorm
    # Switch-style load-balance auxiliary loss.
    E = cfg.n_experts
    me = probs.mean(dim=0)                                         # (E,)
    ce = torch.zeros(E, dtype=torch.float32, device=x2d.device).index_add_(
        0, idx.reshape(-1),
        torch.full((idx.numel(),), 1.0 / idx.numel(), device=x2d.device))
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)
    return gates, idx.to(torch.int32), aux


def _expert_ffn_dense(p: MoE, x_ecd):
    """x: (..., E, C, d) -> gated FFN with per-expert weights."""
    h = F.silu(torch.einsum("gecd,edf->gecf", x_ecd, p.w_gate)) * \
        torch.einsum("gecd,edf->gecf", x_ecd, p.w_up)
    return torch.einsum("gecf,efd->gecd", h, p.w_down)


def shared_expert_apply(p: MoE, x):
    s = p.shared
    h = F.silu(x @ s.w_gate) * (x @ s.w_up)
    return h @ s.w_down


def moe_apply(p: MoE, cfg: ModelConfig, ec: ExecConfig,
              x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).

    Decode steps (S == 1) take ``ec.moe_decode_impl``, the dropless sorted
    path by default: a serving token must never be capacity-dropped."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    gates, idx, aux = router_topk(p, cfg, x2d)
    impl = ec.moe_decode_impl if S == 1 else ec.moe_impl
    if impl == "sorted":
        y2d = _moe_sorted(p, cfg, x2d, gates, idx, backend=ec.backend)
    else:
        y2d = _moe_einsum(p, cfg, ec, x2d, gates, idx)
    if cfg.n_shared_experts:
        y2d = y2d + shared_expert_apply(p, x2d)
    return y2d.reshape(B, S, d), aux


def _moe_einsum(p: MoE, cfg: ModelConfig, ec: ExecConfig, x2d, gates, idx):
    """GShard grouped capacity dispatch (one-hot einsums).  The (Gg, k*Sg,
    E, C) f32 dispatch tensors are 377 MB each at the full-width prefill
    (T 2048, C 120); each is freed as soon as its fold is taken."""
    T, d = x2d.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    Sg = min(ec.moe_group_size, T)
    T_pad = -(-T // Sg) * Sg
    if T_pad != T:              # padded rows route to expert 0 with gate 0
        x2d = F.pad(x2d, (0, 0, 0, T_pad - T))
        gates = F.pad(gates, (0, 0, 0, T_pad - T))
        idx = F.pad(idx, (0, 0, 0, T_pad - T))
    Gg = T_pad // Sg
    cf = ec.moe_capacity_override or cfg.capacity_factor
    C = max(1, int(k * Sg * cf / E))

    oh = F.one_hot(idx.reshape(Gg, Sg, k).long(), E).float()
    # slot-major priority: all slot-0 choices first, then slot-1, ...
    ohf = oh.permute(0, 2, 1, 3).reshape(Gg, k * Sg, E)
    del oh
    cum = torch.cumsum(ohf, dim=1) - ohf                      # exclusive
    pos = torch.sum(cum * ohf, dim=-1)                        # (Gg, k*Sg)
    del cum
    keep = (pos < C).float()
    # a position past C has no one-hot row in the reference; ``keep``
    # zeroes it here
    pos_oh = F.one_hot(pos.long().clamp_(max=C - 1), C).float()
    disp_f = ohf[..., None] * pos_oh[:, :, None, :] * keep[..., None, None]
    del ohf, pos_oh
    # fold the k slots back onto tokens: (Gg, k, Sg, E, C) -> sum over k
    disp = disp_f.reshape(Gg, k, Sg, E, C).sum(dim=1)         # 0/1 (Gg,Sg,E,C)
    gates_f = gates.reshape(Gg, Sg, k).permute(0, 2, 1).reshape(Gg, k * Sg)
    disp_f *= gates_f[..., None, None]                        # comb_f, in place
    comb = disp_f.reshape(Gg, k, Sg, E, C).sum(dim=1)         # (Gg,Sg,E,C)
    del disp_f

    xg = x2d.reshape(Gg, Sg, d)
    cdt = xg.dtype
    expert_in = torch.einsum("gsec,gsd->gecd", disp.to(cdt), xg)
    del disp
    expert_out = _expert_ffn_dense(p, expert_in)
    y = torch.einsum("gsec,gecd->gsd", comb.to(cdt), expert_out)
    return y.reshape(T_pad, d)[:T]


def _moe_sorted(p: MoE, cfg: ModelConfig, x2d, gates, idx, *,
                backend: str | None = None):
    """Dropless sorted dispatch + grouped matmul (single-shard layout).
    ``backend`` goes to ``gmm`` (the reference's gmm picks its own)."""
    T, d = x2d.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    flat_e = idx.reshape(-1)                                  # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    tok = order // k                                          # source token per row
    xs = x2d[tok]                                             # (T*k, d)
    group_sizes = torch.zeros(E, dtype=torch.int32,
                              device=x2d.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))

    h = F.silu(gmm(xs, p.w_gate, group_sizes, backend=backend)) * \
        gmm(xs, p.w_up, group_sizes, backend=backend)
    out = gmm(h.to(xs.dtype), p.w_down, group_sizes,
              backend=backend)                                # (T*k, d)

    w = gates.reshape(-1)[order].to(out.dtype)
    back = torch.argsort(order)            # sorted row of each (token, slot)
    return (out * w[:, None])[back].reshape(T, k, d).sum(dim=1)
