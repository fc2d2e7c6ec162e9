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

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import as_dtensor, from_local
from repro_torch.kernels.moe_gmm import gmm
from repro_torch.models.execution import ExecConfig
from repro_torch.models.layers import empty_param, reduced, same_layout_grad


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
    if as_dtensor(idx) is None:
        ce = torch.zeros(E, dtype=torch.float32, device=x2d.device).index_add_(
            0, idx.reshape(-1),
            torch.full((idx.numel(),), 1.0 / idx.numel(), device=x2d.device))
    else:                  # tokens sharded on a mesh: no in-place scatter
        ce = _one_hot(idx.reshape(-1), E).mean(dim=0)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)
    return gates, idx.to(torch.int32), aux


def _one_hot(x, n: int):
    """``F.one_hot(x, n).float()`` by comparison with ``arange(n)``: the
    same 0/1 rows, with no data-dependent check of x's range (which a fake
    tensor cannot answer)."""
    return (x[..., None] == torch.arange(n, device=x.device)).float()


def _expert_ffn_dense(w, x_ecd):
    """x: (..., E, C, d) -> gated FFN with per-expert weights ``w`` =
    (w_gate, w_up, w_down)."""
    w_gate, w_up, w_down = w
    h = F.silu(torch.einsum("gecd,edf->gecf", x_ecd, w_gate)) * \
        torch.einsum("gecd,edf->gecf", x_ecd, w_up)
    return torch.einsum("gecf,efd->gecd", h, w_down)


def shared_expert_apply(p: MoE, x):
    s = p.shared
    h = F.silu(x @ s.w_gate) * (x @ s.w_up)
    return reduced(h @ s.w_down)


def moe_apply(p: MoE, cfg: ModelConfig, ec: ExecConfig,
              x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).

    Decode steps (S == 1) take ``ec.moe_decode_impl``, the dropless sorted
    path by default: a serving token must never be capacity-dropped."""
    B, S, d = x.shape
    x2d = same_layout_grad(x.reshape(B * S, d))
    gates, idx, aux = router_topk(p, cfg, x2d)
    impl = ec.moe_decode_impl if S == 1 else ec.moe_impl
    sharded = as_dtensor(x2d) is not None
    if impl == "sorted" and sharded:
        raise NotImplementedError(
            "moe: the sorted dispatch on a mesh would need an all-to-all of "
            "the tokens; take moe_decode_impl='einsum' (as the dry-run does)")
    if impl == "sorted":
        y2d = _moe_sorted(p, cfg, x2d, gates, idx, backend=ec.backend)
    elif sharded:
        y2d = _moe_einsum_sharded(p, cfg, ec, x2d, gates, idx)
    else:
        y2d = _moe_einsum(p, cfg, ec, x2d, gates, idx)
    if cfg.n_shared_experts:
        y2d = y2d + shared_expert_apply(p, x2d)
    return y2d.reshape(B, S, d), aux


def _moe_einsum_sharded(p: MoE, cfg: ModelConfig, ec: ExecConfig, x2d,
                        gates, idx):
    """The einsum dispatch on a mesh (``DTensor`` tokens, sharded on their
    batch axes): each rank dispatches its own tokens in groups of its own
    and runs the experts it holds (the ``model`` axis shards them: expert
    parallelism, the tokens being replicated there), so its combine is a
    partial sum over that axis, reduced as a row-parallel product's is."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x2d.device_mesh
    ws = [w.redistribute(mesh, w.placements) for w in
          (p.w_gate, p.w_up, p.w_down)]
    ep = [m for m, pl in enumerate(ws[0].placements)
          if isinstance(pl, Shard) and pl.dim == 0]
    for t in (x2d, gates, idx):
        if any(not isinstance(pl, (Replicate, Shard))
               or isinstance(pl, Shard) and pl.dim != 0
               for pl in t.placements):
            raise ValueError(f"moe: tokens placed {t.placements}; the "
                             f"dispatch takes them sharded on dim 0")
    part = [Partial() if m in ep else pl
            for m, pl in enumerate(x2d.placements)]
    x_l = same_layout_grad(x2d).to_local(grad_placements=part)
    g_l = same_layout_grad(gates).to_local(grad_placements=part)
    coord = mesh.get_coordinate()
    E_l = ws[0].to_local().shape[0]
    lo = sum(coord[m] * E_l * math.prod(mesh.size(n) for n in ep if n > m)
             for m in ep)
    y_l = _moe_einsum(p, cfg, ec, x_l, g_l, idx.to_local(),
                      experts=(lo, lo + E_l, [w.to_local() for w in ws]))
    return reduced(from_local(y_l, mesh, part, tuple(x2d.shape)))


def _moe_einsum(p: MoE, cfg: ModelConfig, ec: ExecConfig, x2d, gates, idx,
                experts=None):
    """GShard grouped capacity dispatch (one-hot einsums).  The (Gg, k*Sg,
    E, C) f32 dispatch tensors are 377 MB each at the full-width prefill
    (T 2048, C 120); each is freed as soon as its fold is taken.
    ``experts`` = (lo, hi, weights) runs experts lo..hi-1 alone, with
    those weights (a rank's expert shard): their share of the output."""
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

    oh = _one_hot(idx.reshape(Gg, Sg, k), E)
    # slot-major priority: all slot-0 choices first, then slot-1, ...
    ohf = oh.permute(0, 2, 1, 3).reshape(Gg, k * Sg, E)
    del oh
    cum = torch.cumsum(ohf, dim=1) - ohf                      # exclusive
    pos = torch.sum(cum * ohf, dim=-1)                        # (Gg, k*Sg)
    del cum
    keep = (pos < C).float()
    # a position past C has no one-hot row in the reference; ``keep``
    # zeroes it here
    pos_oh = _one_hot(pos.long().clamp(max=C - 1), C)
    disp_f = ohf[..., None] * pos_oh[:, :, None, :] * keep[..., None, None]
    del ohf, pos_oh
    # fold the k slots back onto tokens: (Gg, k, Sg, E, C) -> sum over k
    disp = disp_f.reshape(Gg, k, Sg, E, C).sum(dim=1)         # 0/1 (Gg,Sg,E,C)
    gates_f = gates.reshape(Gg, Sg, k).permute(0, 2, 1).reshape(Gg, k * Sg)
    disp_f *= gates_f[..., None, None]                        # comb_f, in place
    comb = disp_f.reshape(Gg, k, Sg, E, C).sum(dim=1)         # (Gg,Sg,E,C)
    del disp_f

    w = (p.w_gate, p.w_up, p.w_down)
    if experts is not None:
        lo, hi, w = experts
        disp, comb = disp[:, :, lo:hi], comb[:, :, lo:hi]
    xg = x2d.reshape(Gg, Sg, d)
    cdt = xg.dtype
    expert_in = torch.einsum("gsec,gsd->gecd", disp.to(cdt), xg)
    del disp
    expert_out = _expert_ffn_dense(w, expert_in)
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
