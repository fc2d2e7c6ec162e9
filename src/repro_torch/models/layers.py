"""Shared neural-net layers: norms, RoPE, MLPs, embeddings, chunked loss.

The port's counterpart of ``repro.models.layers``.  Each layer is an ``nn.Module``
that holds its parameters in the JAX package's layout (``x @ w`` with
``w`` of shape (in, out)), and a plain function on tensors that applies
it, taking the module as ``p`` as the JAX functions take a dict.
``seq_shard_constraint`` is dropped: it constrains GSPMD sharding and is
a no-op on one device.  On a mesh (``DTensor`` parameters) the outputs of
the row-parallel products and the vocab-parallel lookup are reduced where
the reference's GSPMD reduces them (:func:`reduced`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import as_dtensor


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


def reduced(x):
    """Megatron's all-reduce at the end of a row-parallel product: a
    ``DTensor`` holding partial sums (a product over a dim sharded on the
    ``model`` axis, a vocab-parallel lookup) made whole; any other tensor
    as it is.  Left partial, ``DTensor`` would fold the sums into the
    residual add by a reduce-scatter along the sequence, and the next
    layer's flattened (batch x sequence) rows would be sharded on two mesh
    dims at once, which its matmuls do not take."""
    d = as_dtensor(x)
    if d is None:
        return x
    from torch.distributed.tensor import Partial
    if not any(isinstance(p, Partial) for p in d.placements):
        return x
    return _Reduced.apply(x)


class _Reduced(torch.autograd.Function):
    """The all-reduce of partial sums; its backward hands the gradient on
    replicated, as Megatron's does (each partial term's gradient is the
    whole sum's), rather than as partial sums that the product before
    would then meet with its operand gathered."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Partial, Replicate
        return x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in x.placements])

    @staticmethod
    def backward(ctx, g):
        return g


class _SameLayoutGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements)


def same_layout_grad(x):
    """``x`` (a ``DTensor``), whose gradient comes back in ``x``'s own
    placements, its partial sums reduced: the backward's counterpart of
    :func:`reduced` (Megatron's identity-forward, all-reduce-backward
    operator) where the gradients of several readers meet.  A plain
    tensor is returned as it is."""
    if as_dtensor(x) is None:
        return x
    return _SameLayoutGrad.apply(x)


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
    """The norm of ``x``.  On a mesh its output, the input of the next
    tensor-parallel product, takes its gradient back whole in its own
    layout (``same_layout_grad``: Megatron's all-reduce of the column-
    parallel input's gradient), so that the row-parallel output before it
    meets a replicated gradient."""
    return same_layout_grad(_norm(p, cfg, x))


def _norm(p: RMSNorm, cfg: ModelConfig, x):
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
    y = reduced(h @ p.w_down)
    if cfg.mlp_bias:
        y = y + p.b_down
    return y


# ---------------------------------------------------------------------------
# Embedding / unembedding with chunked fused loss
# ---------------------------------------------------------------------------

def embed_apply(p, cfg: ModelConfig, tokens):
    """The embedding rows of ``tokens`` (``F.embedding``: on one device the
    rows ``p.embed[tokens]``, and the op a mesh takes too, so the two
    differentiate alike).  On a mesh the table's rows (the vocabulary) may
    be sharded: each rank looks up the rows it holds (a partial sum), and
    the result is laid out as the tokens are (sharded on their batch,
    replicated elsewhere)."""
    h = F.embedding(tokens, p.embed)
    if as_dtensor(tokens) is not None:
        h = h.redistribute(h.device_mesh, tokens.placements)
    return h.to(dt(cfg.dtype))


def unembed_matrix(p, cfg: ModelConfig):
    return p.embed.T if cfg.tie_embeddings else p.unembed


def logits_apply(p, cfg: ModelConfig, h):
    """f32 logits, as every caller of the JAX package asks for them."""
    w = _vocab_split(unembed_matrix(p, cfg), h)
    return (h @ w.to(h.dtype)).float()


def _vocab_split(w, h):
    """The unembedding ``w`` (d, V) as the product with ``h`` takes it.  On
    a mesh whose ``model`` axis the rules leave off the vocabulary (the
    reference's rule shards it there only where V divides the axis) while
    ``h`` is replicated over that axis, the vocabulary is split over it
    all the same, in DTensor's uneven chunks: a vocab-parallel
    unembedding, each rank's logits a slice of the vocabulary, that needs
    no padding.  Anything else is returned as it is."""
    dw, dh = as_dtensor(w), as_dtensor(h)
    if dw is None or dh is None:
        return w
    from torch.distributed.tensor import Replicate, Shard
    mesh = dw.device_mesh
    names = mesh.mesh_dim_names or ()
    if "model" not in names:
        return w
    m = names.index("model")
    if (mesh.size(m) == 1 or not isinstance(dw.placements[m], Replicate)
            or not isinstance(dh.placements[m], Replicate)):
        return w
    pl = list(dw.placements)
    pl[m] = Shard(w.ndim - 1)
    return dw.redistribute(mesh, pl)


def softmax_xent(logits, targets, mask):
    """Masked cross-entropy: (sum of the masked rows' nll, sum of the mask).
    logits: (..., V), taken in f32; targets int; mask {0,1}."""
    logits = logits.float()
    if _vocab_dims(logits):
        return _xent_vocab_parallel(logits, targets, mask)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return nll.sum(), mask.sum()


def _vocab_dims(logits) -> list:
    """The mesh dims that shard a ``DTensor``'s last (vocabulary) dim."""
    if as_dtensor(logits) is None:
        return []
    from torch.distributed.tensor import Shard
    last = logits.ndim - 1
    return [m for m, p in enumerate(logits.placements)
            if isinstance(p, Shard) and p.dim == last]


def _xent_vocab_parallel(logits, targets, mask):
    """:func:`softmax_xent` of logits whose vocabulary is sharded over the
    mesh (a vocab-parallel unembedding), Megatron's way: each rank takes
    the max, the sum of exponentials and the target's logit over its own
    slice of the vocabulary, and the three are reduced over the vocabulary
    axes (max, sum, sum); the logits are never gathered."""
    from torch.distributed.tensor import Partial, Replicate
    from repro_torch.kernels.common import from_local
    mesh = logits.device_mesh
    vd = _vocab_dims(logits)
    rows = [Replicate() if m in vd else p
            for m, p in enumerate(logits.placements)]
    shape = tuple(logits.shape[:-1])
    ll = logits.to_local()
    V_l = ll.shape[-1]
    coord = mesh.get_coordinate()
    lo = _shard_offset(logits.shape[-1], [(mesh.size(m), coord[m])
                                          for m in vd])

    def over_vocab(t, op):
        part = [Partial(op) if m in vd else p for m, p in enumerate(rows)]
        return from_local(t, mesh, part, shape).redistribute(mesh, rows)

    m_l = ll.detach().amax(dim=-1)
    m = over_vocab(m_l, "max").to_local()
    se = over_vocab(torch.exp(ll - m[..., None]).sum(dim=-1), "sum")
    t = targets.redistribute(mesh, rows).to_local().long() - lo
    inside = (t >= 0) & (t < V_l)
    g_l = torch.gather(ll, -1, t.clamp(0, V_l - 1)[..., None])[..., 0]
    gold = over_vocab(torch.where(inside, g_l, torch.zeros_like(g_l)), "sum")
    lse = from_local(m, mesh, rows, shape) + torch.log(se)
    nll = (lse - gold) * mask
    return nll.sum(), mask.sum()


def _shard_offset(size: int, splits) -> int:
    """Where a rank's slice of a dim of ``size`` starts, the dim sharded
    over ``splits`` ((ranks, this rank's coordinate) per mesh dim, in mesh
    order) as DTensor nests its chunks: ceil(size / ranks) each, the last
    ones short."""
    lo = 0
    for n, c in splits:
        step = -(-size // n)
        lo += min(c * step, size)
        size = max(0, min(step, size - c * step))
    return lo


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
