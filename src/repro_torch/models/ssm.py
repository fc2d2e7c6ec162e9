"""Mamba2 (SSD) block: fused in-projection, causal conv, SSD scan, gated norm.

Counterpart of ``repro.models.ssm``, with the same functions, signatures
and dtype rules.  The full-sequence apply dispatches to
``kernels/ssd_scan`` (the CUDA kernel K8 on the card, the chunked plain
version on the CPU); the decode step is a plain O(H·P·N) state update.
As in the reference, the prefill convolves in the activation dtype and
the decode step in f32 (rounded afterwards); dt and the gated norm are
f32.  On a mesh whose ``model`` axis the batch leaves idle, the
full-sequence apply splits the layer's heads over that axis (the
in-projection's columns, the conv's channels, K8's heads, the
out-projection's rows), as GSPMD splits the reference's layer there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import (as_dtensor, batch_only, from_local,
                                        local_operands)
from repro_torch.kernels.ssd_scan import ssd, ssd_step
from repro_torch.models.execution import ExecConfig
from repro_torch.models.layers import dt, empty_param, reduced


def _dims(cfg: ModelConfig):
    d_in = cfg.d_inner
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    H, P = cfg.ssm_nheads, cfg.ssm_headdim
    conv_ch = d_in + 2 * G * N
    proj = 2 * d_in + 2 * G * N + H          # [z, x, B, C, dt]
    return d_in, G, N, H, P, conv_ch, proj


def _f32_param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device),
                        requires_grad=False)


class Mamba2(nn.Module):
    """The leaves of ``repro.models.ssm.mamba_init``: ``w_in`` (d, proj),
    ``conv_w`` (W, conv_ch), ``conv_b``, ``norm_scale`` and ``w_out``
    (d_inner, d) in the parameter dtype; ``A_log`` (A = -exp(A_log)),
    ``dt_bias`` and ``D`` (H,) in f32 whatever the parameter dtype."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        d_in, G, N, H, P, conv_ch, proj = _dims(cfg)
        self.w_in = empty_param((d, proj), cfg, device)
        self.conv_w = empty_param((cfg.ssm_conv, conv_ch), cfg, device)
        self.conv_b = empty_param((conv_ch,), cfg, device)
        self.A_log = _f32_param((H,), device)
        self.dt_bias = _f32_param((H,), device)
        self.D = _f32_param((H,), device)
        self.norm_scale = empty_param((d_in,), cfg, device)
        self.w_out = empty_param((d_in, d), cfg, device)


def _split_proj(cfg: ModelConfig, zxbcdt):
    d_in, G, N, H, P, conv_ch, proj = _dims(cfg)
    z = zxbcdt[..., :d_in]
    conv_in = zxbcdt[..., d_in:d_in + conv_ch]
    dt_raw = zxbcdt[..., d_in + conv_ch:]
    return z, conv_in, dt_raw


def _split_conv(cfg: ModelConfig, conv_out):
    d_in, G, N, H, P, conv_ch, proj = _dims(cfg)
    xc = conv_out[..., :d_in]
    Bc = conv_out[..., d_in:d_in + G * N]
    Cc = conv_out[..., d_in + G * N:]
    return xc, Bc, Cc


def _gated_norm(p: Mamba2, cfg: ModelConfig, y, z):
    g = y * F.silu(z)
    gf = g.float()
    # with the heads split on a mesh the mean is a partial sum: made
    # whole here, not left for DTensor to scatter along the sequence
    ms = reduced((gf * gf).mean(-1, keepdim=True))
    out = gf * torch.rsqrt(ms + cfg.norm_eps) * p.norm_scale.float()
    return out.to(y.dtype)


def _causal_conv_full(conv_w, conv_b, x):
    """Depthwise causal conv.  x: (B, S, C) -> (B, S, C), in x's dtype.
    Both frameworks cross-correlate: a left pad of W-1 and the taps in
    order, no flip.  On a mesh each rank convolves its own rows and, where
    ``x``'s channels are split, its own channels (a channel reads only
    itself), with the taps of those channels."""
    shards = local_operands("causal_conv", (batch_only(x, 0, 2), conv_w,
                                            conv_b), (0, None, None),
                            (2, 1, 0))
    if shards is not None:
        (xl, wl, bl), mesh, pl = shards
        return from_local(_conv(xl, wl, bl), mesh, pl, x.shape)
    return _conv(x, conv_w, conv_b)


def _conv(x, conv_w, conv_b):
    W = conv_w.shape[0]
    C = x.shape[-1]
    weight = conv_w.to(x.dtype).T[:, None, :]                   # (C, 1, W)
    xt = F.pad(x.transpose(1, 2), (W - 1, 0))                   # (B, C, W-1+S)
    y = F.conv1d(xt, weight, groups=C).transpose(1, 2)
    return y + conv_b.to(x.dtype)


def mamba_apply_full(p: Mamba2, cfg: ModelConfig, ec: ExecConfig, x, *,
                     initial_state=None, return_state: bool = False):
    """x: (B, S, d).  Returns y or (y, (conv_state, ssm_state))."""
    B, S, d = x.shape
    d_in, G, N, H, P, conv_ch, proj = _dims(cfg)
    m = _heads_dim(x, H, 2 * G * N)
    if m is None:
        zxbcdt = x @ p.w_in
        z, conv_in, dt_raw = _split_proj(cfg, zxbcdt)
        conv_parts = (conv_in,)
        conv_out = F.silu(_causal_conv_full(p.conv_w, p.conv_b, conv_in))
        xc, Bc, Cc = _split_conv(cfg, conv_out)
        w_out = p.w_out
    else:
        z, xs, bc, dt_raw = _project_by_heads(p, cfg, x, m)
        conv_parts = (xs, bc)
        xc = F.silu(_causal_conv_full(p.conv_w[:, :d_in], p.conv_b[:d_in],
                                      xs))
        bcc = F.silu(_causal_conv_full(p.conv_w[:, d_in:], p.conv_b[d_in:],
                                       bc))
        Bc, Cc = bcc[..., :G * N], bcc[..., G * N:]
        w_out = _split(p.w_out, m, 0)

    # slices of the conv output: the kernel reads whole contiguous rows
    x_h = xc.reshape(B, S, H, P).contiguous()
    Bg = Bc.reshape(B, S, G, N).contiguous()
    Cg = Cc.reshape(B, S, G, N).contiguous()
    dts = F.softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log)

    y, final_state = ssd(x_h, dts, A, Bg, Cg, p.D, chunk=cfg.ssm_chunk,
                         initial_state=initial_state, backend=ec.backend)
    y = y.reshape(B, S, d_in)
    out = reduced(_gated_norm(p, cfg, y, z) @ w_out)
    if return_state:
        W = cfg.ssm_conv
        tails = [t[:, -(W - 1):, :] if S >= W - 1 else F.pad(
            t, (0, 0, W - 1 - S, 0)) for t in conv_parts]
        tail = tails[0] if len(tails) == 1 else torch.cat(tails, dim=-1)
        return out, (tail.to(dt(cfg.dtype)), final_state)
    return out


def _heads_dim(x, H: int, bc_cols: int):
    """The mesh dim a Mamba layer splits its heads over, as GSPMD splits
    the layer's work there: the ``model`` axis where ``x`` (a ``DTensor``)
    is replicated on it (the wide batch could not take it) and it divides
    the heads and B's and C's ``bc_cols`` columns.  None for a plain
    tensor, a 1-rank axis or a batch that already uses it."""
    d = as_dtensor(x)
    if d is None:
        return None
    from torch.distributed.tensor import Replicate
    mesh = d.device_mesh
    names = mesh.mesh_dim_names or ()
    if "model" not in names:
        return None
    m = names.index("model")
    n = mesh.size(m)
    if (n == 1 or H % n or bc_cols % n
            or not isinstance(d.placements[m], Replicate)):
        return None
    return m


def _split(w, m: int, dim: int):
    """``w`` (a ``DTensor``) sharded on ``dim`` over mesh dim ``m``."""
    from torch.distributed.tensor import Shard
    pl = list(w.placements)
    pl[m] = Shard(dim)
    return w.redistribute(w.device_mesh, pl)


def _project_by_heads(p: Mamba2, cfg: ModelConfig, x, m: int):
    """The in-projection with its columns split over mesh dim ``m``: z, x
    and dt each by heads (the rank's heads' columns), B and C split the
    same way and gathered (every head reads its group's whole B and C).
    Returns (z, x, B|C, dt), z, x and dt sharded on their last dim."""
    d_in, G, N, H, P, conv_ch, proj = _dims(cfg)
    w = p.w_in

    def cols(lo, hi):
        return x @ _split(w[:, lo:hi], m, 1)

    lo = 2 * d_in                              # [z, x, B, C, dt]
    bc = cols(lo, lo + 2 * G * N)
    bc = bc.redistribute(bc.device_mesh, x.placements)
    return cols(0, d_in), cols(d_in, lo), bc, cols(lo + 2 * G * N, proj)


def mamba_init_state(cfg: ModelConfig, batch: int, device=None):
    d_in, G, N, H, P, conv_ch, proj = _dims(cfg)
    return (torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                        dtype=dt(cfg.dtype), device=device),
            torch.zeros((batch, H, P, N), dtype=torch.float32, device=device))


def mamba_step(p: Mamba2, cfg: ModelConfig, state, x_t):
    """One decode step.  x_t: (B, d); state = (conv_state, ssm_state).
    Returns (y (B, d), (new_conv_state, new_ssm_state)), new tensors."""
    conv_state, ssm_state = state
    B, d = x_t.shape
    d_in, G, N, H, P, conv_ch, proj = _dims(cfg)
    zxbcdt = x_t @ p.w_in
    z, conv_in_t, dt_raw = _split_proj(cfg, zxbcdt)

    window = torch.cat([conv_state, conv_in_t[:, None, :].to(conv_state.dtype)],
                       dim=1)
    conv_out = torch.einsum("bwc,wc->bc", window.float(), p.conv_w.float())
    conv_out = F.silu(conv_out + p.conv_b.float()).to(x_t.dtype)
    new_conv_state = window[:, 1:, :]

    xc, Bc, Cc = _split_conv(cfg, conv_out)
    x_h = xc.reshape(B, H, P)
    Bg = Bc.reshape(B, G, N)
    Cg = Cc.reshape(B, G, N)
    dts = F.softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    y, new_ssm = ssd_step(ssm_state, x_h, dts, A, Bg, Cg, p.D)
    y = y.reshape(B, d_in)
    out = _gated_norm(p, cfg, y, z) @ p.w_out
    return out, (new_conv_state, new_ssm)
