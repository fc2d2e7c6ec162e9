"""Mamba2 (SSD) block: fused in-projection, causal conv, SSD scan, gated norm.

Counterpart of ``repro.models.ssm``, with the same functions, signatures
and dtype rules.  The full-sequence apply dispatches to
``kernels/ssd_scan`` (the CUDA kernel K8 on the card, the chunked plain
version on the CPU); the decode step is a plain O(H·P·N) state update.
As in the reference, the prefill convolves in the activation dtype and
the decode step in f32 (rounded afterwards); dt and the gated norm are
f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd, ssd_step
from repro_torch.models.execution import ExecConfig
from repro_torch.models.layers import dt, empty_param


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
    ms = (gf * gf).mean(-1, keepdim=True)
    out = gf * torch.rsqrt(ms + cfg.norm_eps) * p.norm_scale.float()
    return out.to(y.dtype)


def _causal_conv_full(p: Mamba2, x):
    """Depthwise causal conv.  x: (B, S, C) -> (B, S, C), in x's dtype.
    Both frameworks cross-correlate: a left pad of W-1 and the taps in
    order, no flip."""
    W = p.conv_w.shape[0]
    C = x.shape[-1]
    weight = p.conv_w.to(x.dtype).T[:, None, :]                 # (C, 1, W)
    xt = F.pad(x.transpose(1, 2), (W - 1, 0))                   # (B, C, W-1+S)
    y = F.conv1d(xt, weight, groups=C).transpose(1, 2)
    return y + p.conv_b.to(x.dtype)


def mamba_apply_full(p: Mamba2, cfg: ModelConfig, ec: ExecConfig, x, *,
                     initial_state=None, return_state: bool = False):
    """x: (B, S, d).  Returns y or (y, (conv_state, ssm_state))."""
    B, S, d = x.shape
    d_in, G, N, H, P, conv_ch, proj = _dims(cfg)
    zxbcdt = x @ p.w_in
    z, conv_in, dt_raw = _split_proj(cfg, zxbcdt)
    conv_out = F.silu(_causal_conv_full(p, conv_in))
    xc, Bc, Cc = _split_conv(cfg, conv_out)

    # slices of the conv output: the kernel reads whole contiguous rows
    x_h = xc.reshape(B, S, H, P).contiguous()
    Bg = Bc.reshape(B, S, G, N).contiguous()
    Cg = Cc.reshape(B, S, G, N).contiguous()
    dts = F.softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log)

    y, final_state = ssd(x_h, dts, A, Bg, Cg, p.D, chunk=cfg.ssm_chunk,
                         initial_state=initial_state, backend=ec.backend)
    y = y.reshape(B, S, d_in)
    out = _gated_norm(p, cfg, y, z) @ p.w_out
    if return_state:
        W = cfg.ssm_conv
        tail = conv_in[:, -(W - 1):, :] if S >= W - 1 else F.pad(
            conv_in, (0, 0, W - 1 - S, 0))
        return out, (tail.to(dt(cfg.dtype)), final_state)
    return out


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
