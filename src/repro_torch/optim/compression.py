"""Gradient/push compression for the cross-pod global-tier synchronisation.

Counterpart of ``repro.optim.compression``.  Faasm pushes deltas from the
local to the global tier; at pod scale the analogous transfer is the
cross-pod gradient/update all-reduce.  Two compressors, both with **error
feedback** (the residual of the lossy step is carried into the next push
so compression error doesn't accumulate as bias):

  * int8 per-tensor-row quantisation (the wire format of
    ``kernels/state_push``) — 4× fewer bytes than f32, ~2× vs bf16;
  * top-k sparsification — send only the k largest-magnitude entries.

As in the reference, nothing on a runtime path calls them.  The reference
maps them over a pytree; here over a mapping of names to tensors (the
gradients ``accumulate_grads`` returns).  Top-k breaks ties between equal
magnitudes by the lower index, as ``jax.lax.top_k`` does.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch
from torch import nn


class CompressionState(NamedTuple):
    residual: Dict[str, torch.Tensor]      # error feedback, f32, by name


def init_state(params_like) -> CompressionState:
    named = (params_like.named_parameters()
             if isinstance(params_like, nn.Module) else params_like.items())
    return CompressionState(residual={
        n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for n, p in named})


# -- int8 -----------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) int8 quantisation: (q, scales)."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    scale = torch.clamp(x2.abs().amax(dim=1, keepdim=True) / 127.0,
                        min=1e-12)
    q = torch.clamp(torch.round(x2 / scale), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q2 = q.reshape(-1, q.shape[-1]).float() * scale
    return q2.reshape(q.shape)


def compress_int8(grads: Mapping[str, torch.Tensor], state: CompressionState):
    """Returns (wire {name: (q, scale)}, decoded {name: f32}, new state)."""
    wire, dec, res = {}, {}, {}
    for n, g in grads.items():
        x = g.float() + state.residual[n]
        q, s = quantize_int8(x)
        wire[n] = (q, s)
        dec[n] = dequantize_int8(q, s)
        res[n] = x - dec[n]
    return wire, dec, CompressionState(residual=res)


# -- top-k ------------------------------------------------------------------------

def compress_topk(grads: Mapping[str, torch.Tensor], state: CompressionState,
                  frac: float = 0.01):
    """Keep the top ``frac`` of entries per tensor (by magnitude).  Returns
    (wire {name: (idx, vals)}, decoded {name: f32}, new state)."""
    wire, dec, res = {}, {}, {}
    for n, g in grads.items():
        x = (g.float() + state.residual[n]).reshape(-1)
        k = max(1, int(x.numel() * frac))
        idx = torch.sort(x.abs(), descending=True, stable=True)[1][:k]
        vals = x[idx]
        d = torch.zeros_like(x).index_put_((idx,), vals)
        wire[n] = (idx, vals)
        dec[n] = d.reshape(g.shape)
        res[n] = (x - d).reshape(g.shape)
    return wire, dec, CompressionState(residual=res)


def wire_bytes_int8(wire) -> int:
    return sum(q.numel() + s.numel() * 4 for q, s in wire.values())
