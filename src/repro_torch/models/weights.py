"""Parameters of the port's dense decoder: drawn from a seed, or loaded from
the JAX model's parameter tree.

``from_jax_params`` takes the tree ``repro.models.transformer.init_params``
builds — nested dicts with the layers stacked on a leading (L, ...) axis —
as numpy arrays (``np.asarray`` of each JAX leaf), so the two packages can
run the same weights.  ``init_params`` draws fresh weights with the JAX
package's distributions from a ``torch.Generator``: ``jax.random`` streams
cannot be reproduced in torch, so it matches them in distribution only.

Neither imports ``ml_dtypes``: a bf16 leaf is recognised by its dtype's
name and reinterpreted through its 16-bit pattern, which is how
``torch.from_numpy`` can take it.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dt, trunc_normal
from repro_torch.models.transformer import Transformer


def numpy_to_torch(a) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 included) as a CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def jax_leaf(tree: Mapping[str, Any], name: str):
    """``layers.3.attn.wq`` -> tree["layers"]["attn"]["wq"][3]."""
    parts = name.split(".")
    if parts[0] == "layers":
        node = tree["layers"]
        for p in parts[2:]:
            node = node[p]
        return np.asarray(node)[int(parts[1])]
    node = tree
    for p in parts:
        node = node[p]
    return node


@torch.no_grad()
def from_jax_params(tree: Mapping[str, Any], cfg: ModelConfig,
                    device) -> Transformer:
    """A :class:`Transformer` on ``device`` holding the JAX tree's values."""
    model = Transformer(cfg, device=device)
    for name, p in model.named_parameters():
        src = numpy_to_torch(jax_leaf(tree, name))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX leaf {tuple(src.shape)} vs "
                             f"port {tuple(p.shape)}")
        p.copy_(src.to(p.dtype))
    return model


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Transformer:
    """Random weights as ``repro.models`` draws them: truncated normals with
    std 0.02 (embedding), d^-0.5 (QKV, MLP in, untied unembedding),
    q_dim^-0.5 (output), d_ff^-0.5 (MLP down); zero biases; unit norms."""
    model = Transformer(cfg, device=device)
    pdt = dt(cfg.param_dtype)
    d, f, qd = cfg.d_model, cfg.d_ff, cfg.q_dim
    std = {"embed": 0.02, "unembed": d ** -0.5, "wq": d ** -0.5,
           "wk": d ** -0.5, "wv": d ** -0.5, "wo": qd ** -0.5,
           "w_gate": d ** -0.5, "w_up": d ** -0.5, "w_down": f ** -0.5}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in std:
            p.copy_(trunc_normal(p.shape, std[leaf], pdt, generator=generator,
                                 device=device))
        elif leaf in ("scale", "q_norm", "k_norm"):
            p.fill_(1.0)
        else:                                   # biases
            p.zero_()
    return model
