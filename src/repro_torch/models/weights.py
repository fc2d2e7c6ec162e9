"""Parameters of the port's decoder: drawn from a seed, or loaded from
the JAX model's parameter tree.

``from_jax_params`` takes the tree ``repro.models.transformer.init_params``
builds — nested dicts with the layers stacked on a leading (L, ...) axis,
and an MoE config's leading dense layers as a list of unstacked dicts —
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
from repro_torch.models.layers import trunc_normal
from repro_torch.models.transformer import Transformer


def numpy_to_torch(a) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 included) as a CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def jax_leaf(tree: Mapping[str, Any], name: str):
    """``layers.3.moe.shared.w_up`` -> tree["layers"]["moe"]["shared"]
    ["w_up"][3] (stacked); ``first_layers.0.attn.wq`` ->
    tree["first_layers"][0]["attn"]["wq"] (a list of unstacked layers)."""
    parts = name.split(".")
    if parts[0] == "layers":
        node = tree["layers"]
        for p in parts[2:]:
            node = node[p]
        return np.asarray(node)[int(parts[1])]
    node = tree
    for p in parts:
        node = node[int(p)] if isinstance(node, (list, tuple)) else node[p]
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
    std 0.02 for the embedding and fan-in^-0.5 for every matrix, the fan-in
    being the input axis of the module's own ``x @ w`` (``shape[-2]``):
    d for QKV, MLP and expert inputs, the router and an untied
    unembedding; q_dim for the attention output; the layer's own hidden
    width for a down projection (d_ff, the first dense layers' dense_d_ff,
    the experts' moe_d_ff, the shared experts' moe_d_ff * n_shared).  Each
    leaf is drawn in f32 and cast to its parameter's dtype (the router
    stays f32).  Zero biases; unit norms."""
    model = Transformer(cfg, device=device)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.ndim >= 2:
            std = 0.02 if leaf == "embed" else p.shape[-2] ** -0.5
            p.copy_(trunc_normal(p.shape, std, p.dtype, generator=generator,
                                 device=device))
        elif leaf in ("scale", "q_norm", "k_norm"):
            p.fill_(1.0)
        else:                                   # biases
            p.zero_()
    return model
