"""Parameters of the port's models: drawn from a seed, loaded from the JAX
model's parameter tree, or written back to that tree's layout.

``from_jax_params`` takes the tree ``repro.models.transformer``,
``repro.models.ssm_stack`` or ``repro.models.encdec``'s ``init_params``
builds — nested dicts with each stack's layers (``layers``, and an
encoder's ``encoder/layers``) stacked on a leading (L, ...) axis, and an
MoE config's leading dense layers as a list of unstacked dicts — as numpy
arrays
(``np.asarray`` of each JAX leaf), so the two packages can run the same
weights.  ``init_params`` draws fresh weights with the JAX
package's distributions from a ``torch.Generator``: ``jax.random`` streams
cannot be reproduced in torch, so it matches them in distribution only.
``to_jax_params`` is the inverse of ``from_jax_params`` (the tests
compare gradients leaf by leaf through it, the checkpointer writes the
reference's layout with it), and ``trainable`` turns on the gradients of
a model's parameters for the training path: serving's stay off, so its
captured graphs record no autograd.

None of them imports ``ml_dtypes``: a bf16 leaf is recognised by its
dtype's name and reinterpreted through its 16-bit pattern, which is how
``torch.from_numpy`` can take it, and it leaves as :class:`Bits`.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import as_dtensor
from repro_torch.models.layers import trunc_normal
from repro_torch.models.model import build_model


def params_class(cfg: ModelConfig):
    """The ``nn.Module`` that holds ``cfg``'s parameters: the ``Params`` of
    its family's module (``model._FAMILY_MODULES``)."""
    return build_model(cfg)._mod.Params


class Bits(NamedTuple):
    """A leaf whose dtype numpy has only through ``ml_dtypes`` (bf16): its
    bit pattern as uint16 and the dtype's name, as the reference's
    checkpointer stores it."""
    bits: np.ndarray
    dtype: str


def numpy_to_torch(a) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 included) or :class:`Bits` as a
    CPU tensor."""
    if isinstance(a, Bits):
        if a.dtype != "bfloat16":
            raise ValueError(f"no torch dtype for {a.dtype} bits")
        return torch.from_numpy(np.array(a.bits, dtype=np.uint16).view(
            np.int16)).view(torch.bfloat16)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def torch_to_numpy(t: torch.Tensor) -> Union[np.ndarray, Bits]:
    """A copy of a tensor on the host: a numpy array, or :class:`Bits` for
    bf16 (a ``DTensor`` gathered whole first)."""
    if as_dtensor(t) is not None:
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return Bits(t.view(torch.int16).numpy().view(np.uint16), "bfloat16")
    return t.numpy()


def _stacked_at(parts) -> int:
    """Where a parameter name indexes a stacked stack (``layers.3.…``,
    ``encoder.layers.3.…``): the position of that index, else -1.  An MoE
    config's ``first_layers`` are a list, not a stack."""
    for j in range(len(parts) - 1):
        if parts[j] == "layers" and parts[j + 1].isdigit():
            return j + 1
    return -1


def jax_leaf(tree: Mapping[str, Any], name: str):
    """``layers.3.moe.shared.w_up`` -> tree["layers"]["moe"]["shared"]
    ["w_up"][3] (stacked; ``encoder.layers.3.attn.wq`` likewise under
    tree["encoder"]["layers"]); ``first_layers.0.attn.wq`` ->
    tree["first_layers"][0]["attn"]["wq"] (a list of unstacked layers)."""
    parts = name.split(".")
    j = _stacked_at(parts)
    node = tree
    for p in (parts if j < 0 else parts[:j] + parts[j + 1:]):
        node = node[int(p)] if isinstance(node, (list, tuple)) else node[p]
    if j < 0:
        return node
    i = int(parts[j])
    if isinstance(node, Bits):
        return Bits(node.bits[i], node.dtype)
    return np.asarray(node)[i]


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy the JAX tree's values into ``model``'s parameters, in place."""
    for name, p in model.named_parameters():
        src = numpy_to_torch(jax_leaf(tree, name))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX leaf {tuple(src.shape)} vs "
                             f"port {tuple(p.shape)}")
        p.copy_(src.to(p.dtype))
    return model


def from_jax_params(tree: Mapping[str, Any], cfg: ModelConfig, device):
    """The model of ``cfg``'s family (:func:`params_class`) on ``device``,
    holding the JAX tree's values."""
    return load_jax_params(params_class(cfg)(cfg, device=device), tree)


def _stack(leaves):
    if isinstance(leaves[0], Bits):
        return Bits(np.stack([b.bits for b in leaves]), leaves[0].dtype)
    return np.stack(leaves)


def _lists(node):
    """Nested dicts whose keys are all digits become lists."""
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def to_jax_params(params, cfg: ModelConfig) -> dict:
    """The inverse of :func:`from_jax_params`: the reference's parameter
    tree of ``cfg``'s family, with numpy leaves (bf16 ones as
    :class:`Bits`), from a model (:func:`params_class`) or from a mapping
    of its parameter names to tensors (its gradients, say).  Each stack's
    layers are stacked on a leading (L, ...) axis, an MoE config's leading
    dense layers kept as a list, and the keys are the reference's."""
    named = dict(params.named_parameters() if isinstance(params, nn.Module)
                 else params.items())
    want = [n for n, _ in params_class(cfg)(cfg, device="meta")
            .named_parameters()]
    if sorted(named) != sorted(want):
        raise ValueError(f"{cfg.name}: {sorted(set(named) ^ set(want))} "
                         f"not both in the model and in what was given")
    tree, stacks = {}, {}
    for name in want:
        parts = name.split(".")
        leaf = torch_to_numpy(named[name])
        j = _stacked_at(parts)
        if j >= 0:            # layer by layer, in order: stacked below
            stacks.setdefault(tuple(parts[:j] + parts[j + 1:]), []).append(leaf)
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    for path, leaves in stacks.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _stack(leaves)
    return _lists(tree)


def trainable(params: nn.Module) -> nn.Module:
    """Turn on the gradients of every parameter of ``params`` (the training
    path; the parameters are made with them off)."""
    for p in params.parameters():
        p.requires_grad_(True)
    return params


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    """Random weights as ``repro.models`` draws them: truncated normals with
    std 0.02 for the embedding and fan-in^-0.5 for every matrix, the fan-in
    being the input axis of the module's own ``x @ w`` (``shape[-2]``):
    d for QKV, MLP and expert inputs, the router, an untied unembedding
    and a Mamba2 in-projection; q_dim for the attention output; the
    layer's own hidden width for a down projection (d_ff, the first dense
    layers' dense_d_ff, the experts' moe_d_ff, the shared experts'
    moe_d_ff * n_shared, a Mamba2 out-projection's d_inner).  Each leaf is
    drawn in f32 and cast to its parameter's dtype (the router, ``A_log``,
    ``dt_bias`` and ``D`` stay f32).  Zero biases; unit norms.  A Mamba2
    block follows ``repro.models.ssm.mamba_init``: its conv taps at std
    0.1, ``A_log = log U(1, 16)``, ``D`` and ``norm_scale`` 1,
    ``dt_bias`` and ``conv_b`` 0."""
    model = params_class(cfg)(cfg, device=device)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "conv_w":
            p.copy_(trunc_normal(p.shape, 0.1, p.dtype, generator=generator,
                                 device=device))
        elif leaf == "A_log":
            u = torch.rand(p.shape, generator=generator, device=device,
                           dtype=torch.float32)
            p.copy_(torch.log(1.0 + 15.0 * u))
        elif p.ndim >= 2:
            std = 0.02 if leaf == "embed" else p.shape[-2] ** -0.5
            p.copy_(trunc_normal(p.shape, std, p.dtype, generator=generator,
                                 device=device))
        elif leaf in ("scale", "q_norm", "k_norm", "D", "norm_scale"):
            p.fill_(1.0)
        else:                                   # biases, dt_bias, conv_b
            p.zero_()
    return model
