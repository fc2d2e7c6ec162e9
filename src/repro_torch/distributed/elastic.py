"""Elastic rescaling: move a training state between meshes of different size.

Counterpart of ``repro.distributed.elastic``.  The checkpoint stores
host-layout leaves (the reference's tree, ``weights.to_jax_params``);
``reshard_params`` places them on a new mesh under freshly derived
``ShardingRules``, each parameter a ``DTensor`` laid out by the rules'
placements (``distribute_tensor``, every rank slicing its own shard of
the host array: nothing is broadcast) — scale from N to M hosts without
converting the checkpoint.  ``to_host`` gathers them back
(``full_tensor()``) as the reference's host tree.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ShardingRules, placements
from repro_torch.models import weights


def place_module(module: nn.Module, values: Mapping[str, torch.Tensor],
                 specs: Mapping[str, tuple], mesh) -> nn.Module:
    """Replace each parameter of ``module`` by a ``DTensor`` parameter of
    ``values[name]`` (a whole tensor on the mesh's device, in its own
    dtype) under ``specs[name]``."""
    from torch.distributed.tensor import distribute_tensor
    for name, p in list(module.named_parameters()):
        mod, _, leaf = name.rpartition(".")
        owner = module.get_submodule(mod) if mod else module
        d = distribute_tensor(values[name], mesh,
                              placements(specs[name], mesh, p.ndim),
                              src_data_rank=None)
        setattr(owner, leaf, nn.Parameter(d, requires_grad=p.requires_grad))
    return module


def _host_values(tree, cfg: ModelConfig, device) -> dict:
    """{port parameter name: tensor on ``device``} of a host tree in the
    reference's layout."""
    model = weights.params_class(cfg)(cfg, device="meta")
    return {n: weights.numpy_to_torch(weights.jax_leaf(tree, n)).to(device)
            for n, _ in model.named_parameters()}


def _module(tree, cfg: ModelConfig, specs, mesh) -> nn.Module:
    """The family's parameter module holding a host tree's values, placed
    by ``specs``."""
    module = weights.params_class(cfg)(cfg, device="meta")
    return place_module(module, _host_values(tree, cfg, mesh.device_type),
                        specs, mesh)


def reshard_params(params_host, cfg: ModelConfig, mesh, fsdp: bool = True,
                   rules: ShardingRules = None) -> nn.Module:
    """Host tree (the reference's layout, numpy leaves) -> the family's
    parameter module on ``mesh``, every parameter a ``DTensor`` placed by
    ``ShardingRules(mesh, cfg, fsdp)``."""
    rules = rules or ShardingRules(mesh, cfg, fsdp=fsdp)
    specs = rules.params_specs(weights.params_class(cfg)(cfg, device="meta"))
    return _module(params_host, cfg, specs, mesh)


def reshard_train_state(params_host, opt_state_host, cfg: ModelConfig,
                        mesh, fsdp: bool = True, rules: ShardingRules = None):
    """Reshard (params, optimizer state) for a new mesh: the optimizer
    state (a NamedTuple of the port's optimizers holding its step and host
    trees in the parameters' layout, or ``()``) follows the parameter
    specs as ``ShardingRules.opt_specs`` matches them."""
    from torch.distributed.tensor import distribute_tensor
    rules = rules or ShardingRules(mesh, cfg, fsdp=fsdp)
    params = reshard_params(params_host, cfg, mesh, rules=rules)
    shapes = type(opt_state_host)(*(
        weights.params_class(cfg)(cfg, device="meta")
        if isinstance(v, Mapping) else v for v in opt_state_host))
    fields = []
    for v, spec in zip(opt_state_host, rules.opt_specs(shapes, params)):
        if isinstance(v, Mapping):
            fields.append(_module(v, cfg, spec, mesh))
        elif isinstance(v, (np.ndarray, np.generic, torch.Tensor)):
            t = torch.as_tensor(np.asarray(v)).to(mesh.device_type)
            fields.append(distribute_tensor(
                t, mesh, placements(spec, mesh, t.ndim), src_data_rank=None))
        else:
            fields.append(v)
    return params, type(opt_state_host)(*fields)


def to_host(tree) -> Any:
    """Gather a (possibly sharded) parameter module, tensor, or mapping or
    sequence of them to host numpy: a module to the reference's tree
    (``weights.to_jax_params``), each ``DTensor`` through
    ``full_tensor()``."""
    from repro_torch.kernels.common import as_dtensor

    def full(t):
        d = as_dtensor(t)
        return d.full_tensor() if d is not None else t

    if isinstance(tree, nn.Module):
        named = {n: full(p.detach()) for n, p in tree.named_parameters()}
        return weights.to_jax_params(named, tree.cfg)
    if isinstance(tree, torch.Tensor):
        return weights.torch_to_numpy(full(tree.detach()))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, Mapping):
        return {k: to_host(v) for k, v in tree.items()}
    return tree
