"""Train, prefill and serve steps, on one device or placed on a mesh.

Counterpart of ``repro.launch.steps``.  ``make_train_step`` takes
gradients through ``accumulate_grads`` over ``ec.microbatches``
microbatches (accumulated in ``ec.accum_dtype``), applies the optimizer's
update and reports ``loss``, ``aux_loss`` and ``grad_norm``; the gradient
norm and the update are one device span, ``train.update``
(``telemetry/device.py``).

With ``rules=None`` a step is the one-device eager step.  With a
:class:`~repro_torch.distributed.sharding.ShardingRules` it is the
reference's sharded step: the parameters are ``DTensor``s on the rules'
mesh (``place_params``, or ``distributed.elastic.reshard_params``), each
FSDP-sharded weight gathered where a layer reads it
(``sharding.gather_on_read``); the batch and cache are placed by the
rules' batch and cache specs; every op then runs on each rank's shards,
``DTensor`` issuing the collectives.  Plain tensors met inside the step
(positions, masks) count as replicated.  The metrics come back whole.
The step itself is eager; on one card the launchers capture it as a
CUDA graph and replay it (``launch/train_graphs.py``), the counterpart of
the reference's jitted step.  The sharded step runs eagerly (a captured
sharded step is queued in ROADMAP).

``make_prefill_step``, ``make_serve_step``, ``make_step_for_shape`` and
``dummy_args`` are the factories the dry-run traces
(``launch/dryrun.py``): each returns (step, args), ``args`` holding the
meta-device stand-ins of the parameters and inputs and their specs, and
``dummy_args`` turns those into fake tensors placed on the mesh, which
allocate nothing.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict

import torch
from torch import nn

from repro_torch.configs.base import ShapeConfig
from repro_torch.models.layers import dt
from repro_torch.models.model import Model
from repro_torch.optim.grad_accum import accumulate_grads
from repro_torch.telemetry.device import device_span


def _sharded(rules):
    """The context a sharded step runs in: plain tensors that meet
    ``DTensor``s (positions, masks) count as replicated."""
    if rules is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _whole(x):
    """A metric as a plain tensor (a ``DTensor`` gathered whole)."""
    from repro_torch.kernels.common import as_dtensor
    d = as_dtensor(x)
    return d.full_tensor() if d is not None else x


def place(tensor, spec, mesh):
    """``tensor`` (whole, on every rank) as a ``DTensor`` under ``spec``;
    a ``DTensor`` is left as it is.  Each rank slices its own shard:
    nothing is broadcast."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import placements
    from repro_torch.kernels.common import as_dtensor
    if as_dtensor(tensor) is not None:
        return tensor
    return distribute_tensor(tensor, mesh,
                             placements(spec, mesh, tensor.ndim),
                             src_data_rank=None)


def place_inputs(inputs: Dict[str, Any], specs: Dict[str, Any], mesh):
    """A batch (and its ``cache``) placed by the rules' batch specs."""
    out = {}
    for k, v in inputs.items():
        if isinstance(v, dict):
            out[k] = place_inputs(v, specs[k], mesh)
        else:
            out[k] = place(v, specs[k], mesh)
    return out


def place_params(params: nn.Module, rules) -> nn.Module:
    """The parameters as ``DTensor``s placed by ``rules`` (each rank slices
    its shard of the whole tensors it holds)."""
    from repro_torch.distributed.elastic import place_module
    return place_module(params, {n: p.detach() for n, p in
                                 params.named_parameters()},
                        rules.params_specs(params), rules.mesh)


def _gathering(params: nn.Module, rules) -> None:
    """The FSDP-sharded weights of ``params`` gathered where a layer reads
    them (``sharding.gather_on_read``; a module made so stays so)."""
    from repro_torch.distributed.sharding import gather_on_read
    gather_on_read(params, rules, rules.mesh)


def make_train_step(model: Model, optimizer, shape: ShapeConfig,
                    rules=None) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), the parameters updated in place; batch holds tensors of
    ``shape``'s (global_batch, seq_len), on the parameters' device.  With
    ``rules`` the parameters must be ``DTensor``s placed by it
    (``place_params`` or ``distributed.elastic.reshard_params``; their
    FSDP-sharded weights are made to gather where read) and the batch is
    placed by its batch specs."""
    ec = model.ec
    n_micro = max(ec.microbatches, 1)
    if shape.global_batch % n_micro:
        raise ValueError(f"{shape.name}: batch {shape.global_batch} does not "
                         f"split into {n_micro} microbatches")
    accum_dtype = dt(ec.accum_dtype)

    def step(params, opt_state, batch: Dict[str, Any]):
        if batch["tokens"].shape[0] != shape.global_batch:
            raise ValueError(f"batch of {batch['tokens'].shape[0]} rows for "
                             f"{shape.name}'s {shape.global_batch}")
        if rules is not None:
            _gathering(params, rules)
            batch = place_inputs(batch, rules.batch_specs(batch), rules.mesh)
        with _sharded(rules):
            grads, loss, metrics = accumulate_grads(
                model.loss, params, batch, ec.microbatches,
                accum_dtype=accum_dtype)
            metrics = dict(metrics)
            metrics["loss"] = loss
            with device_span("train.update", batch["tokens"].device):
                metrics["grad_norm"] = torch.stack(
                    [torch.sum(torch.square(g.float()))
                     for g in grads.values()]).sum().sqrt()
                params, opt_state = optimizer.update(grads, opt_state,
                                                     params)
        if rules is not None:
            metrics = {k: _whole(v) for k, v in metrics.items()}
        return params, opt_state, metrics

    return step


def make_prefill_step(model: Model, rules, shape: ShapeConfig):
    """(step, args): step(params, tokens, cache[, extra]) -> (last-token
    logits, cache, prefix_len), the cache written in place; with ``rules``
    the inputs are placed by its batch specs."""
    input_specs = model.input_specs(shape)
    extra_key = next((k for k in ("frames", "image_embeds")
                      if k in input_specs), None)
    args = _args(model, rules, input_specs)
    args["extra_key"] = extra_key

    def step(params, tokens, cache, extra=None):
        if rules is not None:
            _gathering(params, rules)
            ins = {"tokens": tokens, "cache": cache}
            if extra is not None:
                ins[extra_key] = extra
            ins = place_inputs(ins, args["batch_specs"], rules.mesh)
            tokens, cache, extra = ins["tokens"], ins["cache"], \
                ins.get(extra_key)
        with _sharded(rules), torch.no_grad():
            logits, cache, n = model.prefill(params, tokens, cache, extra)
        return logits, cache, n
    return step, args


def make_serve_step(model: Model, rules, shape: ShapeConfig):
    """(step, args): one decode step, step(params, token, cache, index) ->
    (logits (B, V), cache), the cache written in place."""
    args = _args(model, rules, model.input_specs(shape))

    def step(params, token, cache, index):
        if rules is not None:
            _gathering(params, rules)
            ins = place_inputs({"token": token, "cache": cache,
                                "index": index}, args["batch_specs"],
                               rules.mesh)
            token, cache, index = ins["token"], ins["cache"], ins["index"]
        with _sharded(rules), torch.no_grad():
            return model.decode_step(params, token, cache, index)
    return step, args


def _args(model: Model, rules, input_specs) -> dict:
    """The stand-ins of a step's parameters and inputs and, with rules,
    their specs."""
    pshapes = model.init_shapes()
    args = {"params": pshapes, "batch": input_specs}
    if rules is not None:
        args["param_specs"] = rules.params_specs(pshapes)
        args["batch_specs"] = rules.batch_specs(input_specs)
    return args


def make_step_for_shape(model: Model, rules, shape: ShapeConfig,
                        optimizer=None):
    """Dispatch on the shape kind (train/prefill/decode): (step, args)."""
    if shape.kind == "train":
        if optimizer is None:
            raise ValueError("a train step needs an optimizer")
        args = _args(model, rules, model.input_specs(shape))
        return make_train_step(model, optimizer, shape, rules), args
    if shape.kind == "prefill":
        return make_prefill_step(model, rules, shape)
    return make_serve_step(model, rules, shape)


def dummy_args(model: Model, shape: ShapeConfig, args: Dict[str, Any],
               optimizer=None, rules=None):
    """The step's argument tuple as fake tensors (the caller's
    ``FakeTensorMode`` must be open): no allocation.  With ``rules`` each
    parameter and input is a ``DTensor`` over local fake shards of its
    spec's shape, the parameters gathered where read."""
    device = "cpu" if rules is None else rules.mesh.device_type
    params = fake_params(model, rules, device, train=shape.kind == "train")
    ins = {k: _fake_tree(v, None if rules is None else
                         args["batch_specs"][k], rules, device)
           for k, v in args["batch"].items()}
    if shape.kind == "train":
        state = optimizer.init(params)
        return params, state, ins
    if shape.kind == "prefill":
        base = (params, ins["tokens"], ins["cache"])
        if args.get("extra_key"):
            base = base + (ins[args["extra_key"]],)
        return base
    return params, ins["token"], ins["cache"], ins["index"]


def fake_params(model: Model, rules, device, train: bool = True) -> nn.Module:
    """The family's parameter module with fake leaves on ``device`` (the
    caller's ``FakeTensorMode`` open), placed by ``rules``; trainable for
    ``train``."""
    params = model._mod.Params(model.cfg, device=device)
    if rules is not None:
        params = place_params(params, rules)
    for p in params.parameters():
        p.requires_grad_(train)
    return params


def _fake_tree(v, spec, rules, device):
    if isinstance(v, dict):
        return {k: _fake_tree(x, None if spec is None else spec[k], rules,
                              device) for k, x in v.items()}
    t = torch.empty(v.shape, dtype=v.dtype, device=device)
    return t if rules is None else place(t, spec, rules.mesh)
