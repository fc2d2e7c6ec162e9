"""The train step on one device.

Counterpart of ``repro.launch.steps.make_train_step``: gradients through
``accumulate_grads`` over ``ec.microbatches`` microbatches (accumulated in
``ec.accum_dtype``), the optimizer's update, and the metrics ``loss``,
``aux_loss`` and ``grad_norm``.  The reference jits the step under the
shardings of ``ShardingRules`` over a mesh; the port runs on one device
and eagerly, so the sharding rules, the mesh and the reference's
prefill/serve step factories are not ported here (ROADMAP item 8,
"Multi-device and dry-run"; serving's compiled steps are
``launch/step_graphs.py``).  A captured train step, the counterpart of
the jit, is queued in ROADMAP as well.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models.layers import dt
from repro_torch.models.model import Model
from repro_torch.optim.grad_accum import accumulate_grads


def make_train_step(model: Model, optimizer, shape: ShapeConfig) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), the parameters updated in place; batch holds tensors of
    ``shape``'s (global_batch, seq_len), on the parameters' device."""
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
        grads, loss, metrics = accumulate_grads(
            model.loss, params, batch, ec.microbatches,
            accum_dtype=accum_dtype)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = torch.stack(
            [torch.sum(torch.square(g.float())) for g in grads.values()]
        ).sum().sqrt()
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, metrics

    return step
