"""Gradient accumulation (microbatching) over the loss function.

Counterpart of ``repro.optim.grad_accum``: slices the step's batch into
``n`` microbatches along the batch axis and accumulates mean gradients,
which bounds activation memory for the big train cells (the microbatch
count is an ``ExecConfig`` lever).  The reference's scan is a Python loop
here, each microbatch's gradient added into the accumulator before the
next one runs.

Each microbatch's forward and backward are device spans (``train.forward``,
``train.backward``; ``telemetry/device.py``): under remat the recompute
falls in the backward.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch import nn

from repro_torch.telemetry.device import device_span


def _grads(loss_fn: Callable, params: nn.Module, batch):
    """(loss, metrics, gradients in parameter order) of one batch; a
    parameter the loss does not reach gets zeros, as in JAX."""
    ps = list(params.parameters())
    device = ps[0].device
    with device_span("train.forward", device):
        loss, metrics = loss_fn(params, batch)
    with device_span("train.backward", device):
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for g, p in zip(gs, ps)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, gs


def accumulate_grads(loss_fn: Callable, params: nn.Module,
                     batch: Dict[str, Any], n_micro: int,
                     accum_dtype=torch.float32):
    """loss_fn(params, batch) -> (loss, metrics).  Returns (grads, loss,
    metrics): grads maps each parameter's name to its gradient (its own
    dtype for one microbatch, ``accum_dtype`` over several), loss is the
    microbatches' mean, metrics the last one's.  The parameters must
    require grad (``models.weights.trainable``).

    ``accum_dtype=torch.bfloat16`` halves accumulator memory — the lever
    that lets the 1T-param config fit (paper-style SGD tolerates the
    precision)."""
    names = [n for n, _ in params.named_parameters()]
    if n_micro <= 1:
        loss, metrics, gs = _grads(loss_fn, params, batch)
        return dict(zip(names, gs)), loss, metrics
    mb = next(iter(batch.values())).shape[0] // n_micro
    acc = loss_sum = None
    for i in range(n_micro):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, metrics, gs = _grads(loss_fn, params, micro)
        if acc is None:
            # the first microbatch's gradients are the accumulator (0 + g
            # is g exactly), so no zero-filled set of leaves is held
            acc, loss_sum = _owned(gs, accum_dtype), loss.float()
        else:
            # a gradient that widens exactly into the accumulator's dtype
            # is added as it is (the add promotes it element by element,
            # so no cast copy of every leaf is held); one that narrows is
            # cast first, as the reference does
            torch._foreach_add_(acc, [
                g if torch.promote_types(g.dtype, accum_dtype) == accum_dtype
                else g.to(accum_dtype) for g in gs])
            loss_sum = loss_sum + loss
        del gs
    torch._foreach_div_(acc, n_micro)
    return dict(zip(names, acc)), loss_sum / n_micro, metrics


def _owned(gs, dtype):
    """``gs`` in ``dtype`` as tensors that may be added into in place:
    autograd may hand back a broadcast view, or one tensor (or one
    storage) for two parameters, and those are copied."""
    out, seen = [], set()
    for g in gs:
        g = g.to(dtype)
        ptr = g.untyped_storage().data_ptr()
        if not g.is_contiguous() or ptr in seen:
            g = g.clone(memory_format=torch.contiguous_format)
            ptr = g.untyped_storage().data_ptr()
        seen.add(ptr)
        out.append(g)
    return out
