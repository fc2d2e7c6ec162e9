"""Pipeline parallelism: a GPipe-style stage splitter over a ``pipe`` mesh axis.

Counterpart of ``repro.distributed.pipeline``.  ``split_stages`` and
``pipeline_stats`` are the reference's.  ``make_pipeline_fn`` runs the
reference's rotating schedule on each rank of the ``pipe`` axis: with M
microbatches and P stages, M + P - 1 ticks; at tick t stage s works on
microbatch t - s when 0 <= t - s < M (else it passes its carry on); its
output goes to the next stage by ``dist.batch_isend_irecv`` over the
axis's group (the reference's ``ppermute``, a ring); the last stage banks
its finished microbatches, and a sum over the axis hands them to every
stage.  Bubble fraction = (P-1)/(M+P-1).

Each rank runs its own stage's layers, a Python loop where the reference
scans them: ``stage_params`` holds either the staged (P, L/P, ...) leaves
whole (the rank takes its stage's row) or ``DTensor``s sharded on dim 0
over the axis (the rank's local (1, L/P, ...) shard).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch


def split_stages(stacked_params, n_stages: int):
    """(L, ...) leaves -> (n_stages, L // n_stages, ...) leaves."""
    def reshape(x):
        L = x.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])
    return {k: reshape(v) for k, v in stacked_params.items()}


def pipeline_stats(n_stages: int, n_micro: int) -> Dict[str, float]:
    bubble = (n_stages - 1) / (n_micro + n_stages - 1)
    return {"bubble_fraction": bubble, "utilisation": 1.0 - bubble}


def make_pipeline_fn(block_fn: Callable, mesh, n_micro: int,
                     pipe_axis: str = "pipe"):
    """Returns pipelined(staged_params, h) -> h, run by every rank of the
    ``pipe_axis`` group.

    ``block_fn(carry, layer_params) -> carry`` is the per-layer function;
    ``layer_params`` maps each leaf's name to one layer's slice.  h:
    (n_micro, mb, ..., d) microbatched activations, the same on every
    stage; the result, (n_micro, mb, ..., d), is too."""
    import torch.distributed as dist
    group = mesh.get_group(pipe_axis)
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)

    def own_stage(staged_params) -> Dict[str, Any]:
        from repro_torch.kernels.common import as_dtensor
        out = {}
        for k, v in staged_params.items():
            d = as_dtensor(v)
            out[k] = d.to_local()[0] if d is not None else v[stage]
        return out

    def stage_apply(params, h_micro):
        for i in range(next(iter(params.values())).shape[0]):
            h_micro = block_fn(h_micro, {k: v[i] for k, v in params.items()})
        return h_micro

    def pipelined(staged_params, h):
        params = own_stage(staged_params)
        out_buf = torch.zeros_like(h)
        carry_in = torch.zeros_like(h[0])
        for t in range(n_micro + n_stages - 1):
            mb = t - stage                      # this stage's microbatch
            if 0 <= mb < n_micro:
                out = stage_apply(params, h[mb] if stage == 0 else carry_in)
                if stage == n_stages - 1:       # the last stage banks it
                    out_buf[mb] = out
            else:
                out = carry_in
            carry_in = torch.empty_like(out)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, out.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, carry_in, prv, group)])
            for r in reqs:
                r.wait()
        # broadcast the final microbatches from the last stage to all stages
        total = out_buf if stage == n_stages - 1 else torch.zeros_like(out_buf)
        dist.all_reduce(total, group=group)
        return total

    return pipelined
