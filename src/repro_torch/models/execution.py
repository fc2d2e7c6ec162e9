"""Execution configuration: knobs that change *how* a model runs, not *what*.

The port's trimmed copy of ``repro.models.execution``.  Kept: the kernel
backend and the MoE dispatch knobs, with the reference's defaults and
meanings.  Causal q-bucketing (``attn_buckets``) is a TPU detail the port
drops: the CUDA flash kernel already stops each query tile at its causal
limit, so bucketing would only add launches and copies.  Logits are always
f32 (``logits_f32`` is never turned off in the JAX package).  The training
and sharding knobs (remat, scan_layers, loss_chunk, microbatches,
shard_activations, accum_dtype) arrive with the slices that use them; the
TPU-tile knob ``attn_block_k`` has no counterpart, since the CUDA kernel
picks its own tiles.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ExecConfig:
    backend: str = "auto"            # kernel dispatch: auto (by device) | torch
    moe_impl: str = "einsum"         # "einsum" (GShard dense dispatch) | "sorted" (gmm)
    moe_decode_impl: str = "sorted"  # decode steps: "sorted" (exact) | "einsum"
    moe_capacity_override: float = 0.0   # >0 overrides cfg.capacity_factor
    moe_group_size: int = 1024       # GShard dispatch group size (tokens)

    def with_overrides(self, **kw) -> "ExecConfig":
        return replace(self, **kw)


DEFAULT_EXEC = ExecConfig()
