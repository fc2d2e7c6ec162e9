"""Execution configuration: knobs that change *how* a model runs, not *what*.

The port's trimmed copy of ``repro.models.execution``.  Kept: the kernel
backend.  Causal q-bucketing (``attn_buckets``) is a TPU detail the port
drops: the CUDA flash kernel already stops each query tile at its causal
limit, so bucketing would only add launches and copies.  Logits are always
f32 (``logits_f32`` is never turned off in the JAX package).  The training, MoE and sharding
knobs (remat, scan_layers, moe_*, loss_chunk, microbatches,
shard_activations, accum_dtype) arrive with the slices that use them; the
TPU-tile knob ``attn_block_k`` has no counterpart, since the CUDA kernel
picks its own tiles.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ExecConfig:
    backend: str = "auto"            # kernel dispatch: auto (by device) | torch

    def with_overrides(self, **kw) -> "ExecConfig":
        return replace(self, **kw)


DEFAULT_EXEC = ExecConfig()
