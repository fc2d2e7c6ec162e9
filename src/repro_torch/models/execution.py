"""Execution configuration: knobs that change *how* a model runs, not *what*.

The port's trimmed copy of ``repro.models.execution``.  Kept, with the
reference's defaults and meanings: the kernel backend, the MoE dispatch
knobs and the training knobs (remat policy, loss chunking, microbatching,
the gradient accumulator's dtype).  Causal q-bucketing (``attn_buckets``)
is a TPU detail the port drops: the CUDA flash kernel already stops each
query tile at its causal limit, so bucketing would only add launches and
copies.  Logits are always f32 (``logits_f32`` is never turned off in the
JAX package).  ``scan_layers`` has no counterpart: the port walks its
layers with a Python loop, never a scan.  ``shard_activations``
constrains GSPMD's layout of the residual stream; on a mesh the port lays
it out itself (``layers.reduced`` and ``same_layout_grad``: sharded on the
batch, replicated over ``model``).  The TPU-tile knob ``attn_block_k``
has no counterpart either: the CUDA kernel picks its own
tiles, and the flash backward takes the reference's default tile of 512
keys (``kernels/flash_attention/ops.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ExecConfig:
    backend: str = "auto"            # kernel dispatch: auto (by device) | torch
    remat: str = "full"              # "none" | "full" | "dots"
    moe_impl: str = "einsum"         # "einsum" (GShard dense dispatch) | "sorted" (gmm)
    moe_decode_impl: str = "sorted"  # decode steps: "sorted" (exact) | "einsum"
    moe_capacity_override: float = 0.0   # >0 overrides cfg.capacity_factor
    moe_group_size: int = 1024       # GShard dispatch group size (tokens)
    loss_chunk: int = 512            # seq chunk for fused unembed+xent (0 = off)
    microbatches: int = 1            # gradient accumulation steps
    accum_dtype: str = "float32"     # grad-accumulator dtype (bf16 for 1T cfg)

    def with_overrides(self, **kw) -> "ExecConfig":
        return replace(self, **kw)


DEFAULT_EXEC = ExecConfig()
