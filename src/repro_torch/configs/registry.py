"""Architecture registry: ``--arch <id>`` lookup, smoke-config reduction.

The port's copy of ``repro.configs.registry``.  It holds only the
architectures the port can build (the dense and MoE decoders); the others
join with the slices that port their families (ROADMAP "Modules to port").
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ModelConfig

from repro_torch.configs.qwen15_05b import CONFIG as _QWEN15
from repro_torch.configs.deepseek_moe_16b import CONFIG as _DSMOE

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in (_QWEN15, _DSMOE)}


def arch_ids() -> List[str]:
    return list(ARCHS.keys())


def get_config(arch_id: str) -> ModelConfig:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {', '.join(ARCHS)}") from None


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (one fwd/train step)."""
    cfg = get_config(arch_id)
    kw = dict(
        name=f"{cfg.name}-smoke",
        n_layers=min(cfg.n_layers, 3),
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=257,
        max_seq_len=1 << 12,
    )
    if cfg.n_heads:
        kw.update(
            n_heads=4,
            n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads),
            head_dim=16,
        )
    if cfg.n_experts:
        kw.update(n_experts=8, experts_per_token=2,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  moe_d_ff=32, d_ff=32, dense_d_ff=96,
                  first_k_dense=min(cfg.first_k_dense, 1),
                  capacity_factor=8.0)   # effectively dropless at smoke scale
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    if cfg.family == "hybrid":
        kw.update(attn_every=2, n_layers=4)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, n_frames=8, n_layers=2)
    if cfg.family == "vlm":
        kw.update(n_image_tokens=4)
    return cfg.with_overrides(**kw)
