"""Architecture registry: ``--arch <id>`` lookup, smoke-config reduction.

The port's copy of ``repro.configs.registry``.  It holds the
architectures of the reference's registry: the dense decoders
(qwen1.5-0.5b, qwen3-4b, granite-3-8b, starcoder2-7b), the MoE decoders
(deepseek-moe-16b, kimi-k2), the attention-free Mamba2 stack, the Zamba2
hybrid, the whisper-tiny encoder/decoder and the internvl2-2b VLM.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

from repro_torch.configs.qwen15_05b import CONFIG as _QWEN15
from repro_torch.configs.starcoder2_7b import CONFIG as _STARCODER2
from repro_torch.configs.granite3_8b import CONFIG as _GRANITE3
from repro_torch.configs.qwen3_4b import CONFIG as _QWEN3
from repro_torch.configs.zamba2_12b import CONFIG as _ZAMBA2
from repro_torch.configs.whisper_tiny import CONFIG as _WHISPER
from repro_torch.configs.deepseek_moe_16b import CONFIG as _DSMOE
from repro_torch.configs.kimi_k2 import CONFIG as _KIMI
from repro_torch.configs.mamba2_130m import CONFIG as _MAMBA2
from repro_torch.configs.internvl2_2b import CONFIG as _INTERNVL

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (_QWEN15, _STARCODER2, _GRANITE3, _QWEN3, _ZAMBA2, _WHISPER,
              _DSMOE, _KIMI, _MAMBA2, _INTERNVL)
}


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


def get_shape(shape_id: str) -> ShapeConfig:
    try:
        return SHAPES[shape_id]
    except KeyError:
        raise KeyError(
            f"unknown shape {shape_id!r}; available: {', '.join(SHAPES)}") from None


def smoke_shape(kind: str = "train") -> ShapeConfig:
    """Tiny shape for smoke tests."""
    if kind == "train":
        return ShapeConfig("smoke_train", "train", 32, 2)
    if kind == "prefill":
        return ShapeConfig("smoke_prefill", "prefill", 32, 2)
    return ShapeConfig("smoke_decode", "decode", 32, 2)
