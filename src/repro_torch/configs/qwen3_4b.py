"""qwen3-4b — dense, 36L d2560 32H (GQA kv=8) d_ff=9728 vocab=151936.

QK-norm (per-head RMSNorm on q and k), head_dim=128 as published (explicit, not
d_model/n_heads).  [hf:Qwen/Qwen3-4B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    norm_eps=1e-6,
    mlp_act="silu",
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-4B",
)
