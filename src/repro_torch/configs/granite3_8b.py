"""granite-3-8b — dense, 40L d4096 32H (GQA kv=8) d_ff=12800 vocab=49155.

GQA, RMSNorm, gated SiLU MLP.  [hf:ibm-granite/granite-3.0-8b-base; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12_800,
    vocab_size=49_155,
    rope_theta=10_000.0,
    norm_type="rmsnorm",
    norm_eps=1e-5,
    mlp_act="silu",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-8b-base",
)
