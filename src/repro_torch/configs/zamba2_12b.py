"""zamba2-1.2b — hybrid, 38 Mamba2 layers + one *shared* attention block.

d_model=2048, shared block: 32H (MHA kv=32) d_ff=8192; ssm_state=64,
vocab=32000.  The shared transformer block's weights are tied across all of its
applications (every ``attn_every`` Mamba2 layers) — the Zamba2 parameter-sharing
trick.  [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32_000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_ngroups=1,
    attn_every=6,            # shared attention block applied every 6 mamba layers
    rope_theta=10_000.0,
    norm_type="rmsnorm",
    norm_eps=1e-5,
    mlp_act="gelu",
    tie_embeddings=True,
    source="arXiv:2411.15242",
)
