"""starcoder2-7b — dense, 32L d4608 36H (GQA kv=4) d_ff=18432 vocab=49152.

GQA + RoPE; LayerNorm + biased plain-GELU MLP per the published model.
[arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18_432,
    vocab_size=49_152,
    qkv_bias=True,
    o_bias=True,
    rope_theta=100_000.0,
    norm_type="layernorm",
    norm_eps=1e-5,
    mlp_act="gelu",
    mlp_bias=True,
    source="arXiv:2402.19173",
)
