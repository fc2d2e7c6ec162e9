"""deepseek-moe-16b — fine-grained MoE, 28L d2048 16H (MHA kv=16).

Per-expert d_ff=1408; 64 routed experts top-6 + 2 shared experts; first layer
dense (d_ff=10944); vocab=102400.  [arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,               # per-expert hidden (assigned table value)
    moe_d_ff=1408,
    vocab_size=102_400,
    n_experts=64,
    experts_per_token=6,
    n_shared_experts=2,
    first_k_dense=1,
    dense_d_ff=10_944,
    rope_theta=10_000.0,
    norm_type="rmsnorm",
    norm_eps=1e-6,
    mlp_act="silu",
    source="arXiv:2401.06066",
)
