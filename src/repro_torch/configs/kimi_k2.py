"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table config).

61L d7168 64H (GQA kv=8, per the assigned table — the released model uses MLA;
we follow the assignment), per-expert d_ff=2048, 384 routed experts top-8 +
1 shared, first layer dense, vocab=163840.  Total ≈ 1.03 T params, ≈ 32 B active.
[arXiv:2501.kimi2; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,               # per-expert hidden (assigned table value)
    moe_d_ff=2048,
    vocab_size=163_840,
    n_experts=384,
    experts_per_token=8,
    n_shared_experts=1,
    first_k_dense=1,
    dense_d_ff=18_432,
    rope_theta=50_000.0,
    norm_type="rmsnorm",
    norm_eps=1e-6,
    mlp_act="silu",
    source="arXiv:2501.kimi2 (paper-table)",
)
