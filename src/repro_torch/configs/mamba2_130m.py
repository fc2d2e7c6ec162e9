"""mamba2-130m — attention-free SSD (state-space duality) stack.

24L d768, ssm_state=128, expand=2 (d_inner=1536), headdim=64 (24 SSD heads),
vocab=50280.  [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                  # attention-free, no MLP (Mamba2 block is the mixer)
    vocab_size=50_280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_ngroups=1,
    use_rope=False,
    norm_type="rmsnorm",
    norm_eps=1e-5,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
