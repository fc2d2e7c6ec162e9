"""internvl2-2b — VLM: InternLM2-1.8B language backbone + stubbed InternViT.

LM backbone: 24L d2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The vision
frontend is a STUB per the assignment: ``input_specs()`` supplies precomputed
patch embeddings (batch, 256, d_model) already projected into LM space.
[arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_553,
    n_image_tokens=256,
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    norm_eps=1e-5,
    mlp_act="silu",
    source="arXiv:2404.16821",
)
