"""whisper-tiny — encoder/decoder audio transformer backbone.

4 enc + 4 dec layers, d_model=384, 6H (MHA kv=6), d_ff=1536, vocab=51865.
The conv audio frontend is a STUB: ``input_specs()`` supplies precomputed frame
embeddings of shape (batch, 1500, 384) — per the assignment, the backbone only.
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,              # decoder layers
    n_enc_layers=4,
    n_frames=1500,           # encoder positions after the (stubbed) conv frontend
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    use_rope=False,          # whisper uses absolute positions
    qkv_bias=True,
    o_bias=True,
    norm_type="layernorm",
    norm_eps=1e-5,
    mlp_act="gelu",
    mlp_bias=True,
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
