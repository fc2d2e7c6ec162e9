"""Base configuration dataclasses (a copy of ``repro.configs.base``).

Every assigned architecture is expressed as a :class:`ModelConfig`.  The config is a
frozen dataclass so it can be used as a cache key for Proto-Faaslet executable
snapshots (see ``core/proto.py``) and hashed into dry-run artifact names.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters.

    ``family`` selects the block structure:
      * ``dense``  — decoder-only transformer (GQA attention + gated MLP)
      * ``moe``    — decoder-only with mixture-of-experts MLPs
      * ``ssm``    — attention-free Mamba2 (SSD) stack
      * ``hybrid`` — Mamba2 backbone with a *shared* attention block applied
                     every ``attn_every`` layers (Zamba2 style)
      * ``encdec`` — encoder/decoder transformer (Whisper style); the audio conv
                     frontend is a stub: ``input_specs`` supplies frame embeddings
      * ``vlm``    — decoder-only LM consuming stubbed vision patch embeddings
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads

    # --- attention options ---------------------------------------------------
    qkv_bias: bool = False
    o_bias: bool = False
    qk_norm: bool = False              # Qwen3-style per-head RMSNorm on q/k
    rope_theta: float = 10_000.0
    use_rope: bool = True
    causal: bool = True

    # --- norms / MLP ----------------------------------------------------------
    norm_type: str = "rmsnorm"         # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    mlp_act: str = "silu"              # "silu" (gated) | "gelu" (plain 2-matrix)
    mlp_bias: bool = False
    tie_embeddings: bool = False

    # --- MoE ------------------------------------------------------------------
    n_experts: int = 0                 # routed experts (0 = dense MLP)
    experts_per_token: int = 0         # top-k
    n_shared_experts: int = 0          # always-on experts (DeepSeek style)
    moe_d_ff: int = 0                  # per-expert hidden size (fine-grained MoE)
    first_k_dense: int = 0             # leading layers with a dense MLP
    dense_d_ff: int = 0                # hidden size of those dense layers
    router_aux_coef: float = 0.001     # load-balance aux loss coefficient
    capacity_factor: float = 1.25      # EP dispatch capacity factor

    # --- SSM (Mamba2 / SSD) -----------------------------------------------------
    ssm_state: int = 0                 # N: state dimension per head
    ssm_headdim: int = 64              # P: channels per SSD head
    ssm_expand: int = 2                # d_inner = expand * d_model
    ssm_conv: int = 4                  # depthwise causal conv width
    ssm_ngroups: int = 1               # B/C groups
    ssm_chunk: int = 256               # SSD chunk length

    # --- hybrid (Zamba2) --------------------------------------------------------
    attn_every: int = 0                # shared attn block applied every k layers

    # --- encoder/decoder (Whisper) ----------------------------------------------
    n_enc_layers: int = 0
    n_frames: int = 0                  # encoder sequence length (post-conv stub)

    # --- VLM ----------------------------------------------------------------------
    n_image_tokens: int = 0            # stubbed ViT patch embeddings prepended

    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    max_seq_len: int = 1 << 19

    # --- provenance -------------------------------------------------------------
    source: str = ""

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- derived quantities ----------------------------------------------------

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch supports 500k-token decode (SSM or hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    # -- parameter counting (used for 6·N·D roofline MODEL_FLOPS) ---------------

    def _attn_params(self) -> int:
        p = self.d_model * (self.q_dim + 2 * self.kv_dim)       # QKV
        p += self.q_dim * self.d_model                           # O
        if self.qkv_bias:
            p += self.q_dim + 2 * self.kv_dim
        if self.qk_norm:
            p += 2 * self.head_dim
        return p

    def _dense_mlp_params(self, d_ff: int) -> int:
        if self.mlp_act == "silu":                               # gated: 3 matrices
            return 3 * self.d_model * d_ff
        return 2 * self.d_model * d_ff                           # plain: 2 matrices

    def _expert_params(self) -> int:
        return 3 * self.d_model * self.moe_d_ff                  # gated expert

    def _ssm_params(self) -> int:
        d_in, N, H = self.d_inner, self.ssm_state, self.ssm_nheads
        G = self.ssm_ngroups
        zxbcdt = self.d_model * (2 * d_in + 2 * G * N + H)       # fused in-proj
        conv = self.ssm_conv * (d_in + 2 * G * N)
        extra = 2 * H + d_in                                      # A_log, D, gate norm
        out = d_in * self.d_model
        return zxbcdt + conv + extra + out

    def _norm_params(self) -> int:
        mult = 2 if self.norm_type == "layernorm" else 1
        return mult * self.d_model

    def layer_params(self, layer_idx: int) -> int:
        """Parameter count of one block (routed + shared experts included)."""
        if self.family in ("ssm",):
            return self._ssm_params() + self._norm_params()
        if self.family == "hybrid":
            return self._ssm_params() + self._norm_params()
        p = self._attn_params() + 2 * self._norm_params()
        if self.n_experts and layer_idx >= self.first_k_dense:
            p += self.n_experts * self._expert_params()
            p += self.n_shared_experts * self._expert_params()
            p += self.d_model * self.n_experts                   # router
        elif self.n_experts:
            p += self._dense_mlp_params(self.dense_d_ff or self.d_ff)
        else:
            p += self._dense_mlp_params(self.d_ff)
        return p

    def param_count(self) -> int:
        """Total parameters N."""
        p = self.vocab_size * self.d_model                        # embed
        if not self.tie_embeddings:
            p += self.vocab_size * self.d_model                   # unembed
        p += self._norm_params()                                  # final norm
        p += sum(self.layer_params(i) for i in range(self.n_layers))
        if self.family == "hybrid" and self.attn_every:
            # one *shared* attention+MLP block (counted once: weights are tied)
            p += self._attn_params() + self._dense_mlp_params(self.d_ff)
            p += 2 * self._norm_params()
        if self.family == "encdec":
            enc_layer = self._attn_params() + self._dense_mlp_params(self.d_ff) \
                + 2 * self._norm_params()
            p += self.n_enc_layers * enc_layer
            # decoder cross-attention
            p += self.n_layers * (self._attn_params() + self._norm_params())
            p += self.n_frames * self.d_model                     # enc positions
            p += self.max_decoder_positions() * self.d_model      # dec positions
        return p

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top-k routed only)."""
        if not self.n_experts:
            n = self.param_count()
            if self.family == "hybrid":
                return n
            return n
        dense = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            dense += self.vocab_size * self.d_model
        dense += self._norm_params()
        for i in range(self.n_layers):
            dense += self._attn_params() + 2 * self._norm_params()
            if i < self.first_k_dense:
                dense += self._dense_mlp_params(self.dense_d_ff or self.d_ff)
            else:
                k = self.experts_per_token + self.n_shared_experts
                dense += k * self._expert_params()
                dense += self.d_model * self.n_experts
        return dense

    def max_decoder_positions(self) -> int:
        return 448 if self.family == "encdec" else self.max_seq_len

    def with_overrides(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Input-shape configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (seq_len, global_batch) workload cell."""

    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int         # train/prefill: tokens processed; decode: KV cache length
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch          # one new token per sequence
        return self.global_batch * self.seq_len


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell is runnable; reason when skipped.

    ``long_500k`` needs sub-quadratic sequence mixing — skipped for pure
    full-attention archs per the assignment (documented in DESIGN.md).
    """
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "long_500k skipped: pure full-attention arch (no sub-quadratic path)"
    return True, ""
