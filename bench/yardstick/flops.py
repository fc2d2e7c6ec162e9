"""Model FLOPs of the benchmark's steps, from a configuration's sizes.

The frozen copy of the training phase's ``train_mfu`` formula: 6 N T for
the weights (each weight over the tokens that pass it: the tied
embedding once, as the unembedding; the hybrid's shared block once per
application), plus three times the forward's attention products (QK^T
and PV over the causal pairs) and SSD-scan products in each layer: the
backward twice the forward, no remat recompute.  The serving counts
(:func:`prefill`, :func:`decode`) are the forward's: 2 FLOPs a weight a
token, the unembedding only where logits are taken.
"""
from __future__ import annotations

import math

from bench.reference.model import param_specs
from bench.yardstick.costs import causal_pairs, ssd_flop_parts


def _numel(m: dict, prefix: str = "") -> int:
    return sum(math.prod(s.shape) for s in param_specs(m)
               if s.name.startswith(prefix))


def attn_apps(m: dict) -> int:
    """Attention calls in one forward: one a layer, or one a shared-block
    application in the hybrid."""
    if m["family"] == "hybrid":
        return -(-m["n_layers"] // m["attn_every"])
    return m["n_layers"]


def weight_params(m: dict) -> int:
    """Weights a token passes: the hybrid's shared block once per
    application."""
    n = _numel(m)
    if m["family"] == "hybrid":
        n += (attn_apps(m) - 1) * _numel(m, "shared_block.")
    return n


def ssd_forward(m: dict, B: int, S: int) -> int:
    if m["family"] != "hybrid":
        return 0
    H = m["ssm_expand"] * m["d_model"] // m["ssm_headdim"]
    Q = min(m["ssm_chunk"], max(16, 1 << (S - 1).bit_length()))
    return m["n_layers"] * sum(ssd_flop_parts(
        B, S, H, m["ssm_headdim"], m["ssm_ngroups"], m["ssm_state"], Q))


def attention_forward(m: dict, B: int, Sq: int, Sk: int) -> int:
    """QK^T and PV of every attention call of a forward over ``Sq``
    queries that follow ``Sk - Sq`` cached positions."""
    pairs = causal_pairs(Sq, Sk, True, Sk - Sq)
    return 4 * m["head_dim"] * m["n_heads"] * B * pairs * attn_apps(m)


def train_step(m: dict, B: int, S: int) -> int:
    """Model FLOPs of one training step over B rows of S tokens."""
    return 6 * weight_params(m) * B * S + 3 * (
        attention_forward(m, B, S, S) + ssd_forward(m, B, S))


def _embed(m: dict) -> int:
    return m["vocab_size"] * m["d_model"]


def prefill(m: dict, B: int, S: int) -> int:
    """A prefill of B prompts of S tokens, logits at the last position."""
    body = weight_params(m) - _embed(m)
    return 2 * body * B * S + 2 * _embed(m) * B + attention_forward(
        m, B, S, S) + ssd_forward(m, B, S)


def forward(m: dict, B: int, S: int) -> int:
    """A forward of B prompts of S tokens with logits at every position."""
    return 2 * weight_params(m) * B * S + attention_forward(
        m, B, S, S) + ssd_forward(m, B, S)


def decode(m: dict, B: int, length: int) -> int:
    """One decode step of B rows whose new token sits at position
    ``length - 1`` (so it attends to ``length`` positions)."""
    return 2 * weight_params(m) * B + attention_forward(m, B, 1, length) + (
        ssd_decode(m, B))


def ssd_decode(m: dict, B: int) -> int:
    """One state update and read per Mamba layer: 4 H P N a row."""
    if m["family"] != "hybrid":
        return 0
    H = m["ssm_expand"] * m["d_model"] // m["ssm_headdim"]
    return m["n_layers"] * 4 * B * H * m["ssm_headdim"] * m["ssm_state"]
