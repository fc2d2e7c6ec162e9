"""Deterministic synthetic data pipeline, sharded per data-parallel rank.

Every batch is a pure function of (seed, step, shard) — restarts and elastic
rescaling replay identical data without coordination state (the pipeline
itself needs no checkpoint beyond the step counter).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class PipelineConfig:
    seed: int = 0
    n_shards: int = 1
    shard: int = 0


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))


def make_batch(cfg: ModelConfig, shape: ShapeConfig, pc: PipelineConfig,
               step: int) -> Dict[str, np.ndarray]:
    """One train batch for this shard (global_batch // n_shards rows)."""
    rng = _rng(pc.seed, step, pc.shard)
    B = shape.global_batch // pc.n_shards
    S = shape.seq_len
    St = S - cfg.n_image_tokens if cfg.family == "vlm" else S
    # Markov-ish token stream so the LM has learnable structure.
    toks = rng.integers(0, cfg.vocab_size, size=(B, St + 1), dtype=np.int64)
    repeat = rng.random((B, St + 1)) < 0.5
    for t in range(1, St + 1):
        toks[:, t] = np.where(repeat[:, t], toks[:, t - 1], toks[:, t])
    batch = {
        "tokens": toks[:, :-1].astype(np.int32),
        "targets": toks[:, 1:].astype(np.int32),
        "mask": np.ones((B, St), np.float32),
    }
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def batch_iterator(cfg: ModelConfig, shape: ShapeConfig,
                   pc: Optional[PipelineConfig] = None,
                   start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    pc = pc or PipelineConfig()
    step = start_step
    while True:
        yield make_batch(cfg, shape, pc, step)
        step += 1
