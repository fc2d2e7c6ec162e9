"""Unified model facade: ``build_model(cfg, ec)`` and :class:`Model`.

Counterpart of ``repro.models.model`` for every family of the registry:
the dense, MoE and VLM decoders, the Mamba2 stack, the Zamba2 hybrid and
the Whisper-style encoder/decoder.  Methods take the parameters (the
``Params`` module of the family's module: a
:class:`~repro_torch.models.transformer.Transformer`,
:class:`~repro_torch.models.ssm_stack.SSMStack` or
:class:`~repro_torch.models.encdec.EncDec`) and inputs, as the JAX methods
take a parameter tree.  The VLM's patch embeddings and the encoder's
frames come in as ``extra`` (``logits``, ``prefill``) or in the batch
(``loss``: ``image_embeds``, ``frames``), as there.  Parameters and
caches are built on the card unless the caller names the CPU: a missing
card raises rather than handing back CPU tensors that would run the
plain versions.  The dry-run's stand-ins (``init_shapes``,
``cache_specs``, ``input_specs``) are tensors on the meta device: the
reference's shapes and dtypes, no storage.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import encdec, ssm_stack, transformer
from repro_torch.models.execution import DEFAULT_EXEC, ExecConfig

_FAMILY_MODULES = {"dense": transformer, "moe": transformer,
                   "vlm": transformer, "ssm": ssm_stack, "hybrid": ssm_stack,
                   "encdec": encdec}
# the extra input: its argument name and the config field of its length
_EXTRA = {"vlm": ("image_embeds", "n_image_tokens"),
          "encdec": ("frames", "n_frames")}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    ec: ExecConfig

    @property
    def _mod(self):
        return _FAMILY_MODULES[self.cfg.family]

    # -- construction ----------------------------------------------------------
    def init(self, rng: torch.Generator, device="cuda"):
        """Random parameters from ``rng``, a generator on ``device`` (the
        card unless ``"cpu"`` is named; raises without a card)."""
        return self._mod.init_params(rng, self.cfg, resolve_device(device))

    def init_shapes(self):
        """The family's parameter module on the meta device: every leaf's
        shape and dtype, no storage (for the dry-run)."""
        return self._mod.Params(self.cfg, device="meta")

    # -- training ----------------------------------------------------------------
    def loss(self, params, batch):
        """(loss, metrics) for a train batch (tensors tokens/targets/mask,
        and the family's extra input: image_embeds or frames)."""
        return self._mod.forward_train(params, self.cfg, self.ec, batch)

    def extra_shape(self, batch: int) -> Optional[tuple]:
        """Shape of the family's extra input for ``batch`` rows: the VLM's
        patch embeddings (B, n_image_tokens, d_model), the encoder's frames
        (B, n_frames, d_model); None for a family without one."""
        if self.cfg.family not in _EXTRA:
            return None
        return (batch, getattr(self.cfg, _EXTRA[self.cfg.family][1]),
                self.cfg.d_model)

    @property
    def prefix_len(self) -> int:
        """Positions a prefill takes ahead of the prompt's tokens: the VLM's
        patch embeddings, else none."""
        return self.cfg.n_image_tokens if self.cfg.family == "vlm" else 0

    def _extra(self, extra) -> dict:
        if self.cfg.family not in _EXTRA:
            if extra is not None:
                raise ValueError(f"{self.cfg.name}: family "
                                 f"{self.cfg.family!r} takes no extra input")
            return {}
        return {_EXTRA[self.cfg.family][0]: extra}

    def logits(self, params, tokens, extra=None):
        """Logits of every position; ``extra`` is the VLM's patch
        embeddings or the encoder's frames."""
        return self._mod.forward_logits(params, self.cfg, self.ec, tokens,
                                        **self._extra(extra))

    # -- serving -----------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda"):
        """An empty serving cache on ``device`` (as for :meth:`init`)."""
        return self._mod.init_cache(self.cfg, batch, max_len,
                                    resolve_device(device))

    def prefill(self, params, tokens, cache, extra=None):
        """Returns (last-token logits, cache, prefix_len); ``extra`` as for
        :meth:`logits`."""
        return self._mod.prefill(params, self.cfg, self.ec, tokens, cache,
                                 **self._extra(extra))

    def decode_step(self, params, token, cache, index):
        """One serve step: (logits (B,V), cache)."""
        return self._mod.decode_step(params, self.cfg, self.ec, token, cache,
                                     index)

    # -- dry-run input specs --------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int) -> dict:
        """The serving cache of :meth:`init_cache` on the meta device."""
        return self._mod.init_cache(self.cfg, batch, max_len,
                                    torch.device("meta"))

    def input_specs(self, shape: ShapeConfig) -> dict:
        """Meta-device stand-ins for every input of the step this shape
        runs (the train step for "train", prefill or one decode step for
        the others), with the reference's shapes and dtypes."""
        cfg = self.cfg
        GB, S = shape.global_batch, shape.seq_len
        meta = lambda s, d: torch.empty(s, dtype=d, device="meta")
        i32, f = torch.int32, getattr(torch, cfg.dtype)
        St = S - cfg.n_image_tokens if cfg.family == "vlm" else S
        extra = {}
        if cfg.family in _EXTRA:
            extra[_EXTRA[cfg.family][0]] = meta(self.extra_shape(GB), f)
        if shape.kind == "train":
            return {"tokens": meta((GB, St), i32),
                    "targets": meta((GB, St), i32),
                    "mask": meta((GB, St), torch.float32), **extra}
        if shape.kind == "prefill":
            return {"tokens": meta((GB, St), i32), **extra,
                    "cache": self.cache_specs(GB, S)}
        # decode: one new token against a cache of seq_len
        return {"token": meta((GB,), i32), "index": meta((GB,), i32),
                "cache": self.cache_specs(GB, S)}


def build_model(cfg: ModelConfig, ec: Optional[ExecConfig] = None) -> Model:
    return Model(cfg=cfg, ec=ec or DEFAULT_EXEC)
