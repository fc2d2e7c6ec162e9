"""Unified model facade: ``build_model(cfg, ec)`` and :class:`Model`.

Counterpart of ``repro.models.model`` for the families the port runs (the
dense and MoE decoders).  Methods take the parameters (a
:class:`~repro_torch.models.transformer.Transformer`) and inputs, as the
JAX methods take a parameter tree.  The ``extra`` inputs of the VLM and
enc-dec families come with their slices, the dry-run input specs with
ROADMAP "Multi-device and dry-run".  Parameters and caches are built on
the card unless the caller names the CPU: a missing card raises rather
than handing back CPU tensors that would run the plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import transformer
from repro_torch.models.execution import DEFAULT_EXEC, ExecConfig

_FAMILY_MODULES = {"dense": transformer, "moe": transformer}


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

    def logits(self, params, tokens):
        return self._mod.forward_logits(params, self.cfg, self.ec, tokens)

    # -- serving -----------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda"):
        """An empty KV cache on ``device`` (as for :meth:`init`)."""
        return self._mod.init_cache(self.cfg, batch, max_len,
                                    resolve_device(device))

    def prefill(self, params, tokens, cache):
        """Returns (last-token logits, cache, prefix_len)."""
        return self._mod.prefill(params, self.cfg, self.ec, tokens, cache)

    def decode_step(self, params, token, cache, index):
        """One serve step: (logits (B,V), cache)."""
        return self._mod.decode_step(params, self.cfg, self.ec, token, cache,
                                     index)


def build_model(cfg: ModelConfig, ec: Optional[ExecConfig] = None) -> Model:
    if cfg.family not in _FAMILY_MODULES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"'Modules to port': SSM, enc-dec and VLM come in later slices)")
    return Model(cfg=cfg, ec=ec or DEFAULT_EXEC)
