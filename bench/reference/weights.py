"""Weights of a benchmark configuration, drawn from the run's seed.

The benchmark makes the weights itself and hands the same tensors to the
program and to the plain reference.  Every random leaf takes its values
from one stream of standard normals, made on the device in a few large
calls of ``CHUNK`` draws, each from a generator seeded by (seed, chunk
index): the same seed gives the same weights on a device, and
:func:`iter_weights` draws them again leaf by leaf without holding the
whole model twice.

Distributions (those of the port's own initialiser, drawn here
independently): matrices a normal clipped to two standard deviations,
std 0.02 for the embedding and fan-in^-1/2 (the matrix's input axis) for
the rest; the Mamba2 conv taps std 0.1; ``A_log`` = log(1 + 15 u), u
uniform; norm scales and ``D`` one; biases, ``dt_bias`` and ``conv_b``
zero.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, NamedTuple, Tuple

import torch

CHUNK = 1 << 26                      # draws per generator call (256 MB f32)
_MIX = 0x9E3779B97F4A7C15


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str                        # normal | conv | a_log | ones | zeros
    std: float = 0.0

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def random(self) -> bool:
        return self.init in ("normal", "conv", "a_log")


def chunk_size(specs: List[Leaf]) -> int:
    """Draws per chunk: ``CHUNK``, or fewer for a model that needs fewer."""
    total = sum(s.numel for s in specs if s.random)
    return min(CHUNK, 1 << max(total - 1, 1).bit_length())


def _chunk(seed: int, k: int, n: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed((seed * _MIX + k) % (1 << 63))
    return torch.randn(n, generator=g, device=device, dtype=torch.float32)


def _shape(spec: Leaf, z: torch.Tensor) -> torch.Tensor:
    if spec.init == "a_log":
        u = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
        x = torch.log(1.0 + 15.0 * u)
    else:
        x = z.clamp_(-2.0, 2.0).mul_(spec.std)
    return x.reshape(spec.shape).to(spec.dtype)


def _constant(spec: Leaf, device) -> torch.Tensor:
    fill = 1.0 if spec.init == "ones" else 0.0
    return torch.full(spec.shape, fill, dtype=spec.dtype, device=device)


def iter_weights(specs: List[Leaf], seed: int, device
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) for every leaf, the stream made once, in order."""
    k, cur = -1, None
    at, chunk = 0, chunk_size(specs)
    for spec in specs:
        if not spec.random:
            yield spec.name, _constant(spec, device)
            continue
        z = torch.empty(spec.numel, dtype=torch.float32, device=device)
        done = 0
        while done < spec.numel:
            want = (at + done) // chunk
            if want != k:
                k, cur = want, _chunk(seed, want, chunk, device)
            lo = at + done - k * chunk
            take = min(chunk - lo, spec.numel - done)
            z[done:done + take] = cur[lo:lo + take]
            done += take
        at += spec.numel
        yield spec.name, _shape(spec, z)
        del z


def make_weights(specs: List[Leaf], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    return dict(iter_weights(specs, seed, device))
