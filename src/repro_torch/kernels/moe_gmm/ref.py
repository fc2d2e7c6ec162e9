"""Plain PyTorch version of the grouped (per-expert) matmul.

Same contract as ``repro.kernels.moe_gmm.ref.gmm_ref``: rows of group ``e``
are multiplied by ``w[e]``, accumulation is f32 and the output is cast to
``x.dtype``; rows past ``sum(group_sizes)`` come out zero and an empty
group contributes nothing.  The reference multiplies every row by every
expert and selects; this version slices each group by its offsets, which
is the same function at a 1/E share of the work (it reads the group sizes
on the host, so it syncs: it is the CPU path and the card's yardstick,
never the card's decode path).
"""
from __future__ import annotations

import torch


def gmm_ref(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (T, d) rows sorted by expert; w: (E, d, f); group_sizes: (E,)
    int32 with sum <= T.  Returns (T, f) in x.dtype."""
    T, _ = x.shape
    E, _, f = w.shape
    y = torch.zeros((T, f), dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        end = min(start + max(n, 0), T)
        if end > start:
            y[start:end] = x[start:end].float() @ w[e].float()
        start = end
    return y.to(x.dtype)
