"""Optimizers: SGD (the paper's HOGWILD! training optimizer, §6.2) and
AdamW.

Counterpart of ``repro.optim.sgd``, with its names, defaults and math: the
update is taken in f32 and cast to each parameter's dtype (bf16 in the
served configs), AdamW's bias correction and decoupled weight decay as
there, and a callable ``lr`` (``warmup_cosine``) is read at the state's
step counter, a 0-d int32 tensor on the parameters' device, so that no
step waits on the host.  Where the reference returns new pytrees, these
update the parameters in place under ``torch.no_grad()`` (``_foreach``
ops over the leaves) and return them, a group of leaves at a time
(``GROUP_BYTES``), so that the f32 temporaries never copy the whole
model: the reference's jitted elementwise update never does.  The
per-parameter state (SGD's momentum, AdamW's moments) is a module of the
parameters' own class, one buffer per parameter under its name: the
counterpart of the reference's state pytree shaped like the params, and
what the checkpointer writes in that layout.  Gradients are a mapping from parameter names to tensors
(``accumulate_grads``).  ``torch.optim`` is not used: it would update
bf16 parameters in bf16 arithmetic where the reference works in f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, NamedTuple, Tuple

import torch
from torch import nn

from repro_torch.kernels.common import as_dtensor


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Any                      # a module like the params, or ()


def zeros_like_params(params: nn.Module, dtype=None) -> nn.Module:
    """A module of ``params``'s class on its device, every parameter zero
    (in ``dtype`` when given, else in its own)."""
    device = next(params.parameters()).device
    if as_dtensor(next(params.parameters())) is not None:
        # DTensor parameters: each state leaf placed as its parameter
        out = type(params)(params.cfg, device="meta")
        for name, p in params.named_parameters():
            mod, _, leaf = name.rpartition(".")
            owner = out.get_submodule(mod) if mod else out
            owner._parameters[leaf] = nn.Parameter(
                torch.zeros_like(p, dtype=dtype or p.dtype),
                requires_grad=False)
        return out
    out = type(params)(params.cfg, device="meta").to_empty(device=device)
    if dtype is not None:
        out = out.to(dtype)
    with torch.no_grad():
        for p in out.parameters():
            p.zero_()
    return out


def _step0(params: nn.Module) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=next(params.parameters()).device)


# The f32 working set one group of the update may hold.  Every element's
# arithmetic is the same whatever the grouping; a group holds at most
# ``_F32_COPIES`` f32 copies of its elements (the parameters, the update,
# the update plus weight decay), and a leaf larger than a group is taken
# in slices of its flat view.
GROUP_BYTES = 512 << 20
_F32_COPIES = 3


def _groups(ps) -> list:
    """The update's groups over the leaves ``ps``, in order: lists of
    (leaf index, start, stop) ranges of each leaf's flat view, whole
    leaves where they fit in a group.  ``DTensor`` parameters make one
    group of whole leaves (``_apply`` takes them one at a time)."""
    if as_dtensor(ps[0]) is not None:
        return [[(i, 0, p.numel()) for i, p in enumerate(ps)]]
    cap = max(1, GROUP_BYTES // (4 * _F32_COPIES))      # elements a group
    groups, cur, room = [], [], cap
    for i, p in enumerate(ps):
        n, lo = p.numel(), 0
        if room < n <= cap:                 # whole, in a group of its own
            groups.append(cur)
            cur, room = [], cap
        while lo < n:
            hi = lo + min(n - lo, room)
            cur.append((i, lo, hi))
            room -= hi - lo
            lo = hi
            if not room:
                groups.append(cur)
                cur, room = [], cap
    groups.append(cur)
    return [g for g in groups if g]


def _take(ts, group, write: bool = True) -> list:
    """The tensors of ``ts`` in ``group``: whole leaves as they are, slices
    as views of the flat leaf, written through in place (``write``; a
    gradient, only read, may be a strided view, and is reshaped)."""
    flat = (lambda t: t.view(-1)) if write else (lambda t: t.reshape(-1))
    return [ts[i] if lo == 0 and hi == ts[i].numel()
            else flat(ts[i])[lo:hi] for i, lo, hi in group]


def _apply(ps, upd, lr, weight_decay: float, owned: bool) -> None:
    """p <- cast(p32 - lr * (upd + weight_decay * p32)), in place, over one
    group; ``upd`` f32 tensors in the order of ``ps``, written to only when
    ``owned`` (no tensor of it is one the caller holds, as the gradient
    an f32 cast returns as it is).  ``DTensor`` parameters take the same
    arithmetic one leaf at a time: ``DTensor`` resolves a sharding
    strategy for each list a foreach op takes, which costs more than the
    ops, and has no foreach copy."""
    if as_dtensor(ps[0]) is not None:
        for p, u in zip(ps, upd):
            p32 = p.float()
            if weight_decay:
                u = torch.add(u, p32, alpha=weight_decay)
            p.copy_(p32 - u * lr)
        return
    p32 = [p.float() for p in ps]
    if weight_decay:
        upd, owned = torch._foreach_add(upd, p32, alpha=weight_decay), True
    if owned:
        torch._foreach_mul_(upd, lr)
    else:
        upd = torch._foreach_mul(upd, lr)
    torch._foreach_sub_(p32, upd)
    torch._foreach_copy_(ps, p32)


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-2
    momentum: float = 0.0
    weight_decay: float = 0.0

    def init(self, params: nn.Module) -> SGDState:
        mom = zeros_like_params(params) if self.momentum else ()
        return SGDState(step=_step0(params), momentum=mom)

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: SGDState,
               params: nn.Module) -> Tuple[nn.Module, SGDState]:
        lr = self._lr(state.step)
        ps = list(params.parameters())
        gs = [grads[n] for n, _ in params.named_parameters()]
        ms = list(state.momentum.parameters()) if self.momentum else []
        for group in _groups(ps):
            g = _take(gs, group, write=False)
            if self.momentum:
                m = _take(ms, group)
                torch._foreach_mul_(m, self.momentum)
                torch._foreach_add_(m, [x.to(y.dtype) for x, y in zip(g, m)])
                g = m
            g32 = [x.float() for x in g]
            _apply(_take(ps, group), g32, lr, self.weight_decay,
                   owned=not any(a is b for a, b in zip(g32, g)))
        return params, SGDState(step=state.step + 1, momentum=state.momentum)


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params: nn.Module) -> AdamWState:
        return AdamWState(step=_step0(params),
                          mu=zeros_like_params(params, torch.float32),
                          nu=zeros_like_params(params, torch.float32))

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params: nn.Module) -> Tuple[nn.Module, AdamWState]:
        step = state.step + 1
        lr = self._lr(state.step)
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()
        ps = list(params.parameters())
        gs = [grads[n] for n, _ in params.named_parameters()]
        mus, nus = list(state.mu.parameters()), list(state.nu.parameters())
        for group in _groups(ps):
            g32 = [x.float() for x in _take(gs, group, write=False)]
            mu, nu = _take(mus, group), _take(nus, group)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g32, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g32, g32, value=1 - b2)
            del g32
            upd = torch._foreach_div(mu, bc1)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            torch._foreach_div_(upd, den)
            del den
            _apply(_take(ps, group), upd, lr, self.weight_decay, owned=True)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    """LR schedule usable as the ``lr`` field of either optimizer: a
    function of the step counter (a tensor), computed in f32 on its
    device."""

    def sched(step):
        step = step.float()
        warm = peak_lr * (step + 1) / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)

    return sched
