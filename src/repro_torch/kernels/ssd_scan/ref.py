"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan.

* :func:`ssd_ref` mirrors ``repro.kernels.ssd_scan.ref.ssd_ref``: the
  sequential per-step recurrence, O(S) steps, the oracle of the tests.
* :func:`ssd_chunked` is the chunked algorithm of the reference's XLA path
  (``repro.kernels.ssd_scan.ops._ssd_xla``), a Python loop over chunks
  with the intra-chunk products in f32.  It is the CPU path of
  :func:`~repro_torch.kernels.ssd_scan.ssd`, ``backend="torch"`` and the
  version the CUDA kernel is held against on the card.

Shapes: x (Bt, S, H, P); dt (Bt, S, H) positive step sizes (softplus
applied); A (H,) negative decay rates; B, C (Bt, S, G, N) with H % G == 0
(head h reads group h // (H // G)); D_skip (H,); initial_state
(Bt, H, P, N) or None.  Both return y (Bt, S, H, P) in x's dtype and the
final state (Bt, H, P, N) in f32.
"""
from __future__ import annotations

import torch


def _f32_heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    """(Bt, S, G, N) -> (Bt, S, H, N) in f32: each group repeated for its
    ``rep`` heads."""
    return t.float().repeat_interleave(rep, dim=2)


def ssd_ref(x, dt, A, B, C, D_skip, *, initial_state=None):
    """Selective-state-space recurrence, one step at a time.

    state_s = exp(dt_s * A) * state_{s-1} + dt_s * (x_s ⊗ B_s)
    y_s     = C_s · state_s + D * x_s
    """
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = _f32_heads(B, rep), _f32_heads(C, rep)
    state = (torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float().clone())
    ys = []
    for s in range(S):
        decay = torch.exp(dtf[:, s] * Af)[..., None, None]          # (Bt,H,1,1)
        state = decay * state + (dtf[:, s, :, None] * xf[:, s])[..., None] \
            * Bf[:, s, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Cf[:, s]))
    y = torch.stack(ys, dim=1) + D_skip.float()[None, None, :, None] * xf
    return y.to(x.dtype), state


def ssd_chunked(x, dt, A, B, C, D_skip, initial_state, chunk: int):
    """The chunked scan, chunk by chunk.  S is padded to a multiple of
    ``chunk`` with zero steps (dt = 0: decay 1, no input, so the state
    passes through them unchanged) and the padded outputs are dropped."""
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Q = chunk
    pad = -S % Q
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    Bf = torch.nn.functional.pad(B.float(), (0, 0, 0, 0, 0, pad))
    Cf = torch.nn.functional.pad(C.float(), (0, 0, 0, 0, 0, pad))
    Af = A.float()
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    state = initial_state.float()
    ys = []
    for c0 in range(0, S + pad, Q):
        xc, dtc = xf[:, c0:c0 + Q], dtf[:, c0:c0 + Q]          # (Bt,Q,H,P) (Bt,Q,H)
        Bg, Cg = Bf[:, c0:c0 + Q], Cf[:, c0:c0 + Q]            # (Bt,Q,G,N)
        Bc = Bg.repeat_interleave(rep, dim=2)                  # (Bt,Q,H,N)
        Cc = Cg.repeat_interleave(rep, dim=2)
        cs = torch.cumsum(dtc * Af, dim=1)                     # inclusive
        seg = cs[:, :, None, :] - cs[:, None, :, :]            # (Bt,Q,Q,H)
        # mask BEFORE exp: upper-triangular seg is positive and would overflow
        L = torch.exp(torch.where(tri[None, :, :, None], seg,
                                  torch.full_like(seg, float("-inf"))))
        # C·Bᵀ once per group, as the reference's path and the kernel take it
        CB = torch.einsum("bign,bjgn->bijg", Cg, Bg)          # (Bt,Q,Q,G)
        scores = CB.repeat_interleave(rep, dim=3) * L
        dtx = xc * dtc[..., None]                              # (Bt,Q,H,P)
        y = torch.einsum("bijh,bjhp->bihp", scores, dtx)
        y = y + torch.exp(cs)[..., None] * torch.einsum("bihn,bhpn->bihp",
                                                        Cc, state)
        decay_out = torch.exp(cs[:, -1:, :] - cs)              # (Bt,Q,H)
        state = torch.exp(cs[:, -1, :])[..., None, None] * state + \
            torch.einsum("bjhp,bjhn->bhpn", dtx * decay_out[..., None], Bc)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + D_skip.float()[None, None, :, None] * xf[:, :S]
    return y.to(x.dtype), state
