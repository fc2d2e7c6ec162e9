"""The SSD scan: the CUDA kernel on the card, the plain version on the
CPU; and the decode step.

Counterpart of ``repro.kernels.ssd_scan.ops``.  :func:`ssd` takes the
reference's signature and chunk rule; a CUDA tensor goes to
``csrc/ssd_scan.cu`` (K8, the port of ``ssd_pallas``), a CPU tensor, or
``backend="torch"``, to :func:`ref.ssd_chunked`.  The reference pads S to
a multiple of the chunk with zero steps around the Pallas call; the CUDA
kernels mask the ragged last chunk themselves (the same zero steps: dt =
0, no input), so nothing is copied.  One call runs the chunked SSD
decomposition as four kernels on the caller's stream (C·Bᵀ once per
(batch, group, chunk); each chunk's cumulative sums and state
contribution; the state passed across the chunks; the outputs), with the
scratch that :func:`plan` sizes from the shapes.  :func:`ssd_step` is
plain PyTorch on every device, as it is plain jnp in the reference.

Training: on a CUDA tensor in grad mode, when an operand requires grad,
the call goes through :class:`SSDScanFn`.  Its forward is K8 and saves
only the inputs; its backward recomputes :func:`ref.ssd_chunked` from
them under autograd, the counterpart of the reference's gradient, which
is XLA's autodiff of the chunked ``_ssd_xla`` (the Pallas kernel is
forward only).  On the CPU, autograd differentiates
:func:`ref.ssd_chunked` itself.  Nothing falls back: a kernel that fails
to build or launch raises in training as in serving.

A fake tensor takes the kernel's route without a launch (y and the final
state of K8's shapes, :func:`cost` reported); ``DTensor`` operands run on
their local shards where batch (or heads) are sharded
(``common.local_operands``): with x sharded by heads, B and C (and A and
D) held whole are sliced to the groups (and heads) the rank's heads read.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (DTYPE_CODES, LaunchCounter,
                                        batch_only, cdiv, check_operands,
                                        dispatch, from_local, is_fake,
                                        local_operands, report_cost)
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

LAUNCHES = LaunchCounter()  # wrapper calls that launched the kernels

ALIGN = 8            # P and N: whole 16-byte rows in bf16 (the kernels' loads)
MAX_STATE = 128      # N: C·Bᵀ's tensor-core kernel holds 64 rows of N in shared memory
MAX_CHUNK = 256      # Q: the chunk's cumulative sums live in shared memory
_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


class Plan(NamedTuple):
    """The scratch one call of the CUDA scan needs, from the shapes alone:
    the chunks' cumulative sums (f64), C·Bᵀ once per (batch, group, chunk)
    and each chunk's state (f32)."""
    cs_shape: tuple      # (Bt, H, n_chunks, Q) f64
    cb_shape: tuple      # (Bt, G, n_chunks, Q, Q) f32, key-major
    states_shape: tuple  # (Bt, H, n_chunks, P, N) f32


def plan(Bt: int, S: int, H: int, P: int, G: int, N: int, chunk: int) -> Plan:
    """The scratch of one call of the CUDA scan over chunks of ``chunk``
    steps (the C launcher sizes its grids itself: :func:`grids`)."""
    nc = cdiv(S, chunk)
    return Plan(cs_shape=(Bt, H, nc, chunk), cb_shape=(Bt, G, nc, chunk, chunk),
                states_shape=(Bt, H, nc, P, N))


def grids(Bt: int, S: int, H: int, P: int, G: int, N: int,
          chunk: int) -> tuple:
    """The blocks that one call launches of each of its four kernels (C·Bᵀ,
    state, pass, outputs), as the C launcher sizes them; builds the
    library, so it runs where the kernels do."""
    out = (ctypes.c_int * 4)()
    fn = _build.function("ssd_scan", "ssd_scan_grids",
                         [ctypes.c_int] * 7 + [ctypes.c_void_p])
    _build.check("ssd_scan", fn(Bt, S, H, P, G, N, chunk, out))
    return tuple(out)


def ssd(x, dt, A, B, C, D_skip, *, chunk: int = 256, initial_state=None,
        backend: str | None = None):
    """Chunked SSD scan (see ref.ssd_ref for shapes).  Returns y (Bt, S, H,
    P) in x's dtype and the final state (Bt, H, P, N) in f32."""
    Bt, S, H, P = x.shape
    N = B.shape[3]
    chunk = min(chunk, max(16, 1 << (S - 1).bit_length()))   # don't over-chunk tiny S
    given = () if initial_state is None else (initial_state,)
    shards = local_operands("ssd_scan", (x, dt, A, B, C, D_skip) + given,
                            (0, 0, None, 0, 0, None, 0),
                            (2, 2, 0, 2, 2, 0, 1))
    if shards is not None:
        locs, mesh, pl = shards
        y, final = ssd(*locs[:6], chunk=chunk, backend=backend,
                       initial_state=locs[6] if given else None)
        # x's (Bt, S, H, P) shards as the state's (Bt, H, P, N)
        fpl = [type(p)({0: 0, 2: 1}[p.dim]) if hasattr(p, "dim") else p
               for p in pl]
        return (from_local(y, mesh, pl, x.shape),
                from_local(final, mesh, fpl, (Bt, H, P, N)))
    if initial_state is None:
        initial_state = torch.zeros((Bt, H, P, N), dtype=torch.float32,
                                    device=x.device)
    if dispatch(backend, x) == "torch":
        return ssd_chunked(x, dt, A, B, C, D_skip, initial_state, chunk)
    operands = (x, dt, A, B, C, D_skip, initial_state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return SSDScanFn.apply(*operands, chunk)
    return _ssd_cuda(*operands, chunk)


class SSDScanFn(torch.autograd.Function):
    """K8's forward, saving its inputs; the backward is autograd through
    :func:`ref.ssd_chunked` recomputed from them (B's and C's gradients
    summed over each group's heads by the recompute's own broadcast)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D_skip, initial_state, chunk):
        ctx.set_materialize_grads(False)
        y, final = _ssd_cuda(x, dt, A, B, C, D_skip, initial_state, chunk)
        ctx.save_for_backward(x, dt, A, B, C, D_skip, initial_state)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, grad_y, grad_final):
        saved = ctx.saved_tensors
        want = ctx.needs_input_grad[:len(saved)]
        leaves = [t.detach().requires_grad_(w) for t, w in zip(saved, want)]
        with torch.enable_grad():
            outs = ssd_chunked(*leaves, ctx.chunk)
        pairs = [(o, g) for o, g in zip(outs, (grad_y, grad_final))
                 if g is not None and o.requires_grad]
        if not pairs:
            return (None,) * (len(saved) + 1)
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], [t for t in leaves if t.requires_grad],
            [g for _, g in pairs], allow_unused=True))
        return tuple(next(got) if w else None for w in want) + (None,)


def flop_parts(Bt: int, S: int, H: int, P: int, G: int, N: int,
               Q: int) -> tuple:
    """The chunked SSD scan's products over the causal half (j <= i) of
    each chunk: C·Bᵀ once per (batch, group, chunk); (C·Bᵀ ⊙ L)·(dt·x),
    and the two state terms (C·stateᵀ and the state update), per (batch,
    head, chunk).  Returns (C·Bᵀ, intra-chunk, state) FLOPs."""
    nc = cdiv(S, Q)
    pairs = Q * (Q + 1) // 2
    return (Bt * G * nc * 2 * pairs * N, Bt * H * nc * 2 * pairs * P,
            Bt * H * nc * 4 * Q * N * P)


def cost(Bt: int, S: int, H: int, P: int, G: int, N: int, Q: int,
         itemsize: int) -> tuple:
    """(FLOPs, bytes) of one K8 call over chunks of Q: the products of
    :func:`flop_parts`; x, B and C (``itemsize``) and dt (f32) read, A, D
    and the initial state read, y and the f32 final state written."""
    state = 4 * Bt * H * P * N
    nbytes = (itemsize * (2 * Bt * S * H * P + 2 * Bt * S * G * N)
              + 4 * Bt * S * H + 8 * H + 2 * state)
    return sum(flop_parts(Bt, S, H, P, G, N, Q)), nbytes


def _ssd_cuda(x, dt, A, B, C, D_skip, initial_state, chunk: int):
    if x.ndim != 4 or B.ndim != 4 or B.shape != C.shape:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}")
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if B.shape[:2] != (Bt, S) or G <= 0 or H % G:
        raise ValueError(f"ssd_scan: B/C {tuple(B.shape)} do not fit x "
                         f"{tuple(x.shape)} (H % G must be 0)")
    if (tuple(dt.shape) != (Bt, S, H) or tuple(A.shape) != (H,)
            or tuple(D_skip.shape) != (H,)
            or tuple(initial_state.shape) != (Bt, H, P, N)):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"D {tuple(D_skip.shape)}, initial_state "
                         f"{tuple(initial_state.shape)} do not fit x "
                         f"{tuple(x.shape)} and B {tuple(B.shape)}")
    if P % ALIGN or N % ALIGN or N > MAX_STATE:
        raise ValueError(f"ssd_scan: P {P} and N {N} must be multiples of "
                         f"{ALIGN}, N at most {MAX_STATE}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan: dtypes {x.dtype}, {B.dtype}, {C.dtype}; "
                         f"x, B and C take one of {tuple(DTYPE_CODES)}")
    f32 = (dt, A, D_skip, initial_state)
    if any(t.dtype != torch.float32 for t in f32):
        raise ValueError(f"ssd_scan: dt, A, D and initial_state must be "
                         f"float32, got {[t.dtype for t in f32]}")
    y = torch.empty_like(x)
    final = torch.empty((Bt, H, P, N), dtype=torch.float32, device=x.device)
    if is_fake(x):
        report_cost("ssd_scan", *cost(Bt, S, H, P, G, N, chunk,
                                      x.element_size()))
        return y, final
    check_operands("ssd_scan", x, dt, A, B, C, D_skip, initial_state)
    if x.numel() == 0:
        final.copy_(initial_state)
        return y, final
    p = plan(Bt, S, H, P, G, N, chunk)
    cs = torch.empty(p.cs_shape, dtype=torch.float64, device=x.device)
    cbt = torch.empty(p.cb_shape, dtype=torch.float32, device=x.device)
    states = torch.empty(p.states_shape, dtype=torch.float32, device=x.device)
    fn = _build.function("ssd_scan", "ssd_scan_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D_skip.data_ptr(), initial_state.data_ptr(),
            y.data_ptr(), final.data_ptr(), cs.data_ptr(), cbt.data_ptr(),
            states.data_ptr(), Bt, S, H, P, G, N, chunk,
            DTYPE_CODES[x.dtype], stream)
    _build.check("ssd_scan", rc)
    LAUNCHES.add()
    return y, final


def ssd_step(state, x_t, dt_t, A, B_t, C_t, D_skip):
    """Single decode step of the SSD recurrence (plain PyTorch, O(H·P·N)).

    state: (Bt, H, P, N) f32; x_t: (Bt, H, P); dt_t: (Bt, H);
    B_t/C_t: (Bt, G, N).  Returns (y_t (Bt, H, P) in x_t's dtype,
    new_state).  ``DTensor`` operands run on their local rows, every shard
    but the batch's gathered first (a state sharded on N would make y a
    partial sum)."""
    ops = [batch_only(t, 0 if t.ndim > 1 else None) for t in
           (state, x_t, dt_t, A, B_t, C_t, D_skip)]
    shards = local_operands("ssd_step", ops, (0, 0, 0, None, 0, 0, None),
                            (None,) * 7)
    if shards is not None:
        (st, xl, dl, Al, Bl, Cl, Dl), mesh, pl = shards
        y, new = ssd_step(st, xl, dl, Al, Bl, Cl, Dl)
        return (from_local(y, mesh, pl, x_t.shape),
                from_local(new, mesh, pl, state.shape))
    H = state.shape[1]
    rep = H // B_t.shape[1]
    xf, dtf = x_t.float(), dt_t.float()
    Bh = B_t.float().repeat_interleave(rep, dim=1)              # (Bt,H,N)
    Ch = C_t.float().repeat_interleave(rep, dim=1)
    decay = torch.exp(dtf * A.float())[..., None, None]
    new_state = decay * state + (dtf[..., None] * xf)[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    y = y + D_skip.float()[None, :, None] * xf
    return y.to(x_t.dtype), new_state
