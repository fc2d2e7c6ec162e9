"""Grouped matmul: the CUDA kernels on the card, the plain version on the
CPU.

Counterpart of ``repro.kernels.moe_gmm.ops.gmm``.  A CUDA tensor goes to
``csrc/moe_gmm.cu`` (K7, the port of ``gmm_pallas``); a CPU tensor, or
``backend="torch"``, to :func:`ref.gmm_ref`.  The group sizes stay on the
device: the kernels read them themselves, so a call has no host sync and
a decode step can be captured as a CUDA graph.  In bf16, :func:`plan`
picks one of two kernels from the shapes alone: weight streaming for few
rows per expert (decode), tensor cores for many (sorted prefill); f32
runs on the CUDA cores.  The reference's ragged pad and scatter (every
group padded to ``block_m`` rows around the Pallas call) are not ported,
and neither are its TPU tile knobs ``block_m``/``block_n``: the kernels
mask ragged groups themselves and pick their own tiles.  A fake tensor
takes the kernel's route without a launch (:func:`cost` reported for
every expert active, the group sizes having no data); ``DTensor``
operands run on their local values only when replicated on every mesh
dim (experts sharded across ranks would need an all-to-all first).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (DTYPE_CODES, LaunchCounter,
                                        check_operands, dispatch, from_local,
                                        is_fake, local_operands, refuse_grad,
                                        report_cost)
from repro_torch.kernels.moe_gmm.ref import gmm_ref

# wrapper calls that launched a kernel, also by the (d, f) of the call
LAUNCHES = LaunchCounter()

ALIGN = 8          # d and f: whole 16-byte bf16 chunks (the kernels' loads)
REGIMES = {"stream": 0, "tc": 1}   # the C entry's codes of the bf16 kernels
# tc_kernel's smallest T, d and f (its TMA boxes are 64 x 64) and its most
# experts; from T = 64 on it is also the faster kernel (PERF.md)
TC_BOX, TC_MAX_E = 64, 256
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def plan(T: int, d: int, f: int, E: int) -> str:
    """The bf16 kernel for x (T, d) and w (E, d, f), a function of the
    shapes only, never of the group sizes, which stay on the card: T below
    64 (a decode step) streams the weights (``"stream"``), from 64 rows on
    the tensor cores run (``"tc"``).  Shapes the tensor-core kernel does
    not take (d or f below 64, no expert or more than 256) stream at any
    T.  Each kernel sizes its own grid."""
    if min(T, d, f) < TC_BOX or not 0 < E <= TC_MAX_E:
        return "stream"
    return "tc"


def gmm(x, w, group_sizes, *, backend: str | None = None):
    """Grouped matmul (see ref.gmm_ref).  x rows must be sorted by expert;
    group_sizes is (E,) int32 on x's device."""
    shards = local_operands("moe_gmm", (x, w, group_sizes), (None,) * 3,
                            (None,) * 3)
    if shards is not None:
        (xl, wl, gl), mesh, pl = shards
        y = gmm(xl, wl, gl, backend=backend)
        return from_local(y, mesh, pl, (x.shape[0], w.shape[2]))
    if dispatch(backend, x) == "torch":
        return gmm_ref(x, w, group_sizes)
    refuse_grad("moe_gmm", "Sorted MoE dispatch in training", x, w)
    return _gmm_cuda(x, w, group_sizes)


def cost(T: int, d: int, f: int, E: int, itemsize: int,
         active: int | None = None) -> tuple:
    """(FLOPs, bytes) of one K7 call: 2 T d f, the ``active`` experts'
    weights (all E unless given) and the rows read, the output written."""
    active = E if active is None else active
    return 2 * T * d * f, itemsize * (active * d * f + T * d + T * f)


def _gmm_cuda(x, w, group_sizes, regime: str | None = None):
    """The kernel call; ``regime`` overrides :func:`plan` for the A/B
    timing of the kernels against each other (``chip_smoke.py gmm``)."""
    if x.ndim != 2 or w.ndim != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"moe_gmm: x {tuple(x.shape)}, w {tuple(w.shape)}")
    T, d = x.shape
    E, _, f = w.shape
    if d % ALIGN or f % ALIGN:
        raise ValueError(f"moe_gmm: d {d} and f {f} must be multiples of "
                         f"{ALIGN}")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"moe_gmm: dtypes {x.dtype}, {w.dtype}; the kernel "
                         f"takes one of {tuple(DTYPE_CODES)}")
    if group_sizes.shape != (E,) or group_sizes.dtype != torch.int32:
        raise ValueError(f"moe_gmm: group_sizes must be ({E},) int32, got "
                         f"{tuple(group_sizes.shape)} {group_sizes.dtype}")
    y = torch.empty((T, f), dtype=x.dtype, device=x.device)
    if is_fake(x):
        report_cost("moe_gmm", *cost(T, d, f, E, x.element_size()))
        return y
    check_operands("moe_gmm", x, w, group_sizes)   # TMA: 16-byte aligned
    if y.numel() == 0:
        return y
    regime = plan(T, d, f, E) if regime is None else regime
    fn = _build.function("moe_gmm", "moe_gmm_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), y.data_ptr(),
            T, d, f, E, DTYPE_CODES[x.dtype], REGIMES[regime], stream)
    _build.check("moe_gmm", rc)
    LAUNCHES.add((d, f))
    return y
