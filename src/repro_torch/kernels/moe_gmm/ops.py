"""Grouped matmul: the CUDA kernel on the card, the plain version on the
CPU.

Counterpart of ``repro.kernels.moe_gmm.ops.gmm``.  A CUDA tensor goes to
``csrc/moe_gmm.cu`` (K7, the port of ``gmm_pallas``); a CPU tensor, or
``backend="torch"``, to :func:`ref.gmm_ref`.  The group sizes stay on the
device: the kernel reads them itself, so a decode step has no host sync.
The reference's ragged pad and scatter (every group padded to ``block_m``
rows around the Pallas call) are not ported, and neither are its TPU tile
knobs ``block_m``/``block_n``: the CUDA kernel masks ragged groups itself
and picks its own tiles.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (DTYPE_CODES, LaunchCounter,
                                        check_operands, dispatch)
from repro_torch.kernels.moe_gmm.ref import gmm_ref

LAUNCHES = LaunchCounter()  # wrapper calls that launched the kernel

ALIGN = 8          # d and f: whole 16-byte bf16 chunks (the kernel's loads)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def gmm(x, w, group_sizes, *, backend: str | None = None):
    """Grouped matmul (see ref.gmm_ref).  x rows must be sorted by expert;
    group_sizes is (E,) int32 on x's device."""
    if dispatch(backend, x) == "torch":
        return gmm_ref(x, w, group_sizes)
    return _gmm_cuda(x, w, group_sizes)


def _gmm_cuda(x, w, group_sizes):
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
    check_operands("moe_gmm", x, w, group_sizes)
    y = torch.empty((T, f), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    fn = _build.function("moe_gmm", "moe_gmm_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), y.data_ptr(),
            T, d, f, E, DTYPE_CODES[x.dtype], stream)
    _build.check("moe_gmm", rc)
    LAUNCHES.add()
    return y
