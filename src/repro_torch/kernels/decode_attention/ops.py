"""Decode attention: the CUDA kernel on the card, the plain version on
the CPU.

Counterpart of ``repro.kernels.decode_attention.ops.decode_attention``.  A
CUDA tensor goes to ``csrc/decode_attention.cu`` (the port of the Pallas
kernel, as split-KV flash-decoding in one launch: the last block of each
(batch, KV head) to finish reduces the splits); a CPU tensor, or
``backend="torch"``,
to :func:`ref.decode_attention_ref`.  The lengths stay on the device: the
wrapper never reads them, so a decode step has no host sync, and the
launch is the same at every step (graph-safe: the kernel leaves its
counters at 0).

A fake tensor takes the kernel's route without a launch (the output's
shape, :func:`cost` reported for the cache's full length, the lengths
having no data), and ``DTensor`` operands run on their local shards
(``common.local_operands``; a cache sharded along its sequence is
gathered first).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (DTYPE_CODES, HEAD_DIMS,
                                        LaunchCounter, check_operands, cdiv,
                                        dispatch, from_local, is_fake,
                                        local_operands, report_cost,
                                        round_up)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

LAUNCHES = LaunchCounter()  # launches, by the cache's (S, H, K, D)

WARPS = 4           # warps of a block in the kernel; each streams its own tiles
TILE_BYTES = 2048   # K rows of one warp's tile (and as many of V)
MAX_HEADS = 8       # query heads one block scores (1, 2, 4 or 8)
SPLIT_TILES = 8     # a split: at most 2 tiles a warp (16 KB of K at D 64)
MAX_SPLITS = 128    # the last block of a pair reduces at most this many
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])


def decode_attention(q, k, v, lengths, *, scale: float | None = None,
                     backend: str | None = None):
    """q: (B, H, D); k/v: (B, S, K, D); lengths: (B,) int32 -> (B, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    shards = local_operands("decode_attention", (q, k, v, lengths),
                            (0, 0, 0, 0), (1, 2, 2, None), (None, 1, 1, None))
    if shards is not None:
        (ql, kl, vl, nl), mesh, pl = shards
        out = decode_attention(ql, kl, vl, nl, scale=scale, backend=backend)
        return from_local(out, mesh, pl, q.shape)
    if dispatch(backend, q) == "torch":
        return decode_attention_ref(q, k, v, lengths, scale=scale)
    return _decode_cuda(q, k, v, lengths, float(scale))


def cost(B: int, S: int, H: int, K: int, D: int, itemsize: int,
         n: int | None = None) -> tuple:
    """(FLOPs, bytes) of one K6 call over ``n`` valid positions of each
    row's cache (all S unless given): q K^T and P V (4 D per position and
    head), q read, n positions of K and V read, the output written."""
    n = S if n is None else n
    return (4 * D * B * H * n,
            itemsize * (2 * B * H * D + 2 * B * n * K * D))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def heads_per_block(G: int) -> int:
    """Query heads one block scores: the least of 1, 2, 4, 8 that holds
    the G heads of a KV head, else 8 (then ceil(G/8) blocks share it)."""
    return next((gt for gt in (1, 2, 4) if G <= gt), MAX_HEADS)


def tile_keys(D: int, itemsize: int) -> int:
    """Keys in one warp's tile: 2 KB of K rows."""
    return TILE_BYTES // (D * itemsize)


def split_plan(B: int, rows: int, S: int, n_sm: int, tile: int) -> tuple:
    """(split_len, n_splits) for a cache of S positions, ``rows`` blocks
    per sequence (KV heads times head groups) and tiles of ``tile`` keys:
    splits of ``SPLIT_TILES`` tiles, or fewer (a whole number per warp)
    where the grid would not give every SM a block, and at most
    ``MAX_SPLITS`` of them.  Depends on the cache capacity and the SM count
    only, never on the lengths, which stay on the card."""
    n_tiles = cdiv(S, tile)
    want = max(cdiv(n_sm, B * rows), 1)          # splits for a block per SM
    tiles = min(SPLIT_TILES, round_up(cdiv(n_tiles, want), WARPS))
    tiles = min(max(tiles, cdiv(n_tiles, MAX_SPLITS)), n_tiles)
    return tiles * tile, cdiv(n_tiles, tiles)


_COUNTERS: dict = {}    # (device index, stream) -> its counters
_OUTGROWN: list = []    # sets replaced by larger ones, never freed
_COUNTERS_LOCK = threading.Lock()


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The last-block counters of (``device``, ``stream``): zeroed once
    when made, and left at 0 by every call, so no call zeroes them (that
    would be a launch).  Two calls that run at once on two streams never
    share a set.  A set that a call outgrows is kept in ``_OUTGROWN``, not
    freed, since a CUDA graph captured earlier may still count on it.  A
    captured call uses its capture stream's set: replay the graph on that
    stream, or at least never at once with another call that uses the
    same set (two graphs captured on one stream share it)."""
    key = (device.index, stream)
    with _COUNTERS_LOCK:
        c = _COUNTERS.get(key)
        if c is None or c.numel() < n:
            if torch.cuda.is_current_stream_capturing():   # its zeros would
                raise RuntimeError(                        # wait for replay
                    "decode_attention: no counters for this shape on the "
                    "capture stream; call it there once before capturing")
            if c is not None:
                _OUTGROWN.append(c)
            c = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                             device=device)
        return c


def _decode_cuda(q, k, v, lengths, scale):
    B, H, D = q.shape
    if k.ndim != 4 or v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    S, K = k.shape[1], k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"decode_attention: {H} query heads over {K} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes one of "
                         f"{tuple(DTYPE_CODES)}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"decode_attention: lengths must be ({B},) int32, "
                         f"got {tuple(lengths.shape)} {lengths.dtype}")
    out = torch.empty_like(q)
    if is_fake(q):
        report_cost("decode_attention", *cost(B, S, H, K, D,
                                              q.element_size()))
        return out
    check_operands("decode_attention", q, k, v, lengths)
    if out.numel() == 0 or S == 0:
        return out.zero_()
    gt = heads_per_block(H // K)
    rows = K * cdiv(H // K, gt)
    split_len, n_splits = split_plan(B, rows, S, _sm_count(q.device.index),
                                     tile_keys(D, q.element_size()))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    pa = pm = cnt = 0
    if n_splits > 1:
        part_acc = torch.empty((B, rows, n_splits, gt, D), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, rows, n_splits, gt, 2), dtype=torch.float32,
                              device=q.device)
        pa, pm = part_acc.data_ptr(), part_ml.data_ptr()
        cnt = _counters(q.device, stream, B * rows).data_ptr()
    fn = _build.function("decode_attention", "decode_attention_fwd", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), pa, pm, cnt, B, S, H, K, D, DTYPE_CODES[q.dtype],
            gt, split_len, n_splits, scale, stream)
    _build.check("decode_attention", rc)
    LAUNCHES.add((S, H, K, D))
    return out
