"""Frozen operation and byte counts of the port's kernels, and the H100's
data-sheet peaks they are held against.

Copies of ``kernels/{flash_attention,decode_attention,ssd_scan}/ops.py``'s
``cost`` functions as they stood when the benchmark was defined: a
roofline share reads the same work whatever implements the kernel, and a
later change to the program cannot move the yardstick.  Every product is
held against the bf16 tensor-core peak (K8's f32 products too, which run
slower there), so a share is a lower bound and never passes 100% when the
time is whole.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def causal_pairs(Sq: int, Sk: int, causal: bool, q_offset: int = 0) -> int:
    """Query-key pairs one (row, head) scores: under the causal mask query
    i (at absolute position ``q_offset + i``) sees keys 0 .. q_offset + i,
    at most Sk; without it Sq x Sk."""
    if not causal:
        return Sq * Sk
    full = max(0, min(Sq, Sk - q_offset))
    return full * q_offset + full * (full + 1) // 2 + (Sq - full) * Sk


def k5(B: int, Sq: int, Sk: int, H: int, K: int, D: int, causal: bool,
       itemsize: int, stats: bool = False) -> tuple:
    """(FLOPs, bytes) of one flash-attention call: QK^T and PV over the
    visible pairs, q, k, v read and the output written once (with
    ``stats`` the (B, H, Sq) f32 log-sum-exp too)."""
    flops = 4 * D * B * H * causal_pairs(Sq, Sk, causal)
    nbytes = itemsize * (2 * B * Sq * H * D + 2 * B * Sk * K * D)
    return flops, nbytes + (4 * B * H * Sq if stats else 0)


def k6(B: int, H: int, K: int, D: int, itemsize: int, n: int) -> tuple:
    """(FLOPs, bytes) of one decode-attention call over ``n`` valid
    positions of each row's cache: q read, n positions of K and V read,
    the output written."""
    return (4 * D * B * H * n,
            itemsize * (2 * B * H * D + 2 * B * n * K * D))


def ssd_flop_parts(Bt: int, S: int, H: int, P: int, G: int, N: int,
                   Q: int) -> tuple:
    """The chunked SSD scan's products over the causal half of each chunk:
    C·B^T per (batch, group, chunk); its product with dt·x and the two
    state terms per (batch, head, chunk)."""
    nc = -(-S // Q)
    pairs = Q * (Q + 1) // 2
    return (Bt * G * nc * 2 * pairs * N, Bt * H * nc * 2 * pairs * P,
            Bt * H * nc * 4 * Q * N * P)


def k8(Bt: int, S: int, H: int, P: int, G: int, N: int, Q: int,
       itemsize: int) -> tuple:
    """(FLOPs, bytes) of one SSD-scan call: x, B, C read (``itemsize``),
    dt (f32), A, D and the initial state read, y and the f32 final state
    written."""
    state = 4 * Bt * H * P * N
    nbytes = (itemsize * (2 * Bt * S * H * P + 2 * Bt * S * G * N)
              + 4 * Bt * S * H + 8 * H + 2 * state)
    return sum(ssd_flop_parts(Bt, S, H, P, G, N, Q)), nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    at the bf16 peak and the bytes at the HBM peak."""
    return max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
