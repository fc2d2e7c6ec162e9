"""The port's attention kernels against the JAX package's.

On the CPU the port's wrappers take their plain PyTorch versions; they are
held against ``repro``'s ``backend="xla"`` paths (and one Pallas
interpret-mode row per kernel) on the same numpy inputs, at the repo's
kernel tolerances: 2e-5 in f32, 3e-2 in bf16.  The wrappers' argument
checks and the kernel build are exercised without a card.  The CUDA
kernels themselves are held against the plain versions on the card by
``test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import _build
from repro_torch.kernels.common import dispatch
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# the cases of tests/test_kernels.py
FLASH_CASES = [
    # B, Sq, Sk, H, K, D, causal, q_offset
    (2, 16, 16, 4, 2, 16, True, 0),
    (1, 8, 24, 4, 4, 8, True, 16),
    (2, 17, 33, 6, 2, 16, False, 0),
    (1, 1, 40, 8, 2, 32, True, 39),
    (2, 16, 16, 4, 1, 16, True, 0),          # MQA
]
DECODE_CASES = [(2, 64, 8, 2, 16), (3, 40, 4, 4, 32), (1, 128, 16, 2, 64)]


def _pair(rng, shape, dtype: str):
    """The same values as a JAX array and a torch tensor (bf16 rounds the
    same way in both)."""
    x = rng.normal(size=shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(jax_out, torch_out, tol):
    np.testing.assert_allclose(np.asarray(jax_out, np.float32),
                               torch_out.float().numpy(), atol=tol, rtol=tol)


def _flash_inputs(case, dtype, seed=0):
    B, Sq, Sk, H, K, D, causal, off = case
    rng = np.random.default_rng(seed)
    return (_pair(rng, (B, Sq, H, D), dtype), _pair(rng, (B, Sk, K, D), dtype),
            _pair(rng, (B, Sk, K, D), dtype))


def _decode_inputs(case, dtype, seed=0):
    B, S, H, K, D = case
    rng = np.random.default_rng(seed)
    q, k, v = (_pair(rng, (B, H, D), dtype), _pair(rng, (B, S, K, D), dtype),
               _pair(rng, (B, S, K, D), dtype))
    lengths = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    return q, k, v, (jnp.asarray(lengths), torch.from_numpy(lengths))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_jax(case, dtype):
    causal, off = case[6], case[7]
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(case, dtype)
    want = jax_flash(qj, kj, vj, causal=causal, q_offset=off, backend="xla",
                     block_k=8)
    got = flash_attention(qt, kt, vt, causal=causal, q_offset=off)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(want, got, TOL[dtype])


def test_flash_attention_matches_jax_pallas_interpret():
    case = FLASH_CASES[1]
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(case, "float32")
    want = jax_flash(qj, kj, vj, causal=True, q_offset=case[7],
                     backend="pallas_interpret", block_q=8, block_k=8)
    _close(want, flash_attention(qt, kt, vt, causal=True, q_offset=case[7]),
           TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_matches_jax(case, dtype):
    (qj, qt), (kj, kt), (vj, vt), (lj, lt) = _decode_inputs(case, dtype)
    want = jax_decode(qj, kj, vj, lj, backend="xla")
    got = decode_attention(qt, kt, vt, lt)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(want, got, TOL[dtype])


def test_decode_attention_matches_jax_pallas_interpret():
    (qj, qt), (kj, kt), (vj, vt), (lj, lt) = _decode_inputs(DECODE_CASES[0],
                                                            "float32")
    want = jax_decode(qj, kj, vj, lj, backend="pallas_interpret", block_k=16)
    _close(want, decode_attention(qt, kt, vt, lt), TOL["float32"])


def test_decode_attention_ignores_garbage_past_length():
    (qj, qt), (kj, kt), (vj, vt), _ = _decode_inputs((2, 32, 4, 2, 16),
                                                     "float32")
    lengths = np.array([10, 20], np.int32)
    want = jax_decode(qj, kj, vj, jnp.asarray(lengths), backend="xla")
    kt[0, 15:], vt[0, 15:] = 1e9, -1e9               # garbage beyond length
    _close(want, decode_attention(qt, kt, vt, torch.from_numpy(lengths)),
           TOL["float32"])


def test_backend_torch_is_the_plain_version():
    (_, qt), (_, kt), (_, vt) = _flash_inputs(FLASH_CASES[0], "float32")
    assert torch.equal(flash_attention(qt, kt, vt, backend="torch"),
                       attention_ref(qt, kt, vt))
    (_, qd), (_, kd), (_, vd), (_, lt) = _decode_inputs(DECODE_CASES[0],
                                                        "float32")
    assert torch.equal(decode_attention(qd, kd, vd, lt, backend="torch"),
                       decode_attention_ref(qd, kd, vd, lt))


def test_dispatch_by_device():
    assert dispatch(None, torch.zeros(1)) == "torch"
    assert dispatch("torch", torch.zeros(1, device="meta")) == "torch"
    with pytest.raises(ValueError, match="no kernel"):
        dispatch(None, torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="backend"):
        dispatch("xla", torch.zeros(1))


def _bad_flash_args():
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    return {    # case: (expected message, operands)
        "dtype": ("dtypes", (q.half(), k.half(), k.half())),
        "head_dim": ("head dim", (torch.zeros(1, 8, 4, 48),
                                  torch.zeros(1, 8, 2, 48),
                                  torch.zeros(1, 8, 2, 48))),
        "kv_heads": ("KV heads", (q, torch.zeros(1, 8, 3, 64),
                                  torch.zeros(1, 8, 3, 64))),
        "strides": ("contiguous",
                    (q.transpose(1, 2).contiguous().transpose(1, 2), k, k)),
        "shape": (r"v \(1, 9", (q, k, torch.zeros(1, 9, 2, 64))),
    }


@pytest.mark.parametrize("case", list(_bad_flash_args()))
def test_flash_wrapper_refuses_before_launch(case):
    """The CUDA path checks its operands before anything is built or
    launched (called here directly on CPU tensors)."""
    message, args = _bad_flash_args()[case]
    n = flash_ops.LAUNCHES.value
    with pytest.raises(ValueError, match=message):
        flash_ops._flash_cuda(*args, True, 0.125, 0)
    assert flash_ops.LAUNCHES.value == n


def test_decode_wrapper_refuses_before_launch():
    q, kv = torch.zeros(2, 4, 64), torch.zeros(2, 16, 2, 64)
    n = decode_ops.LAUNCHES.value
    with pytest.raises(ValueError, match="lengths"):
        decode_ops._decode_cuda(q, kv, kv, torch.ones(2, dtype=torch.int64),
                                0.125)
    with pytest.raises(ValueError, match="contiguous"):
        decode_ops._decode_cuda(q, kv[:, ::2], kv[:, ::2],
                                torch.ones(2, dtype=torch.int32), 0.125)
    assert decode_ops.LAUNCHES.value == n


@pytest.mark.parametrize("B,K,S", [(4, 16, 544), (1, 1, 32768), (128, 8, 100),
                                   (2, 2, 1), (3, 4, 1000)])
def test_split_plan_covers_the_cache(B, K, S):
    split_len, n_splits = decode_ops.split_plan(B, K, S, n_sm=132)
    assert split_len % decode_ops.CHUNK == 0
    assert n_splits * split_len >= S > (n_splits - 1) * split_len
    if (B, K, S) == (4, 16, 544):              # the serving decode shape
        assert (split_len, n_splits) == (64, 9)


def test_failed_build_raises_and_leaves_no_library(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")   # exits 1
    with pytest.raises(RuntimeError, match="kernel build failed"):
        _build.build(["flash_attention"])
    assert list(tmp_path.iterdir()) == []


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for p in _build.CSRC.iterdir():
        (src / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", src)
    before = _build.library_path("decode_attention")
    (src / "common.cuh").write_text((src / "common.cuh").read_text() + "\n")
    assert _build.library_path("decode_attention") != before
