"""The port's CUDA kernels on the card (marker ``cuda``; skip without one).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, at the repo's kernel tolerances (2e-5 in f32 with TF32 off, 3e-2
in bf16); the smoke model's kernel path against its ``backend="torch"``
path.  This file imports no JAX: the machine with the card has none.  Run
it there with ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import ExecConfig, build_model

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}

FLASH_CASES = [
    # B, Sq, Sk, H, K, D, causal, q_offset
    (2, 16, 16, 4, 2, 16, True, 0),
    (2, 17, 33, 6, 2, 16, False, 0),
    (1, 1, 40, 8, 2, 32, True, 39),
    (4, 512, 512, 16, 16, 64, True, 0),         # the serving prefill
    (2, 100, 300, 8, 2, 64, True, 200),
    (2, 77, 77, 8, 8, 128, False, 0),
]
DECODE_CASES = [
    # B, S, H, K, D
    (2, 64, 8, 2, 16), (3, 40, 4, 4, 32), (1, 128, 16, 2, 64),
    (4, 544, 16, 16, 64),                       # the serving decode
    (3, 300, 16, 4, 128),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device=device, dtype=dtype)


def _close(got, want, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_on_card(card, case, dtype):
    B, Sq, Sk, H, K, D, causal, off = case
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, Sq, H, D), dtype, card)
    k, v = (_randn(rng, (B, Sk, K, D), dtype, card) for _ in range(2))
    n = flash_ops.LAUNCHES
    got = flash_attention(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == n + 1
    _close(got, attention_ref(q, k, v, causal=causal, q_offset=off), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_on_card(card, case, dtype):
    B, S, H, K, D = case
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, H, D), dtype, card)
    k, v = (_randn(rng, (B, S, K, D), dtype, card) for _ in range(2))
    lens = rng.integers(1, S + 1, size=(B,))
    lengths = torch.as_tensor(lens, dtype=torch.int32, device=card)
    for b, n in enumerate(lens):                 # garbage past the length
        k[b, n:], v[b, n:] = 1e4, -1e4
    n = decode_ops.LAUNCHES
    got = decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert decode_ops.LAUNCHES == n + 1
    _close(got, decode_attention_ref(q, k, v, lengths), dtype)


@pytest.mark.cuda
def test_decode_kernel_length_zero_gives_zero(card):
    q = torch.ones(2, 4, 64, device=card)
    kv = torch.ones(2, 64, 4, 64, device=card)
    lengths = torch.tensor([0, 64], dtype=torch.int32, device=card)
    got = decode_attention(q, kv, kv, lengths)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(got[1], torch.ones_like(got[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_model_kernel_path_matches_plain_path(card, dtype):
    cfg = smoke_config("qwen1.5-0.5b").with_overrides(dtype=dtype,
                                                      param_dtype=dtype)
    kern = build_model(cfg, ExecConfig())
    plain = build_model(cfg, ExecConfig(backend="torch"))
    params = kern.init(torch.Generator(device=card).manual_seed(0), card)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)), dtype=torch.int32, device=card)
    tol = 1e-4 if dtype == "float32" else 5e-2
    with torch.no_grad():
        torch.testing.assert_close(kern.logits(params, tokens),
                                   plain.logits(params, tokens),
                                   atol=tol, rtol=tol)
        caches = [m.init_cache(2, 28, card) for m in (kern, plain)]
        (lk, _, n), (lp, _, _) = (m.prefill(params, tokens, c)
                                  for m, c in zip((kern, plain), caches))
        for i in range(4):
            torch.testing.assert_close(lk, lp, atol=tol, rtol=tol)
            tok = lp.argmax(-1).to(torch.int32)
            idx = torch.full((2,), n + i, dtype=torch.int32, device=card)
            lk, _ = kern.decode_step(params, tok, caches[0], idx)
            lp, _ = plain.decode_step(params, tok, caches[1], idx)
        torch.testing.assert_close(lk, lp, atol=tol, rtol=tol)
