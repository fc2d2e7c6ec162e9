"""The port's CUDA kernels on the card (marker ``cuda``; skip without one).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, at the repo's kernel tolerances (2e-5 in f32 with TF32 off, 3e-2
in bf16); the smoke model's kernel path against its ``backend="torch"``
path.  The state-push kernels are held tighter: K1's codes, scales and
residual equal the numpy host codec's bitwise, K4's codes and scales its
plain version's (``.to(torch.float8_e4m3fn)``) bitwise, at the stats
vector's size (151,936), at 16 Mi elements and at a ragged size.  This
file imports no JAX: the machine with the card has none.  Run it there
with ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
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
from repro_torch.kernels.state_push import hostcodec
from repro_torch.kernels.state_push import ops as sp_ops
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
    (1, 16, 16, 16, 16, 64, True, 0),           # the fan-out's forward
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
    n = flash_ops.LAUNCHES.value
    got = flash_attention(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES.value == n + 1
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
    n = decode_ops.LAUNCHES.value
    got = decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert decode_ops.LAUNCHES.value == n + 1
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


# -- state push (K1-K4) ----------------------------------------------------------

SP_SIZES = [151_936, 16 << 20, 4097]


def _sp_rows(card, n, seed):
    rng = np.random.default_rng(seed)
    eff, base = (rng.normal(size=n).astype(np.float32) for _ in range(2))
    lr, _ = sp_ops._to_rows(torch.from_numpy(eff).to(card))
    br, _ = sp_ops._to_rows(torch.from_numpy(base).to(card))
    return eff, base, lr, br


def _counted(name, fn):
    c = sp_ops.LAUNCHES[name].value
    out = fn()
    torch.cuda.synchronize()
    assert sp_ops.LAUNCHES[name].value == c + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("n", SP_SIZES)
def test_quantize_kernel_on_card(card, n, qmax):
    eff, base, lr, br = _sp_rows(card, n, n + qmax)
    q, s, r = _counted("quantize_delta", lambda: sp_ops.quantize_rows(
        lr, br, qmax=qmax, with_residual=True))
    qh, sh, _, rh = hostcodec.encode_quant(eff, base, qmax=qmax)
    np.testing.assert_array_equal(q.cpu().numpy(), qh)
    np.testing.assert_array_equal(s.cpu().numpy(), sh)
    np.testing.assert_array_equal(r.reshape(-1)[:n].cpu().numpy(), rh)
    qp, sp, rp = sp_ops.quantize_rows(lr, br, qmax=qmax, with_residual=True,
                                      backend="torch")
    assert torch.equal(s, sp)
    assert int((q.int() - qp.int()).abs().max()) == 0
    torch.testing.assert_close(r, rp, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", SP_SIZES)
def test_quantize_fp8_kernel_on_card(card, n):
    _, _, lr, br = _sp_rows(card, n, n)
    lr = lr * 1e3                                  # past +-448 before scaling
    q, s, r = _counted("quantize_fp8", lambda: sp_ops.quantize_rows(
        lr, br, fp8=True, with_residual=True))
    qp, sp, rp = sp_ops.quantize_rows(lr, br, fp8=True, with_residual=True,
                                      backend="torch")
    assert q.dtype == torch.float8_e4m3fn
    assert torch.equal(q.view(torch.uint8), qp.view(torch.uint8))
    assert torch.equal(s, sp)
    assert bool(torch.isfinite(q.float()).all())
    torch.testing.assert_close(r, rp, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("fp8", [False, True], ids=["int8", "e4m3"])
@pytest.mark.parametrize("n", SP_SIZES)
def test_apply_kernel_on_card(card, n, fp8):
    _, _, lr, br = _sp_rows(card, n, n + 1)
    q, s, _ = sp_ops.quantize_rows(lr, br, fp8=fp8, backend="torch")
    g = lr.flip(0).contiguous()
    out = _counted("apply_delta", lambda: sp_ops.apply_rows(g, q, s))
    assert out.data_ptr() != g.data_ptr()
    torch.testing.assert_close(out, sp_ops.apply_rows(g, q, s,
                                                      backend="torch"),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", SP_SIZES)
def test_push_kernel_on_card(card, n):
    _, _, lr, br = _sp_rows(card, n, n + 2)
    g = lr.flip(0).contiguous()
    out = _counted("push", lambda: sp_ops.push_rows(lr, br, g))
    torch.testing.assert_close(out, sp_ops.push_rows(lr, br, g,
                                                     backend="torch"),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_numpy_encode_on_card_matches_host_codec(card):
    """The fan-out's path: host numpy operands encoded on the card come
    back equal to the host codec, residual included."""
    rng = np.random.default_rng(1)
    eff, base = (rng.normal(size=151_936).astype(np.float32)
                 for _ in range(2))
    got = _counted("quantize_delta",
                   lambda: sp_ops.encode_quant(eff, base, device=card))
    for a, b in zip(got, hostcodec.encode_quant(eff, base)):
        np.testing.assert_array_equal(a, b)
    q, s, n, r = sp_ops.encode_quant(torch.from_numpy(eff).to(card),
                                     torch.from_numpy(base).to(card))
    assert isinstance(r, torch.Tensor) and r.device.type == "cuda"
    np.testing.assert_array_equal(q, got[0])


@pytest.mark.cuda
def test_device_replica_pull_applies_on_card(card):
    """A device replica on the card catches up through a delta pull: the
    frame is applied by K2 into a new tensor."""
    from repro_torch.state.kv import GlobalTier
    from repro_torch.state.local import LocalTier
    n = 151_936
    gt = GlobalTier(device=card)
    gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
    pusher, puller = LocalTier("a", gt), LocalTier("b", gt)
    for lt in (pusher, puller):
        lt.pull("w")
    dv = pusher.to_device("w", track_delta=True)
    pusher.update_device("w", dv + 0.5)
    _counted("quantize_delta", lambda: pusher.push_delta("w", wire="int8"))
    before = puller.to_device("w")
    c = sp_ops.LAUNCHES["apply_delta"].value
    assert puller.pull("w", wire="int8") > 0
    assert sp_ops.LAUNCHES["apply_delta"].value == c + 1
    after = puller.device_replica("w").value
    assert after.device.type == "cuda" and float(before.abs().max()) == 0.0
    torch.testing.assert_close(after, torch.full_like(after, 0.5),
                               atol=0.5 / 254, rtol=0)
