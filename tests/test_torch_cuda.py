"""The port's CUDA kernels on the card (marker ``cuda``; skip without one).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, at the repo's kernel tolerances (2e-5 in f32 with TF32 off, 3e-2
in bf16); the smoke model's kernel path against its ``backend="torch"``
path.  The state-push kernels are held tighter: K1's codes, scales and
residual equal the numpy host codec's bitwise, K4's codes and scales its
plain version's (``.to(torch.float8_e4m3fn)``) bitwise, at the stats
vector's size (151,936), at 16 Mi elements and at a ragged size.  K7 (the
grouped matmul) is held at 1e-4 in f32 (the reference's gmm tolerance)
and 3e-2 in bf16, at deepseek-moe-16b's shapes.  This
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
from repro_torch.kernels.moe_gmm import gmm, gmm_ref
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.state_push import hostcodec
from repro_torch.kernels.state_push import ops as sp_ops
from repro_torch.models import ExecConfig, build_model
from repro_torch.models import moe

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


# -- grouped matmul (K7) ---------------------------------------------------------

GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
GMM_CASES = {
    # name: (T, d, f, group sizes: expert draws of T rows, or a list)
    "decode_gate_up": (24, 2048, 1408, "draws"),
    "decode_down": (24, 1408, 2048, "draws"),
    "prefill_some_empty": (12_288, 2048, 1408, "skewed"),
    "one_expert": (300, 2048, 1408, [0] * 17 + [300] + [0] * 46),
    "rows_past_the_groups": (200, 512, 1408, "tail"),
    "fewer_rows_than_a_tile": (5, 2048, 1408, [0] * 3 + [2] + [0] * 36 + [3]
                               + [0] * 23),
}


def _gmm_inputs(card, case, dtype, seed=0):
    T, d, f, sizes = GMM_CASES[case]
    rng = np.random.default_rng(seed)
    if sizes == "draws":
        sizes = np.bincount(rng.integers(0, 64, T), minlength=64)
    elif sizes == "skewed":                 # 16 of the 64 experts empty
        active = rng.permutation(64)[:48]
        sizes = np.bincount(active[rng.integers(0, 48, T)], minlength=64)
    elif sizes == "tail":
        sizes = np.bincount(rng.integers(0, 64, 3 * T // 4), minlength=64)
    gs = torch.as_tensor(np.asarray(sizes), dtype=torch.int32, device=card)
    x = _randn(rng, (T, d), dtype, card)
    w = (_randn(rng, (64, d, f), torch.float32, card) * d ** -0.5).to(dtype)
    return x, w, gs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(GMM_CASES))
def test_gmm_kernel_on_card(card, case, dtype):
    x, w, gs = _gmm_inputs(card, case, dtype)
    junk = torch.full((x.shape[0], w.shape[2]), float("nan"), dtype=dtype,
                      device=card)
    del junk                     # unwritten output rows would show as NaN
    n = gmm_ops.LAUNCHES.value
    got = gmm(x, w, gs)
    torch.cuda.synchronize()
    assert gmm_ops.LAUNCHES.value == n + 1
    want = gmm_ref(x, w, gs)
    torch.testing.assert_close(got.float(), want.float(), atol=GMM_TOL[dtype],
                               rtol=GMM_TOL[dtype])
    assert got.dtype == dtype
    assert not got[int(gs.sum()):].any()


@pytest.mark.cuda
def test_gmm_kernel_refuses_bad_cuda_operands(card):
    x = torch.zeros(24, 64, device=card)
    w = torch.zeros(4, 64, 32, device=card)
    gs = torch.zeros(4, dtype=torch.int32, device=card)
    n = gmm_ops.LAUNCHES.value
    with pytest.raises(ValueError, match="multiples of 8"):
        gmm(x, torch.zeros(4, 64, 30, device=card), gs)
    with pytest.raises(ValueError, match="contiguous"):
        gmm(torch.zeros(64, 24, device=card).T, w, gs)
    with pytest.raises(ValueError, match="operands on"):
        gmm(x, w, gs.cpu())
    with pytest.raises(ValueError, match="dtypes"):
        gmm(x.half(), w.half(), gs)
    assert gmm_ops.LAUNCHES.value == n


def _routes(monkeypatch, store):
    fn = moe.router_topk

    def wrapped(p, cfg, x2d):
        out = fn(p, cfg, x2d)
        store.append(out[1].sort(-1).values.cpu())
        return out

    monkeypatch.setattr(moe, "router_topk", wrapped)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_smoke_model_kernel_path_matches_plain_path(card, dtype,
                                                        monkeypatch):
    """The deepseek-moe-16b smoke model through K5, K6 and K7 against its
    plain path.  In bf16 the two paths round apart, so a near-tie of the
    router can pick another expert; a row that such a flip can reach (a
    flip at or before it in its sequence, in any layer) is excused from
    the tolerance, and the argmax must agree on 90% of all rows."""
    cfg = smoke_config("deepseek-moe-16b").with_overrides(dtype=dtype,
                                                          param_dtype=dtype)
    n_moe = cfg.n_layers - cfg.first_k_dense
    kern = build_model(cfg, ExecConfig())
    plain = build_model(cfg, ExecConfig(backend="torch"))
    params = kern.init(torch.Generator(device=card).manual_seed(0), card)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)), dtype=torch.int32, device=card)
    tol = 1e-4 if dtype == "float32" else 5e-2

    def run(m, teacher=None):
        """Full logits, prefill and 4 decode steps (fed ``teacher`` or the
        run's own argmax), with every router call's expert sets."""
        routes = []
        _routes(monkeypatch, routes)
        out, toks = [m.logits(params, tokens)], []
        cache = m.init_cache(2, 28, card)
        lg, _, n = m.prefill(params, tokens, cache)
        out.append(lg)
        for i in range(4):
            tok = lg.argmax(-1).to(torch.int32) if teacher is None \
                else teacher[i]
            toks.append(tok)
            idx = torch.full((2,), n + i, dtype=torch.int32, device=card)
            lg, _ = m.decode_step(params, tok, cache, idx)
            out.append(lg)
        monkeypatch.undo()
        return out, routes, toks

    with torch.no_grad():
        pout, proutes, ptoks = run(plain)
        kout, kroutes, _ = run(kern, teacher=ptoks)
    assert len(kroutes) == len(proutes) == n_moe * 6
    flips = [(a != b).any(-1) for a, b in zip(kroutes, proutes)]
    per_call = [torch.stack(flips[i:i + n_moe]).any(0)
                for i in range(0, len(flips), n_moe)]
    reach_fwd = per_call[0].reshape(2, 24).int().cummax(1).values.bool()
    reach = per_call[1].reshape(2, 24).any(1)
    masks = [~reach_fwd.to(card), ~reach.to(card)]
    for step in per_call[2:]:
        reach = reach | step
        masks.append(~reach.to(card))
    if dtype == "float32":
        assert not any(bool(f.any()) for f in flips)
    agree = []
    for k, p, ok in zip(kout, pout, masks):
        torch.testing.assert_close(k[ok], p[ok], atol=tol, rtol=tol)
        agree.append((k.argmax(-1) == p.argmax(-1)).float().mean().item())
    assert np.mean(agree) >= 0.9, agree


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
