"""The port's CUDA kernels on the card (marker ``cuda``; skip without one).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, at the repo's kernel tolerances (2e-5 in f32 with TF32 off, 3e-2
in bf16); the smoke model's kernel path against its ``backend="torch"``
path.  The state-push kernels are held tighter: K1's codes, scales and
residual equal the numpy host codec's bitwise, K4's codes and scales its
plain version's (``.to(torch.float8_e4m3fn)``) bitwise, at the stats
vector's size (151,936), at 16 Mi elements and at a ragged size.  K7 (the
grouped matmul) is held at 1e-4 in f32 (the reference's gmm tolerance)
and 3e-2 in bf16, at deepseek-moe-16b's shapes and at the edges of its two
bf16 kernels (the regime threshold, TMA boxes, zero tiles, ragged f); K8
(the SSD scan) at 1e-4 in f32 on the reference's test distributions (the
reference's ssd tolerance) and 3e-2 with bf16 operands or the models' own
decays, at mamba2-130m's and zamba2-1.2b's prefill shapes and at the
ragged, short, long and grouped cases, and under autograd
(``SSDScanFn``: K8's forward, the plain chunked scan's backward) at the
same tolerances.  whisper-tiny's and internvl2-2b's shapes (K5 without a
mask over 1,500 keys, K6 over a full 1,500-frame cache and at G 2, D 128)
join the attention cases, and their smoke models run kernel path against
plain path and graphed loop against eager loop.  The twins of the paper's
experiments: Fig. 6 with one
worker trains the same weights on the card as on the CPU bitwise, on both
wires, and the Fig. 9 twin's rows hold and count their launches.  The
chaos suite's storm with the tiers on the card, on the int8 wire: K1
once per int8 encode, K2 once per frame a device replica pulls;
zamba2-1.2b's smoke model in the fan-out's compiled forward, replay
against eager.  This file imports no JAX: the
machine with the card has none.  Run it there with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import importlib
import sys
from pathlib import Path

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
from repro_torch.kernels.ssd_scan import ssd, ssd_chunked, ssd_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
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
    (4, 512, 512, 16, 16, 128, True, 0),        # deepseek-moe-16b's prefill
    (4, 512, 512, 32, 32, 64, True, 0),         # zamba2-1.2b's shared block
    (2, 200, 330, 8, 8, 128, True, 130),        # ragged tiles, q_offset, D 128
    (2, 150, 150, 16, 4, 128, True, 0),         # GQA G=4, D 128
    (2, 40, 50, 8, 2, 64, True, 10),            # fewer keys than one KV tile
    (1, 70, 20, 4, 4, 128, False, 0),
    (4, 512, 512, 32, 8, 128, True, 0),         # qwen3-4b's, granite-3-8b's
    (4, 512, 512, 36, 4, 128, True, 0),         # starcoder2-7b's prefill: G 9
    (4, 1500, 1500, 6, 6, 64, False, 0),        # whisper-tiny's encoder
    (4, 512, 1500, 6, 6, 64, False, 0),         # its cross-attention
    (4, 512, 512, 6, 6, 64, True, 0),           # its decoder: H 6
    (4, 768, 768, 16, 8, 128, True, 0),         # internvl2-2b's prefill: G 2
    (2, 300, 1500, 16, 8, 128, False, 0),       # ragged Sk, no mask, D 128
]
DECODE_CASES = [
    # B, S, H, K, D
    (2, 64, 8, 2, 16), (3, 40, 4, 4, 32), (1, 128, 16, 2, 64),
    (4, 544, 16, 16, 64),                       # the serving decode
    (3, 300, 16, 4, 128),
    (4, 544, 16, 16, 128),                      # deepseek-moe-16b's
    (4, 544, 32, 32, 64),                       # zamba2-1.2b's shared block
    (3, 400, 16, 8, 64),                        # G 2
    (2, 1000, 8, 1, 64),                        # G 8 (MQA), a long cache
    (2, 777, 36, 4, 128),                       # G 9: two head groups
    (4, 544, 32, 8, 128),                       # qwen3-4b's, granite-3-8b's
    (4, 544, 36, 4, 128),                       # starcoder2-7b's: G 9
    (4, 544, 6, 6, 64),                         # whisper-tiny's decoder
    (4, 1500, 6, 6, 64),                        # its cross-attention cache
    (4, 800, 16, 8, 128),                       # internvl2-2b's: G 2, D 128
]
# H, K, D at batch 4 over a cache of 544: the five served shapes (the
# last two grouped, G 4 and G 9), G 2, 4, 8
DECODE_EDGE_SHAPES = [(16, 16, 64), (16, 16, 128), (32, 32, 64),
                      (32, 8, 128), (36, 4, 128),
                      (16, 8, 64), (16, 4, 128), (8, 1, 64)]


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [(4, 1500, 6, 6, 64), (4, 1500, 16, 8, 128)])
def test_decode_kernel_over_a_full_cross_attention_cache(card, case, dtype):
    """A cross-attention cache that every sequence fills (whisper-tiny's
    1,500 frames): each length equals the capacity, which is no power of
    two."""
    B, S, H, K, D = case
    rng = np.random.default_rng(1)
    q = _randn(rng, (B, H, D), dtype, card)
    k, v = (_randn(rng, (B, S, K, D), dtype, card) for _ in range(2))
    lengths = torch.full((B,), S, dtype=torch.int32, device=card)
    got = decode_attention(q, k, v, lengths)
    _close(got, decode_attention_ref(q, k, v, lengths), dtype)


@pytest.mark.cuda
def test_decode_kernel_length_zero_gives_zero(card):
    q = torch.ones(2, 4, 64, device=card)
    kv = torch.ones(2, 64, 4, 64, device=card)
    lengths = torch.tensor([0, 64], dtype=torch.int32, device=card)
    got = decode_attention(q, kv, kv, lengths)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(got[1], torch.ones_like(got[1]))


def _decode_operands(card, B, S, H, K, D, dtype, lens, seed=0):
    rng = np.random.default_rng(seed)
    q = _randn(rng, (B, H, D), dtype, card)
    k, v = (_randn(rng, (B, S, K, D), dtype, card) for _ in range(2))
    for b, n in enumerate(lens):                 # garbage past the length
        k[b, n:], v[b, n:] = 1e4, -1e4
    return q, k, v, torch.as_tensor(lens, dtype=torch.int32, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", DECODE_EDGE_SHAPES)
def test_decode_kernel_length_edges_on_card(card, shape, dtype):
    """Lengths 0, 1, one split, one split and a key, and the whole cache,
    in one batch: the split plan's edges, and the last block's reduction
    over one split or all of them."""
    H, K, D = shape
    S = 544
    gt = decode_ops.heads_per_block(H // K)
    split_len, n_splits = decode_ops.split_plan(
        5, K * -(-(H // K) // gt), S,
        torch.cuda.get_device_properties(card).multi_processor_count,
        decode_ops.tile_keys(D, torch.tensor([], dtype=dtype).element_size()))
    assert n_splits > 1
    lens = (0, 1, split_len, split_len + 1, S)
    q, k, v, lengths = _decode_operands(card, 5, S, H, K, D, dtype, lens)
    got = decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got[1:], decode_attention_ref(q, k, v, lengths)[1:], dtype)


# (B, S, H, K, D, lengths): the served plan, 5 splits a pair; and a long
# cache at batch 1, 64 splits of one pair on one counter
DECODE_PLANS = {
    "served": (4, 544, 16, 16, 64, (513, 530, 543, 544)),
    "long_cache": (1, 4096, 8, 1, 64, (4000,)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("plan", list(DECODE_PLANS))
def test_decode_kernel_two_calls_in_a_row_agree_and_leave_counters_at_0(card, plan):
    B, S, H, K, D, lens = DECODE_PLANS[plan]
    q, k, v, lengths = _decode_operands(card, B, S, H, K, D, torch.bfloat16,
                                        lens)
    first = decode_attention(q, k, v, lengths)
    second = decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _close(first, decode_attention_ref(q, k, v, lengths), torch.bfloat16)
    for c in decode_ops._COUNTERS.values():
        assert int(c.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("plan", list(DECODE_PLANS))
def test_decode_kernel_graph_replay_on_card(card, plan):
    """A CUDA graph of one call, replayed 3 times, equals the eager call
    (the last block resets the counter it counted on); new lengths
    written into the captured tensor are read on the card."""
    B, S, H, K, D, lens = DECODE_PLANS[plan]
    q, k, v, lengths = _decode_operands(card, B, S, H, K, D, torch.bfloat16,
                                        lens)
    eager = decode_attention(q, k, v, lengths)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):        # warm-up on the capture stream
        decode_attention(q, k, v, lengths)
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        out = decode_attention(q, k, v, lengths)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    lengths.copy_(torch.tensor([1, 64, 65, 300][:B], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, decode_attention(q, k, v, lengths))


@pytest.mark.cuda
def test_decode_kernel_two_streams_at_once_on_card(card):
    """Calls queued on two streams at once, each combining 64 splits
    through its counters: each stream has counters of its own, so neither
    call's last-block count is taken by the other's."""
    a = _decode_operands(card, 1, 4096, 8, 1, 64, torch.bfloat16, (4000,),
                         seed=1)
    b = _decode_operands(card, 1, 4096, 8, 1, 64, torch.bfloat16, (2500,),
                         seed=2)
    want_a, want_b = decode_attention(*a), decode_attention(*b)
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(20):
        with torch.cuda.stream(streams[0]):
            outs.append((decode_attention(*a), want_a))
        with torch.cuda.stream(streams[1]):
            outs.append((decode_attention(*b), want_b))
    torch.cuda.synchronize()
    for got, want in outs:
        assert torch.equal(got, want)
    dev = torch.device(card).index or 0
    sets = [decode_ops._COUNTERS[(dev, st.cuda_stream)] for st in streams]
    assert sets[0].data_ptr() != sets[1].data_ptr()


@pytest.mark.cuda
def test_decode_kernel_graph_outlives_a_larger_call_on_its_stream(card):
    """A graph captured at the served plan (4 x 16 counted pairs) still
    replays right after an eager call on its capture stream needed more
    counters than the set held (33 x 32 pairs, past 1,024): the set it
    counts on was kept, not freed, and memory handed out since then does
    not touch it."""
    small = _decode_operands(card, 4, 544, 16, 16, 64, torch.bfloat16,
                             (513, 530, 543, 544))
    large = _decode_operands(card, 33, 256, 32, 32, 64, torch.bfloat16,
                             tuple(range(100, 256, 4))[:33])
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):        # warm-up on the capture stream
        eager = decode_attention(*small)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        out = decode_attention(*small)
    dev = torch.device(card).index or 0
    before = decode_ops._COUNTERS[(dev, s.cuda_stream)]
    ptr, n = before.data_ptr(), before.numel()
    del before                        # the test holds no reference to it
    with torch.cuda.stream(s):
        got = decode_attention(*large)
        after = decode_ops._COUNTERS[(dev, s.cuda_stream)]
        assert after.numel() > n
        junk = [torch.full((1 << 16,), 7, dtype=torch.int32, device=card)
                for _ in range(64)]    # reuses memory a freed set would have
        for _ in range(3):
            graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    _close(got, decode_attention_ref(*large), torch.bfloat16)
    kept = [c for c in decode_ops._OUTGROWN if c.data_ptr() == ptr]
    assert len(kept) == 1 and int(kept[0].abs().sum()) == 0
    assert int(after.abs().sum()) == 0
    del junk


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


def _family_inputs(card, cfg, B, S):
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             dtype=torch.int32, device=card)
    extra = _randn(rng, build_model(cfg).extra_shape(B), torch.bfloat16,
                   card)
    return tokens, extra


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-2b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_family_smoke_model_kernel_path_matches_plain_path(card, arch, dtype):
    """The encoder/decoder and the VLM on the card: the full forward, the
    prefill and four decode steps, kernel path against plain path, with
    their frames or patch embeddings (f32 1e-4, bf16 5e-2)."""
    cfg = smoke_config(arch).with_overrides(dtype=dtype, param_dtype=dtype)
    kern = build_model(cfg, ExecConfig())
    plain = build_model(cfg, ExecConfig(backend="torch"))
    params = kern.init(torch.Generator(device=card).manual_seed(0), card)
    tokens, extra = _family_inputs(card, cfg, 2, 24)
    pre = kern.prefix_len
    tol = 1e-4 if dtype == "float32" else 5e-2
    n5, n6 = flash_ops.LAUNCHES.value, decode_ops.LAUNCHES.value
    with torch.no_grad():
        torch.testing.assert_close(kern.logits(params, tokens, extra),
                                   plain.logits(params, tokens, extra),
                                   atol=tol, rtol=tol)
        caches = [m.init_cache(2, pre + 28, card) for m in (kern, plain)]
        (lk, _, n), (lp, _, _) = (m.prefill(params, tokens, c, extra)
                                  for m, c in zip((kern, plain), caches))
        assert n == pre + 24
        for i in range(4):
            torch.testing.assert_close(lk, lp, atol=tol, rtol=tol)
            tok = lp.argmax(-1).to(torch.int32)
            idx = torch.full((2,), n + i, dtype=torch.int32, device=card)
            lk, _ = kern.decode_step(params, tok, caches[0], idx)
            lp, _ = plain.decode_step(params, tok, caches[1], idx)
        torch.testing.assert_close(lk, lp, atol=tol, rtol=tol)
    per_prefill = (cfg.n_enc_layers + 2 * cfg.n_layers
                   if cfg.family == "encdec" else cfg.n_layers)
    per_step = 2 * cfg.n_layers if cfg.family == "encdec" else cfg.n_layers
    assert flash_ops.LAUNCHES.value - n5 == 2 * per_prefill   # + logits
    assert decode_ops.LAUNCHES.value - n6 == 4 * per_step


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-2b"])
def test_family_graphed_loop_equals_the_eager_loop_bitwise(card, arch):
    """The step graphs with the frames or patch embeddings as a static
    buffer: ids and logits bitwise the eager loop's, launches counted per
    replay as the eager loop counts them."""
    from repro_torch.launch.step_graphs import ServeGraphs, eager_generate
    cfg = smoke_config(arch)
    model = build_model(cfg, ExecConfig())
    params = model.init(torch.Generator(device=card).manual_seed(0), card)
    tokens, extra = _family_inputs(card, cfg, 2, GRAPH_PROMPT)
    new = 5
    counters = _kernel_counters()
    for c in counters.values():
        c.reset()
    want = eager_generate(model, params, tokens, new, keep_logits=True,
                          extra=extra)
    eager = _read(counters)
    graphs = ServeGraphs(model, params, 2, GRAPH_PROMPT,
                         model.prefix_len + GRAPH_PROMPT + new, card,
                         extra=extra)
    for c in counters.values():
        c.reset()
    got = graphs.generate(tokens, new, keep_logits=True)
    assert _read(counters) == eager
    assert torch.equal(got.ids, want.ids)
    for a, b in zip(got.logits, want.logits):
        assert torch.equal(a, b)
    graphs.close()


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
    # the edges of the two bf16 kernels (gmm_ops.plan): T on and one past
    # the threshold, groups starting at rows 3, 520 and 531 (inside a TMA
    # box of the tensor-core kernel), every expert but one in the middle,
    # a quarter of the rows past the groups at a large T (the tensor-core
    # kernel's zero tiles), f not a multiple of either kernel's columns
    "at_the_threshold": (gmm_ops.TC_BOX - 1, 2048, 1408, "draws"),
    "past_the_threshold": (gmm_ops.TC_BOX, 2048, 1408, "draws"),
    "groups_inside_a_tma_box": (1536, 2048, 1408, [3, 517, 11, 0, 0, 700]
                                + [0] * 57 + [305]),
    "one_empty_in_the_middle": (4096, 2048, 1408, "hole"),
    "large_t_rows_past_the_groups": (8192, 2048, 1408, "tail"),
    "f200_tensor_cores": (2048, 512, 200, "draws"),
    "f200_streaming": (24, 512, 200, "draws"),
    # d 32 streams at any T: a 300-row group over 19 row tiles, zero tiles
    "streaming_one_expert": (300, 32, 1408, [0] * 17 + [300] + [0] * 46),
    "streaming_rows_past_the_groups": (200, 32, 1408, "tail"),
    # the streaming kernel sizes its grid from T and E alone: every row
    # its own tile (47 groups of one row, one zero tile: 48 blocks, the
    # grid's whole extent), and a ragged tile in every group (d 32)
    "streaming_a_tile_per_row": (48, 2048, 1408, [1] * 47 + [0] * 17),
    "streaming_a_ragged_tile_per_group": (300, 32, 1408, [225] + [1] * 63),
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
    elif sizes == "hole":                   # expert 32 empty
        e = rng.integers(0, 63, T)
        sizes = np.bincount(e + (e >= 32), minlength=64)
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


@pytest.mark.cuda
def test_gmm_kernel_refuses_misaligned_operands(card):
    """TMA needs 16-byte aligned operands: a view 2 bytes into its storage
    is refused before any build or launch."""
    w = torch.zeros(4, 64, 32, dtype=torch.bfloat16, device=card)
    gs = torch.zeros(4, dtype=torch.int32, device=card)
    x = torch.zeros(24 * 64 + 1, dtype=torch.bfloat16,
                    device=card)[1:].view(24, 64)
    n = gmm_ops.LAUNCHES.value
    with pytest.raises(ValueError, match="16-byte aligned"):
        gmm(x, w, gs)
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


# -- SSD scan (K8) ----------------------------------------------------------------

SSD_CASES = {
    # name: (Bt, S, H, P, G, N, decays)
    "mamba2_prefill": (4, 512, 24, 64, 1, 128, "reference"),
    "zamba2_prefill": (4, 512, 64, 64, 1, 64, "reference"),
    "mamba2_model_decays": (4, 512, 24, 64, 1, 128, "model"),
    "ragged_S": (2, 1000, 8, 64, 1, 128, "reference"),
    "chunk_32": (2, 20, 8, 64, 1, 64, "reference"),
    "16_chunks": (1, 4096, 8, 64, 1, 64, "reference"),
    "groups_2": (2, 300, 8, 32, 2, 32, "reference"),
    "S_1024": (1, 1024, 8, 64, 1, 128, "reference"),
    "S_2048": (1, 2048, 8, 64, 1, 64, "reference"),
    "ragged_700": (2, 700, 8, 64, 1, 128, "reference"),
    "S_1024_model_decays": (1, 1024, 8, 64, 1, 128, "model"),
    "ragged_700_groups_2_model_decays": (2, 700, 8, 64, 2, 64, "model"),
    "P8_N8": (1, 24, 6, 8, 3, 8, "reference"),
    "P128": (2, 300, 4, 128, 1, 64, "reference"),
    "large_decays": (1, 512, 2, 64, 1, 64, "large"),
}


def _ssd_inputs(card, case, dtype, seed=0):
    """numpy draws: the reference's distributions (dt ~ U(0.01, 0.2),
    A ~ -U(0.5, 2)), the models' (dt = softplus(N(0, 1)), A ~ -U(1, 16)) or
    the reference's overflow case (dt ~ U(0.5, 3), A -12 and -16)."""
    Bt, S, H, P, G, N, decays = SSD_CASES[case]
    rng = np.random.default_rng(seed)
    x = _randn(rng, (Bt, S, H, P), dtype, card)
    if decays == "reference":
        dt, A = rng.uniform(0.01, 0.2, (Bt, S, H)), -rng.uniform(0.5, 2, H)
    elif decays == "model":
        dt, A = np.log1p(np.exp(rng.normal(size=(Bt, S, H)))), -rng.uniform(1, 16, H)
    else:
        dt, A = rng.uniform(0.5, 3, (Bt, S, H)), np.tile([-12.0, -16.0], H // 2)
    B, C = (_randn(rng, (Bt, S, G, N), dtype, card) for _ in range(2))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=card)
    return (x, f32(dt), f32(A), B, C, f32(rng.normal(size=H)),
            f32(rng.normal(size=(Bt, H, P, N))))


@pytest.mark.cuda
def test_ssd_grids_at_mamba2_prefill_have_768_output_blocks(card):
    """The launcher's grids at mamba2-130m's prefill (batch 4, 24 heads, 2
    chunks of 256, 64 channels): 4 query tiles of 64 in each chunk give
    768 output blocks, where one block per (64 channels, head, batch) made
    96; C·Bᵀ is formed once for the 24 heads of the group, 10 tiles at or
    below the diagonal per (batch, chunk)."""
    cb, state, pas, out = ssd_ops.grids(4, 512, 24, 64, 1, 128, 256)
    assert (cb, state, pas, out) == (80, 384, 768, 768)
    assert ssd_ops.grids(4, 512, 24, 64, 24, 128, 256)[0] == 24 * cb
    assert ssd_ops.grids(2, 700, 8, 64, 1, 128, 256)[3] == 2 * 8 * 3 * 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_kernel_on_card(card, case, dtype):
    x, dt, A, B, C, D, init = _ssd_inputs(card, case, dtype)
    S = x.shape[1]
    n = ssd_ops.LAUNCHES.value
    y, final = ssd(x, dt, A, B, C, D, initial_state=init)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES.value == n + 1
    assert y.dtype == dtype and final.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(final).all())
    chunk = min(256, max(16, 1 << (S - 1).bit_length()))
    yc, fc = ssd_chunked(x, dt, A, B, C, D, init, chunk)
    # the models' decays: the f32 cumulative sums reach -1e3, where summing
    # in another order moves them by more than 1e-4 (ROADMAP "Faults found")
    model_decays = SSD_CASES[case][-1] == "model"
    tol = 3e-2 if model_decays or dtype == torch.bfloat16 else 1e-4
    ftol = 3e-2 if model_decays else 1e-4      # the state is f32 either way
    torch.testing.assert_close(y.float(), yc.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(final, fc, atol=ftol, rtol=ftol)
    if S <= 1000:
        yr, fr = ssd_ref(x, dt, A, B, C, D, initial_state=init)
        torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_ssd_kernel_refuses_bad_cuda_operands(card):
    x, dt, A, B, C, D, init = _ssd_inputs(card, "P8_N8", torch.float32)
    n = ssd_ops.LAUNCHES.value
    with pytest.raises(ValueError, match="dtypes"):
        ssd(x.half(), dt, A, B.half(), C.half(), D, initial_state=init)
    with pytest.raises(ValueError, match="contiguous"):
        ssd(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B, C, D,
            initial_state=init)
    with pytest.raises(ValueError, match="operands on"):
        ssd(x, dt, A.cpu(), B, C, D, initial_state=init)
    with pytest.raises(ValueError, match="float32"):
        ssd(x, dt.double(), A, B, C, D, initial_state=init)
    with pytest.raises(ValueError, match="multiples of 8"):
        ssd(x[..., :4].contiguous(), dt, A, B, C, D,
            initial_state=init[..., :4, :].contiguous())
    assert ssd_ops.LAUNCHES.value == n


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_smoke_model_kernel_path_matches_plain_path(card, arch, dtype):
    """The SSM smoke models through K8 (and, for the hybrid, K5 and K6)
    against their plain path: full logits, prefill and four decode steps
    fed the plain path's tokens."""
    cfg = smoke_config(arch).with_overrides(dtype=dtype, param_dtype=dtype)
    kern = build_model(cfg, ExecConfig())
    plain = build_model(cfg, ExecConfig(backend="torch"))
    params = kern.init(torch.Generator(device=card).manual_seed(0), card)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)), dtype=torch.int32, device=card)
    tol = 1e-4 if dtype == "float32" else 5e-2
    n = ssd_ops.LAUNCHES.value
    with torch.no_grad():
        torch.testing.assert_close(kern.logits(params, tokens),
                                   plain.logits(params, tokens),
                                   atol=tol, rtol=tol)
        caches = [m.init_cache(2, 44, card) for m in (kern, plain)]
        (lk, _, n_tok), (lp, _, _) = (m.prefill(params, tokens, c)
                                      for m, c in zip((kern, plain), caches))
        for i in range(4):
            torch.testing.assert_close(lk, lp, atol=tol, rtol=tol)
            tok = lp.argmax(-1).to(torch.int32)
            idx = torch.full((2,), n_tok + i, dtype=torch.int32, device=card)
            lk, _ = kern.decode_step(params, tok, caches[0], idx)
            lp, _ = plain.decode_step(params, tok, caches[1], idx)
        torch.testing.assert_close(lk, lp, atol=tol, rtol=tol)
        for k in caches[0]:
            torch.testing.assert_close(caches[0][k].float(),
                                       caches[1][k].float(), atol=tol,
                                       rtol=tol)
    assert ssd_ops.LAUNCHES.value == n + 2 * cfg.n_layers


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


# -- the serving loop's compiled step (launch/step_graphs.py) ----------------

GRAPH_ARCHS = ["qwen1.5-0.5b", "deepseek-moe-16b", "mamba2-130m",
               "zamba2-1.2b", "qwen3-4b", "granite-3-8b", "starcoder2-7b"]


def _kernel_counters():
    return {"flash_attention": flash_ops.LAUNCHES,
            "decode_attention": decode_ops.LAUNCHES,
            "moe_gmm": gmm_ops.LAUNCHES, "ssd_scan": ssd_ops.LAUNCHES}


def _read(counters):
    return {k: (c.value, c.by_key()) for k, c in counters.items()}


# a prompt long enough that K6 splits its cache (2 splits at the smoke
# models' head dim 16), so its counters run in the graphs
GRAPH_PROMPT = 300


def _smoke_served(card, arch, B=2, S=GRAPH_PROMPT):
    cfg = smoke_config(arch)
    model = build_model(cfg, ExecConfig())
    params = model.init(torch.Generator(device=card).manual_seed(0), card)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32, device=card)
    return model, params, tokens


@pytest.mark.cuda
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_graphed_loop_equals_the_eager_loop_bitwise(card, arch):
    """The captured prefill and decode graphs, replayed, give the eager
    loop's ids and every step's logits bitwise (the same kernels in the
    same order), launch counts equal to the eager loop's, by kernel and
    key, and a warm-up of one prefill and one decode step; a second
    ``generate`` replays the same graphs and gives the same ids.  The
    cache has the eager loop's capacity, since K6's split plan (and so
    its order of summation) follows the capacity."""
    from repro_torch.launch.step_graphs import ServeGraphs, eager_generate
    model, params, tokens = _smoke_served(card, arch)
    new = 6
    counters = _kernel_counters()
    for c in counters.values():
        c.reset()
    eager_generate(model, params, tokens, 1)          # a prefill alone
    prefill_only = _read(counters)
    for c in counters.values():
        c.reset()
    want = eager_generate(model, params, tokens, new, keep_logits=True)
    eager_counts = _read(counters)
    S = GRAPH_PROMPT
    graphs = ServeGraphs(model, params, 2, S, S + new, card)
    warm = {k: graphs.warmup_launches.count(c) for k, c in counters.items()}
    per_step = {k: (eager_counts[k][0] - prefill_only[k][0]) // (new - 1)
                for k in counters}
    assert warm == {k: prefill_only[k][0] + per_step[k] for k in counters}
    steps = dict(graphs._steps)
    for c in counters.values():
        c.reset()
    got = graphs.generate(tokens, new, keep_logits=True)
    assert _read(counters) == eager_counts
    assert graphs.replays == {"prefill": 1, "decode": new - 1}
    assert torch.equal(got.ids, want.ids)
    assert len(got.logits) == new
    for i, (a, b) in enumerate(zip(got.logits, want.logits)):
        assert torch.equal(a, b), f"step {i}"
    again = graphs.generate(tokens, new)
    assert torch.equal(again.ids, want.ids)
    assert graphs._steps == steps
    assert graphs.replays == {"prefill": 2, "decode": 2 * (new - 1)}
    graphs.close()


@pytest.mark.cuda
def test_a_step_that_syncs_inside_capture_raises_with_no_eager_loop(
        card, monkeypatch):
    """A decode step that reads a value on the host (legal eagerly, not in
    a capture) makes the launcher raise; the eager loop never runs."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    real = transformer.decode_step

    def syncing(*args):
        logits, cache = real(*args)
        float(logits.sum())
        return logits, cache

    eager = []
    monkeypatch.setattr(transformer, "decode_step", syncing)
    monkeypatch.setattr(serve, "eager_generate",
                        lambda *a, **kw: eager.append(a))
    with pytest.raises(RuntimeError):
        serve.main(["--smoke", "--batch", "2", "--new-tokens", "4",
                    "--device", "cuda"])
    assert eager == []


@pytest.mark.cuda
def test_capture_with_no_warm_up_on_its_stream_raises_k6s_error(
        card, monkeypatch):
    """Without an eager decode step on the capture stream, K6 has no
    counters for that stream, and it refuses to make them inside the
    capture (their zeros would wait for a replay)."""
    from repro_torch.launch import step_graphs
    model, params, tokens = _smoke_served(card, "qwen1.5-0.5b")
    step_graphs.eager_generate(model, params, tokens, 3)  # kernels loaded
    capture = step_graphs.CudaCapture(torch.device(card))
    dev = torch.device(card).index or 0
    monkeypatch.delitem(decode_ops._COUNTERS,   # a pooled stream may have
                        (dev, capture.stream.cuda_stream),   # a set already
                        raising=False)
    real = step_graphs.ServeGraphs._decode_body

    def captured_only(self):
        if torch.cuda.is_current_stream_capturing():
            real(self)

    monkeypatch.setattr(step_graphs.ServeGraphs, "_decode_body",
                        captured_only)
    with pytest.raises(RuntimeError, match="no counters for this shape on "
                                           "the capture stream"):
        step_graphs.ServeGraphs(model, params, 2, GRAPH_PROMPT,
                                GRAPH_PROMPT + 6, card, capture=capture)


# -- the fan-out's compiled forward (launch/call_graphs.py) -------------------

CALL_ARCHS = ["qwen1.5-0.5b", "mamba2-130m"]


def _call_served(card, arch):
    """A smoke model on the card, its pinned host leaves, and prompts."""
    from repro_torch.launch import serve
    cfg = smoke_config(arch)
    model = build_model(cfg, ExecConfig())
    params = model.init(torch.Generator(device=card).manual_seed(0), card)
    leaves = serve.HostLeaves(serve.host_leaves(params), pin=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
               for _ in range(32)]
    return model, leaves, prompts


def _eager_call(model, leaves, prompt, card):
    from repro_torch.launch import serve
    with torch.no_grad():
        p = serve.bind_params(model.cfg, leaves, torch.device(card))
        logits = model.logits(p, torch.from_numpy(prompt).to(card))[0, -1]
        return int(torch.argmax(logits)), logits


@pytest.mark.cuda
@pytest.mark.parametrize("arch", CALL_ARCHS)
def test_graphed_call_equals_the_eager_call_bitwise(card, arch):
    """A replay of the captured forward gives the eager call's token and
    last-position logits bitwise on the same leaves, at a second length
    too; the kernels count one warm-up per capture and one forward per
    replay."""
    from repro_torch.launch.call_graphs import CallGraphs
    model, leaves, prompts = _call_served(card, arch)
    counters = _kernel_counters()
    graphs = CallGraphs(model, 2, card)
    for prompt in prompts[:4] + [prompts[4][:, :9]]:
        want_tok, want = _eager_call(model, leaves, prompt, card)
        for c in counters.values():
            c.reset()
        got = graphs(leaves, prompt, keep_logits=True)
        assert got.token == want_tok
        assert torch.equal(got.logits, want)
        assert got.h2d_ms > 0 and got.forward_ms > 0
    for c in counters.values():
        c.reset()
    graphs(leaves, prompts[0])                # a replay alone
    assert graphs.captures == 2 and graphs.replays == 6
    per_forward = {k: c.value for k, c in counters.items()}
    warm = {k: graphs.warmup_launches.count(c) for k, c in counters.items()}
    assert warm == {k: 2 * n for k, n in per_forward.items()}
    assert per_forward["flash_attention" if arch == CALL_ARCHS[0]
                       else "ssd_scan"] == model.cfg.n_layers
    graphs.close()


@pytest.mark.cuda
def test_eight_threads_get_every_prompts_eager_token(card):
    import threading
    from repro_torch.launch.call_graphs import CallGraphs
    model, leaves, prompts = _call_served(card, "qwen1.5-0.5b")
    want = [_eager_call(model, leaves, p, card)[0] for p in prompts]
    graphs = CallGraphs(model, 8, card)
    got, errors = [None] * len(prompts), []

    def worker(k):
        try:
            for i in range(k, len(prompts), 8):
                got[i] = graphs(leaves, prompts[i]).token
        except Exception as e:              # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert got == want
    assert graphs.replays == 32 and graphs.captures == graphs.slots <= 8
    graphs.close()


@pytest.mark.cuda
def test_a_capture_runs_while_other_threads_push_through_k1(card):
    """One thread captures a new slot's forward in thread-local mode while
    four others run eager K1 quantisations and sync their streams: the
    capture succeeds and every push agrees with the host codec."""
    import threading
    import time
    from repro_torch.launch.call_graphs import CallGraphs
    model, leaves, prompts = _call_served(card, "qwen1.5-0.5b")
    want = _eager_call(model, leaves, prompts[0], card)[0]
    graphs = CallGraphs(model, 2, card)
    stop, errors, pushes = threading.Event(), [], []
    rng = np.random.default_rng(1)
    eff, base = (rng.normal(size=151_936).astype(np.float32)
                 for _ in range(2))
    q_ref, s_ref = hostcodec.encode_quant(eff, base)[:2]

    def pusher():
        try:
            while not stop.is_set():
                q, s = sp_ops.encode_quant(eff, base, device=card)[:2]
                torch.cuda.current_stream().synchronize()
                assert np.array_equal(q, q_ref) and np.array_equal(s, s_ref)
                pushes.append(1)
        except Exception as e:              # reported below
            errors.append(e)

    threads = [threading.Thread(target=pusher) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 60
        while len(pushes) < 8 and not errors:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        n0 = len(pushes)
        got = graphs(leaves, prompts[0])
        assert len(pushes) > n0             # pushes ran during the capture
    finally:
        stop.set()
        for t in threads:
            t.join(60)
    assert not errors, errors
    assert got.capture_ms > 0 and got.token == want
    graphs.close()


@pytest.mark.cuda
def test_container_rebuilds_free_their_graphs(card):
    """Five container cold starts, each evicting the cached forward: the
    card's allocated bytes after each rebuild stay within one slot's
    parameters of the first (the evicted graphs, buffers and pool are
    freed, and the rebuilt slot captures on its predecessor's stream, so
    cuBLAS keeps no new workspace)."""
    import gc
    from repro_torch.core import FaasmRuntime
    from repro_torch.launch import serve
    from repro_torch.launch.call_graphs import param_bytes
    model, _, prompts = _call_served(card, "qwen1.5-0.5b")
    params = model.init(torch.Generator(device=card).manual_seed(0), card)
    leaves = serve.host_leaves(params)
    del params
    rt = FaasmRuntime(n_hosts=1, capacity=1, isolation="container",
                      device=card)
    try:
        rt.upload(serve.make_infer_function(model, leaves, device=card))
        host = next(iter(rt.hosts.values()))
        allocated = []
        for i in range(6):
            if i:
                host._warm.clear()
                host._container_tiers.clear()
                rt.exec_cache.evict(("serve", "fwd"))
            cid = rt.invoke("infer", prompts[i].tobytes())
            assert rt.wait(cid, timeout=120) == 0, rt.call(cid).error
            gc.collect()
            torch.cuda.synchronize()
            allocated.append(torch.cuda.memory_allocated(card))
        assert rt.exec_cache.stats()["misses"] == 6
        slot = param_bytes(model.cfg)
        assert max(allocated) - allocated[0] < slot, allocated
    finally:
        rt.shutdown()


@pytest.mark.cuda
def test_a_restored_faaslet_copies_from_pinned_leaves(card):
    from repro_torch.core import FaasmRuntime
    from repro_torch.launch import serve
    model, _, prompts = _call_served(card, "mamba2-130m")
    params = model.init(torch.Generator(device=card).manual_seed(0), card)
    leaves = serve.host_leaves(params)
    assert not any(x.is_pinned() for x in leaves.values())
    rt = FaasmRuntime(n_hosts=1, capacity=2, device=card)
    try:
        rt.upload(serve.make_infer_function(model, leaves, device=card))
        cids = rt.invoke_many("infer", [p.tobytes() for p in prompts[:4]])
        assert rt.wait_all(cids, timeout=120) == [0] * 4
        host = next(iter(rt.hosts.values()))
        states = [s for s in host._user_state.values() if s is not None]
        assert states
        for state in states:
            assert state["params"].pin
            assert all(x.is_pinned() for x in state["params"].values())
        template = rt.proto_for("infer", host=host.id).user_state_template()
        assert all(state["params"] is template["params"] for state in states)
    finally:
        rt.shutdown()


# -- training: K5's statistics, FlashAttentionFn, the train step -------------------

STATS_CASES = [c for c in FLASH_CASES if c[2] > 0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", STATS_CASES)
def test_flash_kernel_statistics_on_card(card, case, dtype):
    """Both kernels' row log-sum-exp (the CUDA-core kernel in f32 and at D
    16 and 32, the tensor-core kernel in bf16 at D 64 and 128) against the
    plain version's, at the f32 tolerance (f32 sums of the same products);
    the output is the one the call without statistics gives."""
    B, Sq, Sk, H, K, D, causal, off = case
    rng = np.random.default_rng(1)
    q = _randn(rng, (B, Sq, H, D), dtype, card)
    k, v = (_randn(rng, (B, Sk, K, D), dtype, card) for _ in range(2))
    out, lse = flash_ops._flash_cuda(q, k, v, causal, D ** -0.5, off,
                                     stats=True)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    assert torch.equal(out, flash_attention(q, k, v, causal=causal,
                                            q_offset=off))
    _, want = attention_ref(q, k, v, causal=causal, q_offset=off,
                            return_stats=True)
    torch.testing.assert_close(lse, want, atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_statistics_without_keys(card, dtype):
    q = torch.ones(2, 5, 4, 64, dtype=dtype, device=card)
    kv = torch.ones(2, 0, 4, 64, dtype=dtype, device=card)
    out, lse = flash_ops._flash_cuda(q, kv, kv, False, 0.125, 0, stats=True)
    torch.cuda.synchronize()
    assert int(out.abs().sum()) == 0 and bool((lse == -1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [FLASH_CASES[i] for i in (1, 3, 4, 9, 10)])
def test_flash_attention_fn_gradients_on_card(card, case, dtype):
    """K5 forward, plain flash backward: the gradients against autograd
    through ``attention_ref`` on the same CUDA tensors."""
    B, Sq, Sk, H, K, D, causal, off = case
    rng = np.random.default_rng(2)
    q = _randn(rng, (B, Sq, H, D), dtype, card)
    k, v = (_randn(rng, (B, Sk, K, D), dtype, card) for _ in range(2))
    do = _randn(rng, (B, Sq, H, D), dtype, card)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    n = flash_ops.LAUNCHES.value
    out = flash_attention(*xs, causal=causal, q_offset=off)
    assert out.grad_fn is not None and "FlashAttentionFn" in \
        type(out.grad_fn).__name__
    out.backward(do)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES.value == n + 1
    ys = [t.clone().requires_grad_() for t in (q, k, v)]
    attention_ref(*ys, causal=causal, q_offset=off).backward(do)
    for a, b in zip(xs, ys):
        _close(a.grad, b.grad, dtype)


@pytest.mark.cuda
def test_k7_under_grad_raises(card):
    x = torch.zeros(64, 64, device=card, requires_grad=True)
    w = torch.zeros(2, 64, 64, device=card)
    gs = torch.tensor([32, 32], dtype=torch.int32, device=card)
    with pytest.raises(NotImplementedError, match="no backward"):
        gmm(x, w, gs)
    with torch.no_grad():
        gmm(x, w, gs)                          # no gradient asked: runs


SSD_GRAD_CASES = ["mamba2_prefill", "zamba2_prefill", "mamba2_model_decays",
                  "ragged_700_groups_2_model_decays", "groups_2", "chunk_32",
                  "P8_N8"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SSD_GRAD_CASES)
def test_ssd_scan_fn_gradients_on_card(card, case, dtype):
    """K8 forward under autograd (one launch, through ``SSDScanFn``), the
    plain backward: y and the final state against ``ssd_chunked``, and
    every operand's gradient from one ``backward`` of both outputs against
    autograd through ``ssd_chunked`` on the same CUDA tensors."""
    args = _ssd_inputs(card, case, dtype)
    S = args[0].shape[1]
    chunk = min(256, max(16, 1 << (S - 1).bit_length()))
    rng = np.random.default_rng(3)
    gy = _randn(rng, tuple(args[0].shape), dtype, card)
    gf = _randn(rng, tuple(args[-1].shape), torch.float32, card)
    xs = [t.clone().requires_grad_() for t in args]
    n = ssd_ops.LAUNCHES.value
    y, final = ssd(*xs[:-1], initial_state=xs[-1])
    assert "SSDScanFn" in type(y.grad_fn).__name__
    torch.autograd.backward((y, final), (gy, gf))
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES.value == n + 1
    ys = [t.clone().requires_grad_() for t in args]
    yc, fc = ssd_chunked(*ys, chunk)
    model_decays = SSD_CASES[case][-1] == "model"
    tol = 3e-2 if model_decays or dtype == torch.bfloat16 else 1e-4
    ftol = 3e-2 if model_decays else 1e-4
    torch.testing.assert_close(y.float(), yc.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(final, fc, atol=ftol, rtol=ftol)
    torch.autograd.backward((yc, fc), (gy, gf))
    for name, a, b in zip("x dt A B C D initial_state".split(), xs, ys):
        assert a.grad.dtype == a.dtype, name
        torch.testing.assert_close(a.grad.float(), b.grad.float(), atol=tol,
                                   rtol=tol, msg=name)


@pytest.mark.cuda
def test_k8_launch_failure_in_training_raises(card, monkeypatch):
    """A K8 launch that fails under autograd raises; the plain scan does
    not run in its place."""
    args = _ssd_inputs(card, "chunk_32", torch.float32)
    xs = [t.clone().requires_grad_() for t in args]
    plain = []
    ssd_ops._build.load("ssd_scan")           # built before the fault
    monkeypatch.setattr(ssd_ops._build, "function", lambda *a: lambda *b: 700)
    monkeypatch.setattr(ssd_ops, "ssd_chunked",
                        lambda *a: plain.append(1) or ssd_chunked(*a))
    n = ssd_ops.LAUNCHES.value
    with pytest.raises(RuntimeError, match="CUDA error 700 at launch"):
        ssd(*xs[:-1], initial_state=xs[-1])
    assert ssd_ops.LAUNCHES.value == n and plain == []


def _train_setup(card, dtype, arch="qwen1.5-0.5b"):
    from repro_torch.configs import smoke_shape
    from repro_torch.data import PipelineConfig, make_batch
    from repro_torch.models.weights import trainable
    cfg = smoke_config(arch).with_overrides(dtype=dtype, param_dtype=dtype)
    params = trainable(build_model(cfg).init(
        torch.Generator(device=card).manual_seed(0), card))
    batch = {k: torch.from_numpy(v).to(card) for k, v in make_batch(
        cfg, smoke_shape("train"), PipelineConfig(seed=0), 0).items()}
    return cfg, params, batch


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_train_step_kernel_path_matches_plain_path(card, dtype):
    """One ``make_train_step`` step (SGD) from the same weights: the loss
    and the updated parameters, kernel path against ``backend="torch"``."""
    _train_step_kernel_path_matches_plain_path(card, dtype, "qwen1.5-0.5b")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_ssm_smoke_train_step_kernel_path_matches_plain_path(card, arch,
                                                             dtype):
    """As above for the SSM and hybrid smoke models: K8 through
    ``SSDScanFn`` (and K5 in the hybrid's shared block)."""
    _train_step_kernel_path_matches_plain_path(card, dtype, arch)


def _train_step_kernel_path_matches_plain_path(card, dtype, arch):
    import copy
    from repro_torch.configs import smoke_shape
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import SGD
    cfg, params, batch = _train_setup(card, dtype, arch)
    tol = 1e-4 if dtype == "float32" else 5e-2
    out = {}
    for backend in ("auto", "torch"):
        p = copy.deepcopy(params)
        model = build_model(cfg, ExecConfig(backend=backend, loss_chunk=16))
        opt = SGD(lr=0.05)
        step = make_train_step(model, opt, smoke_shape("train"))
        p, _, metrics = step(p, opt.init(p), batch)
        out[backend] = (float(metrics["loss"]), p)
    assert out["auto"][0] == pytest.approx(out["torch"][0], rel=tol, abs=tol)
    for a, b in zip(out["auto"][1].parameters(), out["torch"][1].parameters()):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("full", 2),
                                             ("dots", 2)])
def test_k5_launches_per_train_step(card, remat, per_layer):
    """K5 once per layer in the forward, once more in the remat recompute
    (``full`` and ``dots``: K5's output is no weight matmul's)."""
    cfg, params, batch = _train_setup(card, "bfloat16")
    model = build_model(cfg, ExecConfig(remat=remat, loss_chunk=16))
    n = flash_ops.LAUNCHES.value
    loss, _ = model.loss(params, batch)
    torch.autograd.grad(loss, list(params.parameters()))
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES.value - n == per_layer * cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("full", 2),
                                             ("dots", 2)])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_k8_launches_per_train_step(card, arch, remat, per_layer):
    """K8 once per Mamba layer in the forward, once more in the remat
    recompute; the hybrid's K5 the same per shared-block application."""
    from repro_torch.models.ssm_stack import n_attn_apps
    cfg, params, batch = _train_setup(card, "bfloat16", arch)
    model = build_model(cfg, ExecConfig(remat=remat, loss_chunk=16))
    n8, n5 = ssd_ops.LAUNCHES.value, flash_ops.LAUNCHES.value
    loss, _ = model.loss(params, batch)
    torch.autograd.grad(loss, list(params.parameters()))
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES.value - n8 == per_layer * cfg.n_layers
    assert flash_ops.LAUNCHES.value - n5 == per_layer * n_attn_apps(cfg)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(card, tmp_path):
    """Parameters and SGD momentum saved from the card restore onto the card
    bitwise, in place, in the reference's layout."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.optim import SGD
    cfg, params, _ = _train_setup(card, "bfloat16")
    opt = SGD(momentum=0.9)
    state = opt.init(params)
    with torch.no_grad():
        for m in state.momentum.parameters():
            m.normal_()
    ck = Checkpointer(str(tmp_path))
    ck.save(5, (params, state), blocking=True)
    fresh = build_model(cfg).init(torch.Generator(device=card).manual_seed(1),
                                  card)
    fstate = opt.init(fresh)
    (got, gstate), step, _ = ck.restore((fresh, fstate))
    assert step == 5 and got is fresh and gstate.step.device.type == "cuda"
    for a, b in zip(got.parameters(), params.parameters()):
        assert a.device.type == "cuda" and torch.equal(a, b)
    for a, b in zip(gstate.momentum.parameters(), state.momentum.parameters()):
        assert torch.equal(a, b)


REPO = Path(__file__).resolve().parents[1]


def _paper_twin(name: str):
    """An example or benchmark twin of the paper's experiments, by module
    name (``examples/`` and the repository root on the path)."""
    for d in (REPO / "examples", REPO):
        if str(d) not in sys.path:
            sys.path.insert(0, str(d))
    return importlib.import_module(name)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["exact", "int8"])
def test_fig6_one_worker_on_the_card_equals_the_cpu(card, wire):
    """The Fig. 6 twin with one worker: the weights trained through the
    card's runtime equal the CPU run's bitwise on both wires (K1 is bitwise
    the host codec), with the same transfer; each int8 push launches K1."""
    from repro_torch.data import make_sparse_dataset
    twin = _paper_twin("sgd_hogwild_torch")
    X, y, _ = make_sparse_dataset(2048, 256, density=0.1, seed=0)
    k1 = sp_ops.LAUNCHES["quantize_delta"].value
    got = twin.run_mode("faaslet", X, y, 1, 2, 2, wire=wire, device="cuda")
    launched = sp_ops.LAUNCHES["quantize_delta"].value - k1
    want = twin.run_mode("faaslet", X, y, 1, 2, 2, wire=wire, device="cpu")
    np.testing.assert_array_equal(got["weights"], want["weights"])
    assert got["transfer_mb"] == want["transfer_mb"]
    assert launched >= (2 if wire == "int8" else 0)


@pytest.mark.cuda
def test_fig9_twin_rows_hold_and_count_their_launches(card):
    """Every kernel row of the Fig. 9 twin runs its kernel on the card,
    held against its plain version inside the twin, and the launches it
    reports are the counters' exactly."""
    micro = _paper_twin("benchmarks.bench_micro_torch")
    counters = {"flash_attention": flash_ops.LAUNCHES,
                "decode_attention": decode_ops.LAUNCHES,
                "ssd_scan": ssd_ops.LAUNCHES, "moe_gmm": gmm_ops.LAUNCHES,
                **{f"state_push.{k}": c for k, c in sp_ops.LAUNCHES.items()}}
    before = {k: c.value for k, c in counters.items()}
    m = micro.main(["--device", "cuda"])
    got = {k: c.value - before[k] for k, c in counters.items()
           if c.value != before[k]}
    assert got == m.launches
    kernels = [r for r in m.rows if "kernel_us" in r]
    assert len(kernels) == 7 and set(got) == {r["counter"] for r in kernels}
    assert all(r["kernel_us"] > 0 and r["plain_us"] > 0 for r in kernels)


# -- the chaos suite's storm and the hybrid's fan-out forward on the card -----


@pytest.mark.cuda
def test_device_tier_int8_storm_launches_k1_once_per_encode(card):
    """``tests/test_chaos.py``'s storm (two pushers, a subscriber and a
    polling puller under ``FaultPlan.random(0)``) with the tiers on the
    card, on the int8 wire at a 4,096-float key, through
    ``chip_smoke.chaos_storm``, which raises unless the global value and
    every replica (the puller's device replica too) land within the int8
    bound of the fault-free sum after a repair pull.  K1 launches exactly
    once per int8 encode the wire spans record, K2 once per int8 frame
    the puller's device replica took, and an injected codec error
    launches none."""
    smoke = _paper_twin("chip_smoke")
    r = smoke.chaos_storm(0, 4096, "int8", device="cuda")
    assert r["launches"]["state_push.quantize_delta"] == \
        r["pushes"] + r["pulls"] > 0
    assert r["launches"]["state_push.apply_delta"] == r["applied"]
    assert r["fallbacks"] == r["fired"].get("codec-error", 0)


@pytest.mark.cuda
def test_hybrid_graphed_call_equals_the_eager_call_bitwise(card):
    """zamba2-1.2b's smoke model in the fan-out's compiled forward at 2
    slots: every replay gives the eager call's token and last-position
    logits bitwise, at a second length too, and one forward launches K8 once per Mamba layer and
    K5 once per application of the shared block, and no K6."""
    from repro_torch.launch.call_graphs import CallGraphs
    from repro_torch.models.ssm_stack import n_attn_apps
    model, leaves, prompts = _call_served(card, "zamba2-1.2b")
    counters = _kernel_counters()
    graphs = CallGraphs(model, 2, card)
    for prompt in prompts[:4] + [prompts[4][:, :9]]:
        want_tok, want = _eager_call(model, leaves, prompt, card)
        for c in counters.values():
            c.reset()
        got = graphs(leaves, prompt, keep_logits=True)
        assert got.token == want_tok
        assert torch.equal(got.logits, want)
    for c in counters.values():
        c.reset()
    graphs(leaves, prompts[0])                # a replay alone
    per_forward = {k: c.value for k, c in counters.items()}
    cfg = model.cfg
    assert per_forward == {"flash_attention": n_attn_apps(cfg),
                           "decode_attention": 0, "moe_gmm": 0,
                           "ssd_scan": cfg.n_layers}
    assert graphs.captures == 2 and graphs.replays == 6
    graphs.close()
