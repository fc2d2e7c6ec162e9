#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all at once);
2. parity: hold each kernel against its plain PyTorch version on the card
   at several shapes, in bf16 and f32 (f32 references with TF32 off); the
   state-push kernels K1-K4 at the serve/stats size and a ragged one, K1
   also against the numpy host codec bitwise, K4 against its plain
   version's e4m3 cast bitwise; K7 (grouped matmul) at the decode, down
   projection and prefill shapes of deepseek-moe-16b, with all rows in one
   expert, with rows past the last group (which must come out zero) and
   with fewer rows than one tile, in bf16 (3e-2) and f32 (1e-4, the
   reference's gmm tolerance);
3. serve: run the launcher's main path, ``repro_torch.launch.serve.main``,
   on qwen1.5-0.5b at full width in bf16 with random weights from a seed
   (batch 4, prompt 512, 32 new tokens), with every launch counter set to
   0 just before and read just after; each kernel must have launched;
4. reference: feed the same prompt and the generated tokens (teacher
   forcing) through the plain path (``backend="torch"``) and compare the
   logits of every step;
5. fan-out: ``serve.main`` with ``--faasm-requests 64 --state-wire int8``:
   every request a Faaslet call of the port's runtime, running the forward
   pass (K5) and pushing the shared serve/stats vector over the int8 wire
   (K1), counters zeroed just before; every request must succeed, K1 launch
   once per push and K5 24 times per forward, the stats equal the token
   histogram within the int8 bound, and the tokens the plain path's argmax
   (one forward per prompt, as the fan-out runs it) in at least 90% of the
   requests; then one call's parameter copy and forward timed alone;
6. device plane: two hosts of the runtime; one pushes from a device
   replica (K1 on device tensors), the other's device replica catches up
   through a delta pull (K2);
7. timing: each kernel's device time per call at the main path's shapes
   (torch.profiler's CUDA trace; back-to-back call time by CUDA events is
   logged beside it) with its plain version's, that of one PyTorch library
   call computing the same function where there is one (a yardstick the
   port never calls) and the card's bound for the work; the state-push
   kernels also at 16 Mi elements, and one host-side encode of numpy
   operands beside the host codec; then the warm prefill and decode loop,
   and one profiled run for the device's busy share;
8. moe serve: the launcher's main path on deepseek-moe-16b at full width
   (16.4 B parameters, bf16, random weights from the seed; batch 4,
   prompt 512, 32 new tokens), counters zeroed just before: the prefill
   takes the GShard einsum dispatch, every decode step the sorted path
   through K7 (3 calls in each of the 27 MoE layers), so K5 launches 28
   times, K6 28 x 31 and K7 27 x 3 x 31; every router call's expert sets
   are recorded;
9. moe reference: the same prompt and generated tokens through the plain
   path, three ways.  bf16 rounds apart on the two paths, so a near-tie
   between the 6th and 7th expert can pick another expert; the token's
   later layers and, through attention, later tokens then drift apart.
   Free-running (the plain router picks its own experts): the share of
   (token, layer) sets routed apart and the argmax agreement are printed.
   Routing forced to the kernel path's experts: the argmax must agree on
   90% of all rows; the logits are printed.  Sublayer by sublayer (every
   attention and FFN call of a kernel-path run repeated on the plain path
   on the same input): every output within the bf16 kernel tolerance;
10. moe timing: K7 at the decode shape (24 rows, one layer's real gate
   weights) and at the sorted-prefill shape (12,288 rows, all 64 experts)
   as in phase 7; then the warm MoE prefill and decode, and one profiled
   decode loop for the device's busy share.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``.  Without a CUDA card, or run
outside the repository, it exits non-zero and prints no result.
``python3 chip_smoke.py parity`` stops after phase 2 and prints no result.
The qwen phases run first; their model is freed before the 32.8 GB MoE
model is drawn on the card.
"""
from __future__ import annotations

import contextlib
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH, BATCH, PROMPT, NEW_TOKENS, SEED = "qwen1.5-0.5b", 4, 512, 32, 0
MOE_ARCH = "deepseek-moe-16b"
TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # the repo's kernel tolerances
GMM_TOL = {"float32": 1e-4, "bfloat16": 3e-2}   # the reference's gmm, bf16
LOGIT_TOL = 5e-2                            # bf16 model tolerance (atol = rtol)
MIN_ARGMAX_AGREEMENT = 0.9                  # bf16 near-ties may flip a few
FANOUT_REQUESTS, FANOUT_WARM = 64, 8       # the wave; the launcher's warm-up
STATS_NUMEL = 151_936                       # serve/stats: the vocabulary
SP_BIG = 16 << 20                           # the state-push timing's 16 Mi
INT8_STEP = 1.01 / 127                      # int8 bound per unit push
# H100 SXM published peaks (NVIDIA H100 datasheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12                    # the main path runs in bf16
FP32_FLOP_PER_S = 67e12                     # f32 outside the tensor cores

FLASH_CASES = [
    # B, Sq, Sk, H, K, D, causal, q_offset
    (4, 512, 512, 16, 16, 64, True, 0),      # the serving prefill
    (2, 100, 300, 8, 2, 64, True, 200),      # GQA G=4, q_offset, ragged tail
    (2, 77, 77, 8, 8, 128, False, 0),        # full attention, D 128
    (1, 64, 200, 8, 1, 128, True, 136),      # MQA
    (2, 33, 50, 4, 4, 32, True, 17),
    (2, 16, 40, 4, 2, 16, False, 0),
    (1, 16, 16, 16, 16, 64, True, 0),        # the fan-out's forward
    (4, 512, 512, 16, 16, 128, True, 0),     # deepseek-moe-16b's prefill
]
DECODE_CASES = [
    # B, S, H, K, D, lengths
    (4, 544, 16, 16, 64, (513, 530, 543, 544)),  # the serving decode
    (4, 544, 16, 16, 128, (513, 530, 543, 544)),  # deepseek-moe-16b's
    (3, 300, 16, 4, 128, (1, 150, 300)),         # GQA G=4, D 128
    (2, 1000, 8, 1, 64, (999, 37)),              # MQA, long cache
    (2, 64, 4, 2, 16, (1, 64)),
    (5, 100, 8, 8, 32, (3, 33, 64, 65, 100)),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Time per call of back-to-back calls, by CUDA events: the device's
    time where it is the bottleneck, the host's launch rate where not."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_events(prof):
    """The profiler's averages of work on the card (kernels, copies)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_ms(fn, iters: int = 20, warmup: int = 5,
              attempts: int = 3) -> float:
    """Device time per call: every kernel ``fn`` launches, summed from
    torch.profiler's CUDA trace — the work's own time, whatever the host's
    launch overhead between calls.  A trace that comes back with no device
    event at all (seen once on the card, for 20 calls of a 2 us kernel,
    where the same phase had traced before) is taken again, up to
    ``attempts`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in device_events(prof))
        if total_us > 0:
            return total_us / iters / 1e3
        log(f"  (trace {attempt + 1} of {attempts} saw no device time)")
    raise RuntimeError("the profiler saw no device time")


def check_close(name: str, got, want, tol: float) -> float:
    """Max |got - want|; raises unless |got - want| <= tol + tol * |want|
    everywhere (the test suite's assert_allclose rule)."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: got {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    d = (got.float() - want.float()).abs()
    err = float(d.max())
    excess = float((d - (tol + tol * want.float().abs())).max())
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g} abs + {tol:g} rel) "
        f"{'ok' if excess <= 0 else 'FAIL'}")
    if excess > 0:
        raise AssertionError(f"{name}: outside tolerance by {excess:.3e}")
    return err


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(_build.KERNELS)
    log(f"build: {', '.join(_build.KERNELS)} built in "
        f"{time.perf_counter() - t0:.1f}s into {_build.BUILD_DIR}")
    for name, text in sorted(_build.BUILD_LOG.items()):
        entry = "?"
        for line in text.splitlines():
            if "entry function" in line:     # mangled: drop the namespace
                entry = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "",
                               line.split("'")[1])
            elif "registers" in line:
                log(f"  ptxas {name}: {entry[:60]}: {line.split(':', 1)[1].strip()}")
            elif "spill" in line and " 0 bytes spill stores" not in line:
                log(f"  ptxas {name}: {entry[:60]}: SPILLS {line.strip()}")


def phase_parity() -> dict:
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"
    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    log("parity: kernels against their plain versions on the card")
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        for (B, Sq, Sk, H, K, D, causal, off) in FLASH_CASES:
            q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dtype)
            k = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dtype)
            v = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dtype)
            got = flash_attention(q, k, v, causal=causal, q_offset=off)
            torch.cuda.synchronize()
            want = attention_ref(q, k, v, causal=causal, q_offset=off)
            torch.cuda.synchronize()
            err = check_close(f"flash {dtype} B{B} Sq{Sq} Sk{Sk} H{H} K{K} "
                              f"D{D} causal={causal} q_offset={off}",
                              got, want, tol)
            if dtype == torch.bfloat16 and (B, Sq, H, D) == (BATCH, PROMPT, 16, 64):
                errs["flash_attention"] = err
        for (B, S, H, K, D, lens) in DECODE_CASES:
            q = torch.randn(B, H, D, generator=g, device=dev).to(dtype)
            k = torch.randn(B, S, K, D, generator=g, device=dev).to(dtype)
            v = torch.randn(B, S, K, D, generator=g, device=dev).to(dtype)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            for b, n in enumerate(lens):         # garbage past the length
                k[b, n:] = 1e4
                v[b, n:] = -1e4
            got = decode_attention(q, k, v, lengths)
            torch.cuda.synchronize()
            want = decode_attention_ref(q, k, v, lengths)
            torch.cuda.synchronize()
            err = check_close(f"decode {dtype} B{B} S{S} H{H} K{K} D{D} "
                              f"lengths={lens}", got, want, tol)
            if dtype == torch.bfloat16 and (B, S, H, D) == (BATCH, PROMPT + NEW_TOKENS, 16, 64):
                errs["decode_attention"] = err
    return errs


def _gmm_sizes(g, kind: str, T: int, E: int = 64):
    """Group sizes on the card: ``draws`` as one decode step's top-6 picks
    (T draws of 64 experts), ``skewed`` over 48 of the 64 experts (the
    others empty), ``one`` all rows in expert 17, ``tail`` three quarters
    of the rows in groups, ``tiny`` 2 + 3 rows."""
    import torch
    if kind == "draws":
        e = torch.randint(0, E, (T,), generator=g, device="cuda")
    elif kind == "skewed":
        active = torch.randperm(E, generator=g, device="cuda")[:48]
        e = active[torch.randint(0, 48, (T,), generator=g, device="cuda")]
    elif kind == "one":
        e = torch.full((T,), 17, device="cuda")
    elif kind == "tail":
        e = torch.randint(0, E, (3 * T // 4,), generator=g, device="cuda")
    else:
        e = torch.tensor([3, 3, 40, 40, 40], device="cuda")
    return torch.bincount(e, minlength=E).to(torch.int32)


GMM_CASES = [
    # name, T, d, f, group sizes
    ("decode gate/up", 24, 2048, 1408, "draws"),
    ("decode down", 24, 1408, 2048, "draws"),
    ("prefill", 12_288, 2048, 1408, "skewed"),
    ("one expert", 300, 2048, 1408, "one"),
    ("rows past the groups", 200, 512, 1408, "tail"),
    ("fewer rows than a tile", 5, 2048, 1408, "tiny"),
]


def phase_parity_gmm() -> dict:
    """K7 against its plain version at deepseek-moe-16b's shapes; weights
    at the model's scale (fan-in^-0.5), so the f32 sums stay near 1."""
    import torch
    from repro_torch.kernels.moe_gmm import gmm, gmm_ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    errs = {}
    log("parity: K7 moe_gmm against its plain version")
    for dtype in (torch.bfloat16, torch.float32):
        tol = GMM_TOL[str(dtype).split(".")[1]]
        for name, T, d, f, kind in GMM_CASES:
            gs = _gmm_sizes(g, kind, T)
            x = torch.randn(T, d, generator=g, device="cuda").to(dtype)
            w = (torch.randn(64, d, f, generator=g, device="cuda")
                 * d ** -0.5).to(dtype)
            # leave NaNs where the output will be allocated: rows the
            # kernel does not write would show
            junk = torch.full((T, f), float("nan"), dtype=dtype, device="cuda")
            del junk
            got = gmm(x, w, gs)
            torch.cuda.synchronize()
            want = gmm_ref(x, w, gs)
            torch.cuda.synchronize()
            err = check_close(f"K7 {dtype} {name}: T{T} d{d} f{f}, "
                              f"{int((gs > 0).sum())} experts, "
                              f"{int(gs.sum())} rows in groups",
                              got, want, tol)
            if dtype == torch.bfloat16 and name == "decode gate/up":
                errs["moe_gmm"] = err
            if dtype == torch.bfloat16 and name == "prefill":
                errs["moe_gmm[prefill]"] = err
    return errs


def launch_counters() -> dict:
    """Every kernel's launch counter, by the name its timing row carries."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.state_push import ops as sp_ops
    return {"flash_attention": flash_ops.LAUNCHES,
            "decode_attention": decode_ops.LAUNCHES,
            "moe_gmm": gmm_ops.LAUNCHES,
            **{f"state_push.{k}": c for k, c in sp_ops.LAUNCHES.items()}}


def reset_launches() -> None:
    for c in launch_counters().values():
        c.reset()


def read_launches() -> dict:
    return {k: c.value for k, c in launch_counters().items()}


def phase_serve() -> tuple:
    import torch
    from repro_torch.launch import serve
    log(f"serve: {ARCH} full width, bf16, batch {BATCH}, prompt {PROMPT}, "
        f"{NEW_TOKENS} new tokens")
    reset_launches()
    res = serve.main(["--arch", ARCH, "--batch", str(BATCH), "--prompt-len",
                      str(PROMPT), "--new-tokens", str(NEW_TOKENS),
                      "--device", "cuda", "--seed", str(SEED)],
                     keep_logits=True)
    launches = read_launches()
    cfg = res["cfg"]
    want = {k: 0 for k in launches}
    want.update({"flash_attention": cfg.n_layers,
                 "decode_attention": cfg.n_layers * (NEW_TOKENS - 1)})
    log(f"  launches {launches} (expected {want})")
    if launches != want:          # a kernel launched no time fails here too
        raise AssertionError(f"launches {launches}, expected {want}")
    gen, logits = res["gen"], res["logits"]
    if tuple(gen.shape) != (BATCH, NEW_TOKENS) or len(logits) != NEW_TOKENS:
        raise AssertionError(f"generated {tuple(gen.shape)}, "
                             f"{len(logits)} logits")
    for i, lg in enumerate(logits):
        if tuple(lg.shape) != (BATCH, cfg.vocab_size) or \
                not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"step {i}: bad logits {tuple(lg.shape)}")
    if not bool(((gen >= 0) & (gen < cfg.vocab_size)).all()):
        raise AssertionError("generated ids out of the vocabulary")
    n_params = sum(p.numel() for p in res["params"].parameters())
    log(f"  {n_params / 1e6:.1f}M parameters; prefill {res['prefill_s'] * 1e3:.2f}ms, "
        f"decode {res['decode_s'] * 1e3:.2f}ms "
        f"(first run: {BATCH * (NEW_TOKENS - 1) / res['decode_s']:.1f} tok/s)")
    return res, launches


def phase_reference(res) -> None:
    import torch
    from repro_torch.models import ExecConfig, build_model
    cfg, params, tokens, gen = res["cfg"], res["params"], res["tokens"], res["gen"]
    ref = build_model(cfg, ExecConfig(backend="torch"))
    cache = ref.init_cache(BATCH, PROMPT + NEW_TOKENS, "cuda")
    with torch.no_grad():
        lg, cache, n = ref.prefill(params, tokens, cache)
        ref_logits = [lg]
        for i in range(NEW_TOKENS - 1):
            idx = torch.full((BATCH,), n + i, dtype=torch.int32, device="cuda")
            lg, cache = ref.decode_step(params, gen[:, i], cache, idx)
            ref_logits.append(lg)
    torch.cuda.synchronize()
    worst, excess, agree = 0.0, -1.0, 0
    for i, (got, want) in enumerate(zip(res["logits"], ref_logits)):
        d = (got - want).abs()
        worst = max(worst, float(d.max()))
        excess = max(excess, float((d - LOGIT_TOL * (1 + want.abs())).max()))
        agree += int((want.argmax(-1) == gen[:, i].long()).sum())
    frac = agree / (BATCH * NEW_TOKENS)
    scale = max(float(w.abs().max()) for w in ref_logits)
    log(f"reference: kernel path vs plain path, teacher-forced over "
        f"{NEW_TOKENS} steps: max |dlogit| {worst:.4f} (max |logit| "
        f"{scale:.3f}, tol {LOGIT_TOL} abs + rel), argmax agreement "
        f"{agree}/{BATCH * NEW_TOKENS} = {frac:.3f}")
    if excess > 0:
        raise AssertionError(f"logits outside tolerance by {excess:.4f}")
    if frac < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"argmax agreement {frac:.3f} < "
                             f"{MIN_ARGMAX_AGREEMENT}")


def phase_timing(res, launches, errs) -> list:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    cfg = res["cfg"]
    B, S, H, K, D = BATCH, PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bf16, dev = torch.bfloat16, "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = []

    # flash: the prefill call of one layer
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(bf16)
    k = torch.randn(B, S, K, D, generator=g, device=dev).to(bf16)
    v = torch.randn(B, S, K, D, generator=g, device=dev).to(bf16)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    flops = 4 * D * B * H * S * (S + 1) // 2            # causal pairs only
    kernel = lambda: flash_attention(q, k, v, causal=True)
    back_to_back = {"flash_attention": call_ms(kernel)}
    rows.append(_row(
        "flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:84", launches, errs,
        device_ms(kernel),
        device_ms(lambda: attention_ref(q, k, v, causal=True), iters=5),
        device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=True)),
        nbytes, flops))

    # decode: the last decode step of one layer (cache of PROMPT+NEW_TOKENS)
    Smax, n = PROMPT + NEW_TOKENS, PROMPT + NEW_TOKENS - 1
    qd = torch.randn(B, H, D, generator=g, device=dev).to(bf16)
    kc = torch.randn(B, Smax, K, D, generator=g, device=dev).to(bf16)
    vc = torch.randn(B, Smax, K, D, generator=g, device=dev).to(bf16)
    lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
    mask = (torch.arange(Smax, device=dev)[None, :] < lengths[:, None])[:, None, None]
    qdt, kct, vct = qd[:, :, None], kc.transpose(1, 2).contiguous(), \
        vc.transpose(1, 2).contiguous()
    nbytes = 2 * (qd.numel() + 2 * B * n * K * D + qd.numel())
    flops = 4 * D * B * H * n
    kernel = lambda: decode_attention(qd, kc, vc, lengths)
    back_to_back["decode_attention"] = call_ms(kernel)
    rows.append(_row(
        "decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:69", launches, errs,
        device_ms(kernel),
        device_ms(lambda: decode_attention_ref(qd, kc, vc, lengths)),
        device_ms(lambda: F.scaled_dot_product_attention(qdt, kct, vct,
                                                         attn_mask=mask)),
        nbytes, flops))
    log("timing (device time per call from the profiler; back-to-back call "
        "time from CUDA events):")
    for r in rows:
        log(f"  {r['name']}: {r['ms'] * 1e3:.1f}us device, "
            f"{back_to_back[r['name']] * 1e3:.1f}us back-to-back, bound "
            f"{r['bound_ms'] * 1e3:.2f}us ({r['bound_by']}), plain "
            f"{r['plain_ms'] * 1e3:.1f}us, library {r['library_ms'] * 1e3:.1f}us")
    return rows

def check_bound(name: str, got, want, bound: float) -> float:
    """Max |got - want|; raises above ``bound`` or on a non-finite value."""
    import torch
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    log(f"  {name}: max_abs_err {err:.3e} (bound {bound:.3e}) "
        f"{'ok' if err <= bound else 'FAIL'}")
    if err > bound:
        raise AssertionError(f"{name}: {err:.3e} above {bound:.3e}")
    return err


def _sp_rows(g, n: int, scale: float = 1.0):
    """Random local/base values of n f32 on the card, and their rows."""
    import torch
    from repro_torch.kernels.state_push import ops as sp
    eff = torch.randn(n, generator=g, device="cuda") * scale
    base = torch.randn(n, generator=g, device="cuda") * scale
    return eff, base, sp._to_rows(eff)[0], sp._to_rows(base)[0]


def phase_parity_state_push() -> dict:
    """K1-K4 against their plain versions at the serve/stats size and at a
    ragged size; K1 against the numpy host codec bitwise (codes, scales,
    residual), K4 against its plain version's e4m3 cast bitwise."""
    import numpy as np
    import torch
    from repro_torch.kernels.state_push import hostcodec
    from repro_torch.kernels.state_push import ops as sp
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    errs = {}
    log("parity: state-push kernels K1-K4 against their plain versions")
    for n in (STATS_NUMEL, 4097):
        eff, base, lr, br = _sp_rows(g, n)
        delta_max = float((eff - base).abs().max())
        for qmax in (127, 7):
            q, s, r = sp.quantize_rows(lr, br, qmax=qmax, with_residual=True)
            torch.cuda.synchronize()
            qh, sh, _, rh = hostcodec.encode_quant(
                eff.cpu().numpy(), base.cpu().numpy(), qmax=qmax)
            bitwise = (np.array_equal(q.cpu().numpy(), qh)
                       and np.array_equal(s.cpu().numpy(), sh)
                       and np.array_equal(r.reshape(-1)[:n].cpu().numpy(), rh))
            log(f"  K1 qmax {qmax} n {n}: codes, scales and residual "
                f"{'equal' if bitwise else 'DIFFER FROM'} the host codec's "
                f"bitwise")
            if not bitwise:
                raise AssertionError("K1 differs from the host codec")
            qp, spl, _ = sp.quantize_rows(lr, br, qmax=qmax, backend="torch")
            err = check_bound(f"K1 quantize_delta qmax {qmax} n {n} vs plain "
                              f"(dequantised)", q.float() * s,
                              qp.float() * spl, delta_max / qmax * 1.01)
            if n == STATS_NUMEL and qmax == 127:
                errs["state_push.quantize_delta"] = err
        lr8 = lr * 1e3                                # past +-448 unscaled
        q8, s8, _ = sp.quantize_rows(lr8, br, fp8=True)
        torch.cuda.synchronize()
        q8p, s8p, _ = sp.quantize_rows(lr8, br, fp8=True, backend="torch")
        bitwise = (torch.equal(q8.view(torch.uint8), q8p.view(torch.uint8))
                   and torch.equal(s8, s8p))
        log(f"  K4 n {n}: codes and scales "
            f"{'equal' if bitwise else 'DIFFER FROM'} the plain version's "
            f"bitwise")
        if not bitwise:
            raise AssertionError("K4 differs from its plain version")
        err = check_bound(f"K4 quantize_fp8 n {n} vs plain (dequantised)",
                          q8.float() * s8, q8p.float() * s8p, 0.0)
        if n == STATS_NUMEL:
            errs["state_push.quantize_fp8"] = err
        g_rows = lr.flip(0).contiguous()
        for codes, scales, kind in ((q, s, "int8"), (q8, s8, "e4m3")):
            out = sp.apply_rows(g_rows, codes, scales)
            torch.cuda.synchronize()
            err = check_close(f"K2 apply_delta {kind} n {n}", out,
                              sp.apply_rows(g_rows, codes, scales,
                                            backend="torch"),
                              TOL["float32"])
            if n == STATS_NUMEL:
                errs["state_push.apply_delta"] = max(
                    errs.get("state_push.apply_delta", 0.0), err)
        out = sp.push_rows(lr, br, g_rows)
        torch.cuda.synchronize()
        err = check_close(f"K3 push n {n}", out,
                          sp.push_rows(lr, br, g_rows, backend="torch"),
                          TOL["float32"])
        if n == STATS_NUMEL:
            errs["state_push.push"] = err
    return errs


def phase_fanout() -> tuple:
    """The launcher's Faasm fan-out at full width: every request a Faaslet
    call of the port's runtime (forward through K5, serve/stats over the
    int8 wire through K1)."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import ExecConfig, build_model
    log(f"fan-out: {ARCH} full width, {FANOUT_REQUESTS} requests of 16 "
        f"tokens, serve/stats on the int8 wire")
    reset_launches()
    res = serve.main(["--arch", ARCH, "--batch", "1", "--prompt-len", "16",
                      "--new-tokens", "2", "--faasm-requests",
                      str(FANOUT_REQUESTS), "--state-wire", "int8",
                      "--device", "cuda", "--seed", str(SEED)])
    torch.cuda.synchronize()
    launches = read_launches()
    cfg, r = res["cfg"], res["faasm"]
    if r["shed"] or r["deadline_expired"] or None in r["tokens"]:
        raise AssertionError(f"fan-out: not every request served: shed "
                             f"{r['shed']}, expired {r['deadline_expired']}")
    calls = FANOUT_REQUESTS + FANOUT_WARM
    # the serve loop's prefill, the forward's warm-up build, every call
    want_flash = cfg.n_layers * (2 + calls)
    log(f"  launches {launches}; expected flash_attention {want_flash} "
        f"({cfg.n_layers} per forward), quantize_delta >= {calls} (one per "
        f"push)")
    if launches["flash_attention"] != want_flash or \
            launches["decode_attention"] != cfg.n_layers or \
            launches["state_push.quantize_delta"] < calls:
        raise AssertionError(f"fan-out launches {launches}")
    tokens = r["tokens"] + r["warm_tokens"]
    hist = np.bincount(tokens, minlength=cfg.vocab_size).astype(np.float32)
    err = float(np.abs(r["stats"] - hist).max())
    bound = calls * INT8_STEP
    log(f"  serve/stats vs the histogram of the {calls} returned tokens: "
        f"max |err| {err:.3e} (int8 bound {bound:.3e})")
    if r["stats"].shape != (cfg.vocab_size,) or err > bound:
        raise AssertionError(f"serve/stats off the token histogram by {err}")
    # the plain path's argmax for each prompt, one (1, 16) forward each as
    # the fan-out runs it (a batched forward would round its GEMMs apart)
    payloads = serve.fanout_payloads(cfg.vocab_size, FANOUT_REQUESTS, 16)
    plain = build_model(cfg, ExecConfig(backend="torch"))
    with torch.no_grad():
        want = [int(plain.logits(res["params"], torch.tensor(
                    np.frombuffer(p, np.int32)[None], device="cuda")
                )[0, -1].argmax()) for p in payloads]
    agree = float(np.mean(np.asarray(want) == np.asarray(r["tokens"])))
    log(f"  tokens vs the plain path's argmax: {agree:.3f} agree")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"fan-out token agreement {agree:.3f}")
    log(f"  {r['throughput_rps']:.2f} req/s, p50 {r['p50_ms']:.1f}ms, "
        f"p99 {r['p99_ms']:.1f}ms; per call {r['infer_ms']:.1f}ms of which "
        f"parameter H2D {r['param_h2d_ms']:.1f}ms "
        f"({100 * r['param_h2d_ms'] / r['infer_ms']:.1f}%); state_push_mb "
        f"{r['state_push_mb']:.3f}")
    # one call's two parts alone, with no other call on the card: what the
    # eight-way concurrency of the wave stretches
    leaves = serve.host_leaves(res["params"])
    nbytes = sum(x.numel() * x.element_size() for x in leaves.values())
    tokens = torch.tensor(np.frombuffer(payloads[0], np.int32)[None],
                          device="cuda")
    for _ in range(2):                       # the second of two, warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = serve.bind_params(cfg, leaves, torch.device("cuda"))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            int(res["model"].logits(p, tokens)[0, -1].argmax())
        t2 = time.perf_counter()
        del p
    log(f"  one call alone: parameter H2D {(t1 - t0) * 1e3:.1f}ms "
        f"({nbytes / 1e9:.3f} GB, {nbytes / (t1 - t0) / 1e9:.2f} GB/s), "
        f"forward + argmax {(t2 - t1) * 1e3:.1f}ms")
    return r, launches


def phase_device_plane() -> dict:
    """Two hosts of the runtime on the card: a call pushes from its device
    replica over the int8 wire (K1 on device tensors); the other host's
    device replica catches up through a delta pull (K2)."""
    import numpy as np
    import torch
    from repro_torch.core import FaasmRuntime, FunctionDef
    log(f"device plane: two hosts, a {STATS_NUMEL}-float key")
    rng = np.random.default_rng(SEED)
    init = rng.normal(size=STATS_NUMEL).astype(np.float32)
    upd = torch.from_numpy(
        (rng.normal(size=STATS_NUMEL) * 0.01).astype(np.float32)).cuda()
    reset_launches()
    rt = FaasmRuntime(n_hosts=2, capacity=2, device="cuda")
    try:
        gt = rt.global_tier
        gt.set("w", init.tobytes(), host="up")
        for h in rt.hosts.values():
            h.local_tier.pull("w")
            h.local_tier.to_device("w")

        def dev_push(api):
            dv = api.state_to_device("w", track_delta=True)
            api.state_update_device("w", dv + upd)
            api.push_state_delta("w", wire="int8")
            return 0

        rt.upload(FunctionDef("dev_push", dev_push))
        cid = rt.invoke("dev_push")
        if rt.wait(cid, timeout=120) != 0:
            raise AssertionError(f"dev_push failed: {rt.call(cid).error}")
        other = next(h for h in rt.hosts.values()
                     if h.id != rt.call(cid).host)
        moved = other.local_tier.pull("w", wire="int8")
        dev = other.local_tier.device_replica("w").value
        torch.cuda.synchronize()
        launches = read_launches()
        host = torch.from_numpy(np.frombuffer(gt.get("w", host="check"),
                                              np.float32).copy())
    finally:
        rt.shutdown()
    bound = float(upd.abs().max()) * INT8_STEP
    log(f"  pull moved {moved} B; launches {launches}")
    if dev.device.type != "cuda" or \
            launches["state_push.apply_delta"] < 1 or \
            launches["state_push.quantize_delta"] < 1:
        raise AssertionError(f"device plane launches {launches}")
    check_bound("device replica vs the global value", dev.cpu(), host, bound)
    check_bound("global value vs init + update", host,
                torch.from_numpy(init) + upd.cpu(), bound)
    return launches


def phase_timing_state_push(launches, errs) -> list:
    """K1-K4 at the serve/stats shape (1,187 x 128 f32) and at 16 Mi
    elements: device time (profiler), plain version, bound; then one
    host-side encode of numpy operands beside the host codec."""
    import numpy as np
    import torch
    from repro_torch.kernels.state_push import hostcodec
    from repro_torch.kernels.state_push import ops as sp
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows, sizes = [], ((STATS_NUMEL, ""), (SP_BIG, "[16Mi]"))
    src = "src/repro_torch/kernels/csrc/state_push.cu"
    ref = "src/repro/kernels/state_push/kernel.py:"
    for n, tag in sizes:
        _, _, lr, br = _sp_rows(g, n)
        R = lr.shape[0]
        gr = lr.flip(0).contiguous()
        q, s, _ = sp.quantize_rows(lr, br)
        q8, s8, _ = sp.quantize_rows(lr, br, fp8=True)
        cases = [
            # name, replaces line, kernel, plain, library, bytes, flops
            ("quantize_delta", 60,
             lambda: sp.quantize_rows(lr, br, with_residual=True),
             lambda: sp.quantize_rows(lr, br, with_residual=True,
                                      backend="torch"),
             None, R * 128 * (4 + 4 + 1 + 4) + R * 4, 9 * R * 128),
            ("quantize_fp8", 78,
             lambda: sp.quantize_rows(lr, br, fp8=True, with_residual=True),
             lambda: sp.quantize_rows(lr, br, fp8=True, with_residual=True,
                                      backend="torch"),
             None, R * 128 * (4 + 4 + 1 + 4) + R * 4, 9 * R * 128),
            ("apply_delta", 96, lambda: sp.apply_rows(gr, q, s),
             lambda: sp.apply_rows(gr, q, s, backend="torch"),
             lambda: torch.addcmul(gr, q, s),
             R * 128 * (4 + 1 + 4) + R * 4, 2 * R * 128),
            ("push", 113, lambda: sp.push_rows(lr, br, gr),
             lambda: sp.push_rows(lr, br, gr, backend="torch"),
             None, R * 128 * 16, 2 * R * 128),
        ]
        step = float((lr - br).abs().max()) * INT8_STEP
        for name, line, kernel, plain, library, nbytes, flops in cases:
            key = f"state_push.{name}"
            if tag:          # the size sweep: held here, run by no path
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                if name.startswith("quantize"):      # dequantised values
                    errs[key + tag] = check_bound(
                        key + tag, got[0].float() * got[1],
                        want[0].float() * want[1],
                        step if name == "quantize_delta" else 0.0)
                else:
                    errs[key + tag] = check_close(key + tag, got, want,
                                                  TOL["float32"])
            rows.append(_row(
                key + tag, src, ref + str(line),
                {key + tag: launches[key] if not tag else 0}, errs,
                device_ms(kernel), device_ms(plain, iters=5),
                device_ms(library) if library is not None else None,
                nbytes, flops, FP32_FLOP_PER_S))
    log("timing, state push (device time per call from the profiler):")
    for r in rows:
        lib = (f"{r['library_ms'] * 1e3:.2f}us" if r["library_ms"] is not None
               else "none")
        log(f"  {r['name']}: {r['ms'] * 1e3:.2f}us device, bound "
            f"{r['bound_ms'] * 1e3:.2f}us ({r['bound_by']}), plain "
            f"{r['plain_ms'] * 1e3:.2f}us, library {lib}, launches "
            f"{r['launches']}")
    for n, iters in ((STATS_NUMEL, 20), (SP_BIG, 3)):
        rng = np.random.default_rng(n)
        eff, base = (rng.normal(size=n).astype(np.float32) for _ in range(2))
        sp.encode_quant(eff, base, device="cuda")            # warm
        t0 = time.perf_counter()
        for _ in range(iters):
            sp.encode_quant(eff, base, device="cuda")
        t_card = (time.perf_counter() - t0) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            hostcodec.encode_quant(eff, base)
        t_host = (time.perf_counter() - t0) / iters
        log(f"  encode_quant of numpy operands, n {n}: on the card "
            f"{t_card * 1e3:.3f}ms per call (H2D + K1 + D2H), host codec "
            f"{t_host * 1e3:.3f}ms")
    return rows


def _row(name, source, replaces, launches, errs, ms, plain_ms, library_ms,
         nbytes, flops, flop_rate=BF16_FLOP_PER_S) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


class RoutingRecorder:
    """Wraps ``repro_torch.models.moe.router_topk`` (looked up by
    ``moe_apply`` at each call) to keep every call's top-k expert ids, in
    slot order, in call order.  With ``force`` (another run's recorded
    ids), each call routes to the forced ids instead, with gates taken
    from its own router probabilities at those ids and renormalised as
    ``router_topk`` does; its own choice is still recorded."""

    def __init__(self, force=None):
        self.calls, self.force = [], force

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._orig = moe.router_topk

        def wrapped(p, cfg, x2d):
            gates, idx, aux = self._orig(p, cfg, x2d)
            self.calls.append(idx)
            if self.force is None:
                return gates, idx, aux
            idx = self.force[len(self.calls) - 1]
            probs = torch.softmax(x2d.float() @ p.router, dim=-1)
            gates = probs.gather(1, idx.long())
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            return gates, idx, aux

        moe.router_topk = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.router_topk = self._orig


def phase_moe_serve() -> tuple:
    import torch
    from repro_torch.launch import serve
    log(f"moe serve: {MOE_ARCH} full width, bf16, batch {BATCH}, prompt "
        f"{PROMPT}, {NEW_TOKENS} new tokens")
    reset_launches()
    with RoutingRecorder() as rec:
        res = serve.main(["--arch", MOE_ARCH, "--batch", str(BATCH),
                          "--prompt-len", str(PROMPT), "--new-tokens",
                          str(NEW_TOKENS), "--device", "cuda", "--seed",
                          str(SEED)], keep_logits=True)
    launches = read_launches()
    cfg = res["cfg"]
    n_moe = cfg.n_layers - cfg.first_k_dense
    want = {k: 0 for k in launches}
    want.update({"flash_attention": cfg.n_layers,
                 "decode_attention": cfg.n_layers * (NEW_TOKENS - 1),
                 "moe_gmm": 3 * n_moe * (NEW_TOKENS - 1)})
    log(f"  launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    gen, logits = res["gen"], res["logits"]
    if tuple(gen.shape) != (BATCH, NEW_TOKENS) or len(logits) != NEW_TOKENS:
        raise AssertionError(f"generated {tuple(gen.shape)}, "
                             f"{len(logits)} logits")
    for i, lg in enumerate(logits):
        if tuple(lg.shape) != (BATCH, cfg.vocab_size) or \
                not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"step {i}: bad logits {tuple(lg.shape)}")
    if not bool(((gen >= 0) & (gen < cfg.vocab_size)).all()):
        raise AssertionError("generated ids out of the vocabulary")
    params = res["params"]
    n_params = sum(p.numel() for p in params.parameters())
    if abs(n_params / 16.4e9 - 1) > 0.03 or \
            params.layers[0].moe.w_gate.dtype != torch.bfloat16:
        raise AssertionError(f"{n_params} parameters, expected 16.4 B bf16")
    log(f"  {n_params / 1e9:.3f}B parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB on the card); "
        f"prefill {res['prefill_s'] * 1e3:.2f}ms, decode "
        f"{res['decode_s'] * 1e3:.2f}ms (first run, routing recorded: "
        f"{BATCH * (NEW_TOKENS - 1) / res['decode_s']:.1f} tok/s)")
    return res, launches, rec.calls


def _moe_run(res, model, force=None) -> tuple:
    """``model``'s prefill and decode on the main-path run's prompt and
    generated tokens (teacher forcing): (logits per step, router calls)."""
    import torch
    params, tokens, gen = res["params"], res["tokens"], res["gen"]
    cache = model.init_cache(BATCH, PROMPT + NEW_TOKENS, "cuda")
    with torch.no_grad(), RoutingRecorder(force) as rec:
        lg, cache, n = model.prefill(params, tokens, cache)
        out = [lg]
        for i in range(NEW_TOKENS - 1):
            idx = torch.full((BATCH,), n + i, dtype=torch.int32, device="cuda")
            lg, cache = model.decode_step(params, gen[:, i], cache, idx)
            out.append(lg)
    torch.cuda.synchronize()
    return out, rec.calls


def _sublayer_run(res) -> dict:
    """The kernel path once more on the main-path run's prompt and tokens,
    with every attention and FFN sublayer call repeated on the plain path
    on the same input (and a copy of the cache it reads): both see the
    same activations, so the router picks the same experts and only the
    kernels' rounding separates them.  Returns {sublayer: (calls, max
    |diff|, largest excess over TOL["bfloat16"] abs + rel)} and the
    run's logits per step."""
    from repro_torch.models import transformer as tr
    tol, stats = TOL["bfloat16"], {}
    orig = {n: getattr(tr, n)
            for n in ("attn_apply_prefill", "attn_apply_decode", "_ffn")}

    def hold(kind, got, want):
        d = (got.float() - want.float()).abs()
        n, err, exc = stats.get(kind, (0, 0.0, -1.0))
        stats[kind] = (n + 1, max(err, float(d.max())), max(exc, float(
            (d - tol * (1 + want.float().abs())).max())))

    def attn(name):
        def wrapped(p, cfg, ec, x, ck, cv, *args, **kw):
            ck0, cv0 = ck.clone(), cv.clone()
            out = orig[name](p, cfg, ec, x, ck, cv, *args, **kw)
            plain = orig[name](p, cfg, ec.with_overrides(backend="torch"), x,
                               ck0, cv0, *args, **kw)
            hold(name, out[0], plain[0])
            return out
        return wrapped

    def ffn(lp, cfg, ec, h):
        out = orig["_ffn"](lp, cfg, ec, h)
        kind = ("moe" if isinstance(lp, tr.MoEBlock) else "dense mlp") + \
            (" decode" if h.shape[1] == 1 else " prefill")
        hold(kind, out[0],
             orig["_ffn"](lp, cfg, ec.with_overrides(backend="torch"), h)[0])
        return out

    tr.attn_apply_prefill = attn("attn_apply_prefill")
    tr.attn_apply_decode = attn("attn_apply_decode")
    tr._ffn = ffn
    try:
        logits, _ = _moe_run(res, res["model"])
    finally:
        for n, fn in orig.items():
            setattr(tr, n, fn)
    return stats, logits


def _flips(a_calls, b_calls, n_moe: int):
    """Per router call, which tokens got another top-k set; and the share
    of (token, layer) sets that differ in each MoE layer of the prefill."""
    import torch
    if len(a_calls) != len(b_calls) or len(a_calls) != n_moe * NEW_TOKENS:
        raise AssertionError(f"{len(a_calls)} and {len(b_calls)} router "
                             f"calls, expected {n_moe * NEW_TOKENS}")
    flips = [(a.sort(-1).values != b.sort(-1).values).any(-1)
             for a, b in zip(a_calls, b_calls)]
    share = sum(int(f.sum()) for f in flips) / sum(f.numel() for f in flips)
    per_layer = [float(f.float().mean()) for f in flips[:n_moe]]
    return flips, share, per_layer


def _any_flip(flips, shape):
    """Any flip over the layers of one step's router calls, as a (BATCH,
    ...) mask."""
    import torch
    return torch.stack(flips).reshape(shape).any(0)


def _held(got_steps, want_steps, gen, rows=None) -> tuple:
    """(max |dlogit| over the held rows, excess over LOGIT_TOL, argmax
    agreement over all rows); ``rows[i]`` picks the held rows of step i."""
    worst, excess, agree = 0.0, -1.0, 0
    for i, (got, want) in enumerate(zip(got_steps, want_steps)):
        ok = slice(None) if rows is None else rows[i]
        d = (got[ok] - want[ok]).abs()
        if d.numel():
            worst = max(worst, float(d.max()))
            excess = max(excess, float(
                (d - LOGIT_TOL * (1 + want[ok].abs())).max()))
        agree += int((want.argmax(-1) == gen[:, i].long()).sum())
    return worst, excess, agree / (BATCH * NEW_TOKENS)


def phase_moe_reference(res, kernel_routes) -> None:
    """The kernel path against the plain path, three ways.

    * Free-running (teacher-forced tokens): the plain router picks its own
      experts.  A near-tie that rounds the other way sends a token to
      another expert, which moves its hidden state by a gate times an
      expert difference; its later layers then route apart too, and
      attention carries the change to every later token.  Reported, not
      held (one bf16 ulp decides it): the share of (token, layer) sets
      routed apart, by layer, the logits of the rows whose own token was
      routed alike in every layer, and the argmax agreement.
    * Routing forced to the kernel path's expert ids (its own gates at
      those ids): no routing flip, but the kernels' rounding still grows
      through 28 layers.  Held: the argmax on MIN_ARGMAX_AGREEMENT of all
      rows; reported: the logits.
    * Sublayer by sublayer: every attention and FFN call of a kernel-path
      run repeated on the plain path on the same input.  Held: every
      output within TOL["bfloat16"] (the kernels' own bf16 tolerance).
    """
    import torch
    from repro_torch.models import ExecConfig, build_model
    cfg, gen = res["cfg"], res["gen"]
    n_moe = cfg.n_layers - cfg.first_k_dense
    total = BATCH * NEW_TOKENS
    plain = build_model(cfg, ExecConfig(backend="torch"))

    free_logits, free_routes = _moe_run(res, plain)
    flips, share, per_layer = _flips(kernel_routes, free_routes, n_moe)
    # the logits row of step 0 is the prefill's last prompt token, of step
    # i + 1 decode step i's token
    own = [_any_flip(flips[:n_moe], (n_moe, BATCH, PROMPT))[:, -1]]
    own += [_any_flip(flips[n_moe * (i + 1):n_moe * (i + 2)], (n_moe, BATCH))
            for i in range(NEW_TOKENS - 1)]
    alike = [~f for f in own]
    n_alike = sum(int(a.sum()) for a in alike)
    worst, excess, free_agree = _held(res["logits"], free_logits, gen, alike)
    log(f"moe reference, free-running: routing differs in {share:.5f} of "
        f"the (token, layer) sets (prefill, by MoE layer: first "
        f"{per_layer[0]:.4f}, middle {per_layer[n_moe // 2]:.4f}, last "
        f"{per_layer[-1]:.4f}); {n_alike} of {total} rows' own token routed "
        f"alike in every layer, their max |dlogit| {worst:.4f} "
        f"({'within' if excess <= 0 else 'outside'} {LOGIT_TOL} abs + rel); "
        f"argmax agreement {free_agree:.3f}")
    del free_logits

    forced_logits, own_routes = _moe_run(res, plain, force=kernel_routes)
    _, ties, _ = _flips(kernel_routes, own_routes, n_moe)
    worst, excess, agree = _held(res["logits"], forced_logits, gen)
    steps = [float((g - w).abs().max())
             for g, w in zip(res["logits"], forced_logits)]
    within = sum(int(((g - w).abs() <= LOGIT_TOL * (1 + w.abs())).all(-1).sum())
                 for g, w in zip(res["logits"], forced_logits))
    log(f"moe reference, routing forced to the kernel path's experts: the "
        f"plain router's own top-{cfg.experts_per_token} differs in "
        f"{ties:.5f} of the sets (near-ties under rounding); max |dlogit| "
        f"{worst:.4f} (prefill row {steps[0]:.4f}, decode rows up to "
        f"{max(steps[1:]):.4f}; max |logit| "
        f"{max(float(w.abs().max()) for w in forced_logits):.3f}); "
        f"{within} of {total} rows within {LOGIT_TOL} abs + rel; argmax "
        f"agreement {agree:.3f}")
    del forced_logits

    stats, rerun = _sublayer_run(res)
    again = max(float((a - b).abs().max()) for a, b in zip(rerun, res["logits"]))
    log(f"moe reference, the kernel path run again on the same tokens: max "
        f"|dlogit| {again:.3e} against the main-path run (0: deterministic); "
        f"sublayer by sublayer (same input on both paths; tol "
        f"{TOL['bfloat16']} abs + rel):")
    for kind, (n, err, exc) in stats.items():
        log(f"  {kind}: {n} calls, max |diff| {err:.3e} "
            f"{'ok' if exc <= 0 else 'FAIL'}")
    bad = [k for k, (_, _, exc) in stats.items() if exc > 0]
    if bad:
        raise AssertionError(f"sublayers outside tolerance: {bad}")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"routing-forced argmax agreement {agree:.3f} "
                             f"< {MIN_ARGMAX_AGREEMENT}")


def _grouped_mm(x, w, gs):
    """One PyTorch call computing K7's function, where this PyTorch has it:
    ``torch.nn.functional.grouped_mm`` with the group ends as offsets."""
    import torch
    import torch.nn.functional as F
    if not hasattr(F, "grouped_mm"):
        return None
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    return lambda: F.grouped_mm(x, w, offs=offs)


def phase_timing_gmm(res, launches, errs) -> list:
    """K7 at the decode shape (one step's 24 rows against layer 0's real
    gate weights) and at the sorted-prefill shape (12,288 rows over all 64
    experts): device time (profiler), plain version, library call, bound."""
    import torch
    from repro_torch.kernels.moe_gmm import gmm, gmm_ref
    cfg = res["cfg"]
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    w = res["params"].layers[0].moe.w_gate
    rows = []
    for tag, T in (("", BATCH * cfg.experts_per_token),
                   ("[prefill]", BATCH * PROMPT * cfg.experts_per_token)):
        gs = _gmm_sizes(g, "draws", T, E)     # at 12,288 rows: all experts
        x = torch.randn(T, d, generator=g, device="cuda").to(torch.bfloat16)
        active = int((gs > 0).sum())
        nbytes = 2 * (active * d * f + T * d + T * f)
        flops = 2 * T * d * f
        kernel = lambda: gmm(x, w, gs)
        library = _grouped_mm(x, w, gs)
        lib_ms = None
        if library is not None:
            try:
                lib_ms = device_ms(library)
            except (RuntimeError, TypeError, ValueError) as exc:  # yardstick
                log(f"  grouped_mm refused these operands: {exc}")
        name = "moe_gmm" + tag
        rows.append(_row(
            name, "src/repro_torch/kernels/csrc/moe_gmm.cu",
            "src/repro/kernels/moe_gmm/kernel.py:37",
            {name: launches["moe_gmm"] if not tag else 0}, errs,
            device_ms(kernel), device_ms(lambda: gmm_ref(x, w, gs), iters=5),
            lib_ms, nbytes, flops))
        log(f"  {name}: T {T}, {active} experts, back-to-back "
            f"{call_ms(kernel) * 1e3:.1f}us")
    log("timing, K7 (device time per call from the profiler):")
    for r in rows:
        lib = (f"{r['library_ms'] * 1e3:.1f}us (grouped_mm)"
               if r["library_ms"] is not None else "none")
        log(f"  {r['name']}: {r['ms'] * 1e3:.1f}us device, bound "
            f"{r['bound_ms'] * 1e3:.1f}us ({r['bound_by']}), plain "
            f"{r['plain_ms'] * 1e3:.1f}us, library {lib}, launches "
            f"{r['launches']}")
    return rows


def _serve_once(model, params, tokens,
                decode_ctx=contextlib.nullcontext) -> tuple:
    """Prefill + greedy decode of the kernel path: (prefill s, decode s);
    ``decode_ctx`` wraps the decode loop (a profiler)."""
    import torch
    with torch.no_grad(), contextlib.ExitStack() as stack:
        cache = model.init_cache(BATCH, PROMPT + NEW_TOKENS, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache, n = model.prefill(params, tokens, cache)
        tok = lg.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        stack.enter_context(decode_ctx())
        t1 = time.perf_counter()
        for i in range(NEW_TOKENS - 1):
            idx = torch.full((BATCH,), n + i, dtype=torch.int32, device="cuda")
            lg, cache = model.decode_step(params, tok, cache, idx)
            tok = lg.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1


def phase_warm_serve(res, decode_only: bool = False) -> None:
    """Warm prefill and decode-loop times of the kernel path on the weights
    and prompt of the main-path run, then one run under torch.profiler for
    the device's busy share and the ops that hold it (with
    ``decode_only``, the profiler covers the decode loop alone)."""
    from torch.profiler import ProfilerActivity, profile
    model, params, tokens = res["model"], res["params"], res["tokens"]
    name = res["cfg"].name
    runs = [_serve_once(model, params, tokens) for _ in range(3)]
    log(f"warm serve {name} (3 runs): prefill ms "
        f"{[r[0] * 1e3 for r in runs]}, decode tok/s "
        f"{[BATCH * (NEW_TOKENS - 1) / r[1] for r in runs]}")
    prof = profile(activities=[ProfilerActivity.CUDA])
    if decode_only:
        wall = _serve_once(model, params, tokens, lambda: prof)[1]
        warm_wall = min(r[1] for r in runs)
        what = f"{NEW_TOKENS - 1} decode steps"
    else:
        with prof:
            wall = sum(_serve_once(model, params, tokens))
        warm_wall = min(sum(r) for r in runs)
        what = f"one prefill + {NEW_TOKENS - 1} decode steps"
    events = device_events(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        raise RuntimeError("the profiler saw no device time")
    log(f"profile {name} ({what}): device busy "
        f"{busy_us / 1e3:.1f}ms in {sum(e.count for e in events)} kernels; "
        f"{busy_us / 1e4 / warm_wall:.1f}% of the fastest unprofiled run's "
        f"{warm_wall * 1e3:.1f}ms wall ({wall * 1e3:.1f}ms under the profiler)")
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        log(f"  {e.self_device_time_total / 1e3:8.2f}ms  {e.count:6d}x  "
            f"{e.key[:90]}")


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run it from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    parity_only = argv == ["parity"]      # a new kernel's first, short run
    t0 = time.perf_counter()
    smi = nvidia_smi()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    phase_build()
    errs = phase_parity()
    errs.update(phase_parity_state_push())
    errs.update(phase_parity_gmm())
    if parity_only:
        return 0
    res, launches = phase_serve()
    phase_reference(res)
    _, fanout_launches = phase_fanout()
    plane_launches = phase_device_plane()
    # each kernel's launches from the run of its path: K5/K6 the serve
    # loop, K1 the fan-out, K2 the device plane; K3 (ops.push) and K4 (the
    # fp8 wire tier, which needs ml_dtypes) are on no runtime path
    launches["state_push.quantize_delta"] = \
        fanout_launches["state_push.quantize_delta"]
    launches["state_push.apply_delta"] = \
        plane_launches["state_push.apply_delta"]
    rows = phase_timing(res, launches, errs)
    rows += phase_timing_state_push(launches, errs)
    phase_warm_serve(res)
    del res                       # the qwen model leaves the card
    gc.collect()
    torch.cuda.empty_cache()
    moe_res, moe_launches, routes = phase_moe_serve()
    phase_moe_reference(moe_res, routes)
    del routes
    rows += phase_timing_gmm(moe_res, moe_launches, errs)
    phase_warm_serve(moe_res, decode_only=True)
    log(f"chip_smoke: {time.perf_counter() - t0:.1f}s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
