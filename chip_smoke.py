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
   version's e4m3 cast bitwise;
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
   and one profiled run for the device's busy share.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``.  Without a CUDA card, or run
outside the repository, it exits non-zero and prints no result.
``python3 chip_smoke.py parity`` stops after phase 2 and prints no result.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH, BATCH, PROMPT, NEW_TOKENS, SEED = "qwen1.5-0.5b", 4, 512, 32, 0
TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # the repo's kernel tolerances
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
]
DECODE_CASES = [
    # B, S, H, K, D, lengths
    (4, 544, 16, 16, 64, (513, 530, 543, 544)),  # the serving decode
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


def device_ms(fn, iters: int = 20, warmup: int = 5) -> float:
    """Device time per call: every kernel ``fn`` launches, summed from
    torch.profiler's CUDA trace — the work's own time, whatever the host's
    launch overhead between calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in device_events(prof))
    if total_us <= 0:
        raise RuntimeError("the profiler saw no device time")
    return total_us / iters / 1e3


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


def launch_counters() -> dict:
    """Every kernel's launch counter, by the name its timing row carries."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.state_push import ops as sp_ops
    return {"flash_attention": flash_ops.LAUNCHES,
            "decode_attention": decode_ops.LAUNCHES,
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


def _serve_once(model, params, tokens) -> tuple:
    """Prefill + greedy decode of the kernel path: (prefill s, decode s)."""
    import torch
    with torch.no_grad():
        cache = model.init_cache(BATCH, PROMPT + NEW_TOKENS, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache, n = model.prefill(params, tokens, cache)
        tok = lg.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(NEW_TOKENS - 1):
            idx = torch.full((BATCH,), n + i, dtype=torch.int32, device="cuda")
            lg, cache = model.decode_step(params, tok, cache, idx)
            tok = lg.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1


def phase_warm_serve(res) -> None:
    """Warm prefill and decode-loop times of the kernel path on the weights
    and prompt of the main-path run, then one run under torch.profiler for
    the device's busy share and the ops that hold it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    model, params, tokens = res["model"], res["params"], res["tokens"]
    runs = [_serve_once(model, params, tokens) for _ in range(3)]
    log(f"warm serve (3 runs): prefill ms {[r[0] * 1e3 for r in runs]}, "
        f"decode tok/s {[BATCH * (NEW_TOKENS - 1) / r[1] for r in runs]}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = sum(_serve_once(model, params, tokens))
    events = device_events(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        raise RuntimeError("the profiler saw no device time")
    warm_wall = min(sum(r) for r in runs)
    log(f"profile (one prefill + {NEW_TOKENS - 1} decode steps): device busy "
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
    log(f"chip_smoke: {time.perf_counter() - t0:.1f}s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
