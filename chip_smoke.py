#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every CUDA kernel of the serving path from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, all at once);
2. parity: hold each kernel against its plain PyTorch version on the card
   at several shapes, in bf16 and f32 (f32 references with TF32 off);
3. serve: run the launcher's main path, ``repro_torch.launch.serve.main``,
   on qwen1.5-0.5b at full width in bf16 with random weights from a seed
   (batch 4, prompt 512, 32 new tokens), with every launch counter set to
   0 just before and read just after; each kernel must have launched;
4. reference: feed the same prompt and the generated tokens (teacher
   forcing) through the plain path (``backend="torch"``) and compare the
   logits of every step;
5. timing: each kernel's device time per call at the main path's shapes
   (torch.profiler's CUDA trace; back-to-back call time by CUDA events is
   logged beside it) with its plain version's, that of one PyTorch library
   call computing the same function (a yardstick the port never calls)
   and the card's bound for the work; then the warm prefill and decode
   loop, and one profiled run for the device's busy share.

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
# H100 SXM published peaks (NVIDIA H100 datasheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12                    # the main path runs in bf16

FLASH_CASES = [
    # B, Sq, Sk, H, K, D, causal, q_offset
    (4, 512, 512, 16, 16, 64, True, 0),      # the serving prefill
    (2, 100, 300, 8, 2, 64, True, 200),      # GQA G=4, q_offset, ragged tail
    (2, 77, 77, 8, 8, 128, False, 0),        # full attention, D 128
    (1, 64, 200, 8, 1, 128, True, 136),      # MQA
    (2, 33, 50, 4, 4, 32, True, 17),
    (2, 16, 40, 4, 2, 16, False, 0),
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


def phase_serve() -> tuple:
    import torch
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve
    log(f"serve: {ARCH} full width, bf16, batch {BATCH}, prompt {PROMPT}, "
        f"{NEW_TOKENS} new tokens")
    flash_ops.LAUNCHES = 0
    decode_ops.LAUNCHES = 0
    res = serve.main(["--arch", ARCH, "--batch", str(BATCH), "--prompt-len",
                      str(PROMPT), "--new-tokens", str(NEW_TOKENS),
                      "--device", "cuda", "--seed", str(SEED)],
                     keep_logits=True)
    launches = {"flash_attention": flash_ops.LAUNCHES,
                "decode_attention": decode_ops.LAUNCHES}
    cfg = res["cfg"]
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * (NEW_TOKENS - 1)}
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


def _row(name, source, replaces, launches, errs, ms, plain_ms, library_ms,
         nbytes, flops) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
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
    if parity_only:
        return 0
    res, launches = phase_serve()
    phase_reference(res)
    rows = phase_timing(res, launches, errs)
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
