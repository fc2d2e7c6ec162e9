"""Paper Fig. 9 analogue on the PyTorch port: kernel and isolation overhead
microbenchmarks.  Twin of ``benchmarks/bench_micro.py``: the same fixed
shapes in f32 and the same rows, named ``fig9_micro_torch/...``.

On the card each kernel row times the hand-written CUDA kernel, its plain
PyTorch version (``backend="torch"``) on the same tensors, their ratio
and, where one PyTorch call computes the same function on the same
operands, that call (SDPA for the attention kernels, ``grouped_mm`` for the grouped
matmul where it takes f32, ``addcmul`` for the int8 apply).  Each output
is held against its plain version at the repo's tolerances (f32 2e-5,
the grouped matmul and the SSD scan 1e-4) and K1's int8 codes and scales
against the numpy host codec bitwise; a shape a kernel refuses raises.
Each time is the device's, by CUDA events around calls queued behind a
kernel that keeps the card asleep until the host has queued them all; the
kernel's back-to-back time (the host's launch pace where that is slower)
is given beside it.  ``--device cpu`` times the plain versions only, and
every row says so.
The last row times a warm no-op invocation through the port's runtime.

Run:  PYTHONPATH=src:. python benchmarks/bench_micro_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.common import emit, time_fn
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.moe_gmm import gmm, gmm_ref
from repro_torch.kernels.ssd_scan import ssd
from repro_torch.kernels.state_push import apply_delta, hostcodec, push
from repro_torch.kernels.state_push import quantize_delta

TOL = 2e-5                  # f32 kernels against their plain versions
GMM_SSD_TOL = 1e-4          # the reference's gmm and ssd tolerances
WARMUP, ITERS = 5, 100      # CUDA-event timing: launches per row


def _held(name: str, got, want, tol: float) -> float:
    """Max |got - want|; raises unless within tol + tol * |want| (the test
    suite's assert_allclose rule) and finite."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}, or non-finite output")
    d = (got - want).abs()
    if bool((d > tol + tol * want.abs()).any()):
        raise AssertionError(f"{name}: {float(d.max()):.3e} outside {tol:g}")
    return float(d.max())


def _cuda_us(fn) -> float:
    """µs per call of ``ITERS`` back-to-back calls, by CUDA events, after
    ``WARMUP`` calls: the device's time where it is the bottleneck, the
    host's launch pace where not."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS * 1e3


def _queued_us(fn, attempts: int = 3) -> tuple:
    """µs per call of ``ITERS`` calls queued behind a kernel that keeps the
    card asleep until the host has queued them all, by CUDA events around
    the calls: the device's time, without the host's.  The card must still
    be asleep when the last call is queued, else the sleep is made longer;
    after ``attempts`` the last back-to-back time is returned.  Returns
    (µs, queued or not)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = 1 << 22
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    per_s = cycles / (start.elapsed_time(end) / 1e3)   # sleep cycles a second
    sleep = int(per_s * (2 * host_s + 1e-3))
    for _ in range(attempts):
        torch.cuda._sleep(sleep)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        asleep = not start.query()
        end.synchronize()
        us = start.elapsed_time(end) / ITERS * 1e3
        if asleep:
            return us, True
        sleep *= 4
    return us, False


def _sdpa(q, k, v, **kw):
    """SDPA on (B, S, heads, D) operands, grouped where K/V have fewer
    heads than q: the function of the attention kernels."""
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    return F.scaled_dot_product_attention(
        q, k, v, enable_gqa=q.shape[1] != k.shape[1], **kw).transpose(1, 2)


def _grouped_mm(x, w, gs):
    """``grouped_mm`` on the same f32 operands, or the reason it cannot
    take them."""
    if not hasattr(F, "grouped_mm"):
        return None, "this PyTorch has no grouped_mm"
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    fn = lambda: F.grouped_mm(x, w, offs=offs)
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, ValueError) as e:
        return None, f"grouped_mm refuses f32 ({str(e).splitlines()[0]})"
    return fn, "grouped_mm"


class Micro:
    """The rows, on one device: each times a kernel call beside its plain
    version and a library call (``library`` None where there is none)."""

    def __init__(self, device: torch.device):
        self.on_card = device.type == "cuda"
        self.rows = []
        self.launches = {}      # kernel launches by LAUNCHES name

    def row(self, name, counter, kernel, plain, tol, library=None,
            lib_name="", note="", held=None):
        if not self.on_card:
            us = time_fn(plain, n=20, warmup=2)
            emit(name, us, f"plain version only (cpu); {note}")
            self.rows.append({"name": name, "device": "cpu", "plain_us": us})
            return
        calls = [0]

        def counted():
            calls[0] += 1
            return kernel()

        got, want = counted(), plain()
        torch.cuda.synchronize()
        err = held(got, want) if held else _held(name, got, want, tol)
        (k_us, queued), (p_us, p_queued) = (_queued_us(counted),
                                            _queued_us(plain))
        lib_us = _queued_us(library)[0] if library is not None else None
        b2b_us = _cuda_us(counted)
        self.launches[counter] = self.launches.get(counter, 0) + calls[0]
        lib = (f"{lib_name} {lib_us:.2f}us" if lib_us is not None
               else lib_name or "no library call")
        how = "queued" if queued else "back to back: the host waited"
        p_how = "" if p_queued else " (back to back: the host waited)"
        emit(name, k_us, f"{k_us / p_us:.2f}x vs plain {p_us:.2f}us{p_how}; "
             f"{lib}; "
             f"device us ({how}), back-to-back {b2b_us:.2f}us; max_abs_err "
             f"{err:.2e}; {note}")
        self.rows.append({"name": name, "device": "cuda", "kernel_us": k_us,
                          "plain_us": p_us, "ratio": k_us / p_us,
                          "library_us": lib_us, "library": lib_name,
                          "back_to_back_us": b2b_us, "queued": queued,
                          "plain_queued": p_queued,
                          "max_abs_err": err, "counter": counter})


def main(argv=None) -> Micro:
    """Emits every row; returns the :class:`Micro` (its rows and, on the
    card, the kernel launches it made by counter)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    def _r(*s):
        return torch.tensor(rng.normal(size=s), dtype=torch.float32,
                            device=device)

    m = Micro(device)

    # flash attention
    q, k, v = _r(2, 256, 8, 64), _r(2, 256, 2, 64), _r(2, 256, 2, 64)
    m.row("fig9_micro_torch/flash_attention", "flash_attention",
          lambda: flash_attention(q, k, v),
          lambda: attention_ref(q, k, v), TOL,
          library=lambda: _sdpa(q, k, v, is_causal=True), lib_name="SDPA",
          note="(2, 256, 8, 64) over K 2, causal")

    # decode attention
    q2, k2, v2 = _r(8, 16, 64), _r(8, 2048, 2, 64), _r(8, 2048, 2, 64)
    lens = torch.full((8,), 2048, dtype=torch.int32, device=device)
    m.row("fig9_micro_torch/decode_attention", "decode_attention",
          lambda: decode_attention(q2, k2, v2, lens),
          lambda: decode_attention_ref(q2, k2, v2, lens), TOL,
          library=lambda: _sdpa(q2[:, None], k2, v2)[:, 0],
          lib_name="SDPA", note="(8, 16, 64) over a 2,048 cache, K 2")

    # SSD scan
    x = _r(2, 256, 8, 32)
    dt = torch.abs(_r(2, 256, 8)) * 0.1 + 0.01
    A = -torch.abs(_r(8)) - 0.5
    B = _r(2, 256, 1, 32)
    C = _r(2, 256, 1, 32)
    D = _r(8)
    m.row("fig9_micro_torch/ssd_chunked", "ssd_scan",
          lambda: ssd(x, dt, A, B, C, D, chunk=64)[0],
          lambda: ssd(x, dt, A, B, C, D, chunk=64, backend="torch")[0],
          GMM_SSD_TOL, note="(2, 256, 8, 32), chunk 64")

    # grouped matmul
    xg = _r(512, 64)
    wg = _r(8, 64, 64)
    gs = torch.full((8,), 64, dtype=torch.int32, device=device)
    lib, lib_name = (_grouped_mm(xg, wg, gs) if m.on_card
                     else (None, "grouped_mm"))
    m.row("fig9_micro_torch/moe_gmm", "moe_gmm",
          lambda: gmm(xg, wg, gs), lambda: gmm_ref(xg, wg, gs), GMM_SSD_TOL,
          library=lib, lib_name=lib_name, note="512 x 64 over 8 experts")

    # fused state push
    a, b, c = _r(1 << 16), _r(1 << 16), _r(1 << 16)
    m.row("fig9_micro_torch/state_push_fused", "state_push.push",
          lambda: push(a, b, c), lambda: push(a, b, c, backend="torch"), TOL,
          note="fused delta+apply, 64k f32")

    # quantised push wire: encode (quantize_delta) + decode-apply (apply_delta)
    def codes_held(got, want):
        qk, sk, _ = got
        qh, sh, _, _ = hostcodec.encode_quant(a.cpu().numpy(),
                                              b.cpu().numpy())
        if not (np.array_equal(qk.cpu().numpy(), qh)
                and np.array_equal(sk.cpu().numpy(), sh)):
            raise AssertionError("fig9_micro_torch/state_push_quantize: "
                                 "K1 differs from the host codec")
        # the plain version rounds apart by at most one step of a row
        step = float((a - b).abs().max()) / 127 * 1.01
        err = float((qk.float() * sk - want[0].float() * want[1]).abs().max())
        if err > step:
            raise AssertionError(f"state_push_quantize: {err:.3e} from the "
                                 f"plain version, above a step {step:.3e}")
        return err

    m.row("fig9_micro_torch/state_push_quantize", "state_push.quantize_delta",
          lambda: quantize_delta(a, b),
          lambda: quantize_delta(a, b, backend="torch"), 0.0,
          note="int8 wire encode, 64k f32 (4x fewer push bytes)",
          held=codes_held)
    qw, sw, _ = quantize_delta(a, b, backend="torch")
    m.row("fig9_micro_torch/state_push_apply_q", "state_push.apply_delta",
          lambda: apply_delta(c, qw, sw),
          lambda: apply_delta(c, qw, sw, backend="torch"), TOL,
          library=lambda: torch.addcmul(c.view(-1, 128), qw, sw),
          lib_name="addcmul", note="int8 wire decode+apply")

    # host interface call overhead (Table 2 surface)
    from repro_torch.core import FaasmRuntime, FunctionDef
    rt = FaasmRuntime(n_hosts=1, device=device)
    try:
        rt.upload(FunctionDef("noop", lambda api: 0))
        rt.wait(rt.invoke("noop"), timeout=10)          # warm

        def one():
            rt.wait(rt.invoke("noop"), timeout=10)
        us = time_fn(one, n=10)
        emit("fig9_micro_torch/host_interface_call", us,
             f"warm no-op invocation ({device.type})")
        m.rows.append({"name": "fig9_micro_torch/host_interface_call",
                       "device": device.type, "host_us": us})
    finally:
        rt.shutdown()
    return m


if __name__ == "__main__":
    main()
