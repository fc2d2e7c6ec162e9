"""The port's state-push package (kernels K1–K4 and the host codec) against
the JAX package's.

On the CPU the port's wrappers take their plain PyTorch versions (torch
tensors) or the copied numpy host codec (numpy operands with
``device="cpu"``); they are held against ``repro``'s device paths on
``backend="xla"`` and ``backend="pallas_interpret"`` with the same numpy
inputs, at odd sizes (a ragged last row), with the bounds of
``tests/test_kernels.py`` and ``tests/test_codec_tiers.py``:

* scales may differ by one ULP (XLA compiles ``absmax/qmax`` to a
  reciprocal-multiply; the port divides, as the host codec does), and a code
  may then move by one step; where the scales are equal the codes are too;
* fp8 codes may land one e4m3 step apart at ties, so fp8 is bounded in
  step units;
* f32 applies and pushes agree to 1e-6; bf16 values to one bf16 step.

Host-codec wire frames are byte-identical across the two packages, and a
frame encoded by either decodes in the other.  The CUDA kernels are held
against the plain versions on the card by ``test_torch_cuda.py``.
"""
import sys
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.state_push import ops as jops
from repro.state import wire as jwire
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.state_push import hostcodec as thost
from repro_torch.kernels.state_push import ops as tops
from repro_torch.state import wire as twire

BACKENDS = ("xla", "pallas_interpret")
SIZES = (1, 130, 1000, 4097)
OPERANDS = ("tensor", "numpy")        # port: CPU tensors | numpy, device cpu


def _pair(n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=n) * scale).astype(np.float32),
            (rng.normal(size=n) * scale).astype(np.float32))


def _port(x, operands):
    return torch.from_numpy(x.copy()) if operands == "tensor" else x


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ulps(a, b) -> int:
    """Largest distance in ULPs between two positive f32 arrays."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _check_int_codes(qp, sp, qj, sj, qmax):
    """Scales within one ULP; codes equal where the scales are, else one
    step apart at most."""
    qp, qj = np.asarray(qp, np.int32), np.asarray(qj, np.int32)
    sp, sj = np.asarray(sp), np.asarray(sj)
    assert qp.shape == qj.shape and sp.shape == sj.shape
    assert _ulps(sp, sj) <= 1
    same = (sp == sj)[:, 0]
    np.testing.assert_array_equal(qp[same], qj[same])
    assert np.abs(qp - qj).max() <= 1
    assert np.abs(qp).max() <= qmax


# -- encodes -------------------------------------------------------------------


@pytest.mark.parametrize("operands", OPERANDS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("backend", BACKENDS)
def test_encode_quant_matches_jax(backend, qmax, n, operands):
    eff, base = _pair(n, seed=qmax + n)
    qj, sj, nj, rj = jops.encode_quant(jnp.asarray(eff), jnp.asarray(base),
                                       qmax=qmax, backend=backend)
    qp, sp, npn, rp = tops.encode_quant(_port(eff, operands),
                                        _port(base, operands), qmax=qmax,
                                        device="cpu")
    assert npn == nj == n and type(qp) is np.ndarray and qp.dtype == np.int8
    _check_int_codes(qp, sp, qj, sj, qmax)
    # the residual is the operands' kind: debt stays where the value is
    assert isinstance(rp, torch.Tensor) == (operands == "tensor")
    delta = eff - base
    deq = thost.decode_rows(qp, sp, n)
    np.testing.assert_allclose(deq + _np(rp), delta, atol=1e-6)
    step = np.abs(delta).max() / qmax
    assert np.abs(_np(rp) - np.asarray(rj)).max() <= step + 1e-6
    assert np.all(qp.reshape(-1)[n:] == 0)             # ragged tail: zero


@pytest.mark.parametrize("operands", OPERANDS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_encode_fp8_matches_jax(backend, n, operands):
    eff, base = _pair(n, seed=n, scale=1e3)      # beyond ±448 before scaling
    qj, sj, _, rj = jops.encode_fp8(jnp.asarray(eff), jnp.asarray(base),
                                    backend=backend)
    qp, sp, npn, rp = tops.encode_fp8(_port(eff, operands),
                                      _port(base, operands), device="cpu")
    assert npn == n and qp.dtype == ml_dtypes.float8_e4m3fn
    assert _ulps(sp, sj) <= 1
    deq_p = thost.decode_rows(qp, sp, n)
    deq_j = thost.decode_rows(np.asarray(qj).astype(np.float32),
                              np.asarray(sj), n)
    assert not np.isnan(deq_p).any()
    delta = eff - base
    # one fp8 step of the largest magnitude (test_codec_tiers' bound)
    assert np.abs(deq_p - deq_j).max() <= np.abs(delta).max() / 4.0 + 1e-6
    np.testing.assert_allclose(deq_p + _np(rp), delta,
                               atol=np.abs(delta).max() * 1e-6)
    assert np.all(qp.reshape(-1)[n:].astype(np.float32) == 0)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_quantize_delta_encode_pull_dequantize_match_jax(backend, n):
    local, base = _pair(n, seed=2 * n)
    for jfn, tfn in ((jops.quantize_delta, tops.quantize_delta),
                     (jops.encode_pull, tops.encode_pull)):
        qj, sj, nj = jfn(jnp.asarray(local), jnp.asarray(base),
                         backend=backend)
        qt, st, nt = tfn(torch.from_numpy(local), torch.from_numpy(base))
        assert nt == nj == n and isinstance(qt, torch.Tensor)
        _check_int_codes(qt.numpy(), st.numpy(), qj, sj, 127)
        deq_j = np.asarray(jops.dequantize(qj, sj, nj))
        deq_t = tops.dequantize(qt, st, nt)
        assert deq_t.shape == (n,)
        step = np.abs(local - base).max() / 127
        assert np.abs(deq_t.numpy() - deq_j).max() <= step + 1e-6
        # numpy operands on the CPU: the host codec, numpy out
        qh, sh, _ = tfn(local, base, device="cpu")
        assert type(qh) is np.ndarray
        _check_int_codes(qh, sh, qj, sj, 127)
        np.testing.assert_array_equal(tops.dequantize(qh, sh, n),
                                      thost.decode_rows(qh, sh, n))
    assert tops.wire_nbytes(qt, st) == jops.wire_nbytes(qj, sj)
    assert tops.wire_nbytes(qh, sh) == qh.nbytes + sh.nbytes


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close_value(got: torch.Tensor, want, dtype: str):
    assert got.dtype == DTYPES[dtype][1]
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)
    else:                         # both round the f32 result: one bf16 step
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=2 ** -7)


@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("n", [130, 4097])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_apply_delta_and_apply_pull_match_jax(backend, dtype, n, wire):
    eff, base = _pair(n, seed=n + 1)
    value = np.random.default_rng(n).normal(size=n).astype(np.float32)
    enc = thost.encode_fp8 if wire == "fp8" else thost.encode_quant
    q, s, _, _ = enc(eff, base)
    jdt, tdt = DTYPES[dtype]
    jv, tv = jnp.asarray(value, jdt), torch.from_numpy(value).to(tdt)
    jq = q if wire == "int8" else jnp.asarray(q)
    for jfn, tfn in ((jops.apply_delta, tops.apply_delta),
                     (jops.apply_pull, tops.apply_pull)):
        want = jfn(jv, jq, jnp.asarray(s), backend=backend)
        before = tv.clone()
        got = tfn(tv, q, s)
        assert torch.equal(tv, before)                 # never in place
        assert got.shape == (n,)
        _close_value(got, want, dtype)


@pytest.mark.parametrize("n", [130, 4097])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_push_matches_jax(backend, dtype, n):
    local, base = _pair(n, seed=3 * n)
    gv = np.random.default_rng(7).normal(size=(n,)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want = jops.push(jnp.asarray(local), jnp.asarray(base),
                     jnp.asarray(gv, jdt), backend=backend)
    g = torch.from_numpy(gv).to(tdt)
    got = tops.push(torch.from_numpy(local), torch.from_numpy(base), g)
    _close_value(got, want, dtype)
    # numpy operands on the CPU: the plain version, numpy out
    out = tops.push(local, base, gv, device="cpu")
    assert type(out) is np.ndarray
    np.testing.assert_allclose(out, np.asarray(
        jops.push(jnp.asarray(local), jnp.asarray(base), jnp.asarray(gv),
                  backend=backend)), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", [(100,), (13, 7), (5, 5, 5)])
def test_any_shape_roundtrips(shape):
    """test_kernels.py's round trip, through the port: shapes survive and
    the int8 error stays inside absmax/127·1.01."""
    rng = np.random.default_rng(0)
    local, base, gv = (torch.from_numpy(
        rng.normal(size=shape).astype(np.float32)) for _ in range(3))
    q, s, n = tops.quantize_delta(local, base)
    newg = tops.apply_delta(gv, q, s)
    exact = gv + (local - base)
    bound = float((local - base).abs().max()) / 127 * 1.01 + 1e-8
    assert newg.shape == shape
    assert float((newg - exact).abs().max()) <= bound
    torch.testing.assert_close(tops.push(local, base, gv), exact, atol=1e-6,
                               rtol=0)


def test_numpy_routing_on_the_cpu():
    """Numpy operands on device cpu take the host codec (bitwise); forced
    onto the plain version (backend="torch") they agree bitwise too, codes,
    scales and residual — the division rule of ``ref.py``."""
    eff, base = _pair(4097, seed=5)
    want = thost.encode_quant(eff, base, qmax=127)
    for kw in ({}, {"backend": "torch"}):
        got = tops.encode_quant(eff, base, device="cpu", **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    q, s, n, r = tops.encode_quant(eff, None, device="cpu", backend="torch")
    np.testing.assert_array_equal(q, thost.encode_quant(eff, None)[0])
    assert tops.encode_quant(eff, base, device="cpu",
                             with_residual=False)[3] is None


# -- host codec: byte-identical frames, decodable across packages --------------


@pytest.mark.parametrize("n", [130, 4097, 40000])
@pytest.mark.parametrize("wire", ["exact", "int8", "int4", "fp8"])
def test_host_codec_frames_are_byte_identical(wire, n):
    eff, base = _pair(n, seed=17)
    fj, rj = jwire.get_codec(wire).encode(eff, base, backend="xla")
    fp, rp = twire.get_codec(wire).encode(eff, base, device="cpu")
    assert (fp.wire, fp.numel, fp.nbytes) == (fj.wire, fj.numel, fj.nbytes)
    assert fp.payload.dtype == fj.payload.dtype
    assert fp.payload.tobytes() == fj.payload.tobytes()
    if wire == "exact":
        assert fp.scales is None and rp is None and rj is None
    else:
        assert fp.scales.tobytes() == fj.scales.tobytes()
        np.testing.assert_array_equal(rp, rj)
    fdj = jwire.get_codec(wire).encode_delta(eff - base, backend="xla")
    fdp = twire.get_codec(wire).encode_delta(eff - base, device="cpu")
    assert fdp.payload.tobytes() == fdj.payload.tobytes()


@pytest.mark.parametrize("wire", ["exact", "int8", "int4", "fp8"])
def test_frames_decode_across_packages(wire):
    eff, base = _pair(1000, seed=19)
    value = np.random.default_rng(3).normal(size=1000).astype(np.float32)
    for src, dst, kw in ((twire, jwire, {"device": "cpu"}),
                         (jwire, twire, {"backend": "xla"})):
        frame, _ = src.get_codec(wire).encode(eff, base, **kw)
        other = dst.WireFrame(wire=frame.wire, numel=frame.numel,
                              payload=frame.payload, scales=frame.scales)
        np.testing.assert_array_equal(other.decode(), frame.decode())
        if wire != "exact":
            q, s = frame.codes()
            want = np.asarray(jops.apply_pull(jnp.asarray(value),
                                              jnp.asarray(q), s,
                                              backend="xla"))
            got = tops.apply_pull(torch.from_numpy(value), q, s)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_fp8_tier_follows_ml_dtypes_in_both_packages():
    assert ("fp8" in twire.available_wires()) == thost.fp8_available()
    assert twire.available_wires() == jwire.available_wires()


# -- the wrappers' argument checks and launch counters --------------------------


def _bad_state_push_calls():
    rows = torch.zeros(3, 128)
    q8 = torch.zeros(3, 128, dtype=torch.int8)
    s = torch.ones(3, 1)
    return {   # case: (expected message, call)
        "quant_lanes": ("rows must be", lambda: tops._quantize_cuda(
            torch.zeros(3, 64), None, 127.0, False, True)),
        "quant_dtype": ("float32", lambda: tops._quantize_cuda(
            rows.double(), None, 127.0, False, True)),
        "quant_base": ("alike", lambda: tops._quantize_cuda(
            rows, torch.zeros(4, 128), 127.0, False, True)),
        "apply_codes": ("dtypes", lambda: tops._apply_cuda(
            rows, q8.to(torch.int16), s)),
        "apply_scales": ("scales", lambda: tops._apply_cuda(
            rows, q8, torch.ones(2, 1))),
        "push_strides": ("contiguous", lambda: tops._push_cuda(
            rows, rows, torch.zeros(128, 3).t())),
    }


@pytest.mark.parametrize("case", list(_bad_state_push_calls()))
def test_state_push_wrappers_refuse_before_launch(case):
    message, call = _bad_state_push_calls()[case]
    before = {k: c.value for k, c in tops.LAUNCHES.items()}
    with pytest.raises(ValueError, match=message):
        call()
    assert {k: c.value for k, c in tops.LAUNCHES.items()} == before


COUNTERS = {"flash_attention": flash_ops.LAUNCHES,
            "decode_attention": decode_ops.LAUNCHES,
            **{f"state_push.{k}": c for k, c in tops.LAUNCHES.items()}}


@pytest.mark.parametrize("name", list(COUNTERS))
def test_launch_counter_is_exact_under_threads(name):
    """Eight executor threads counting at once lose no launch (a bare
    ``n += 1`` does, with a short switch interval)."""
    counter, per = COUNTERS[name], 20000
    start = counter.value
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [counter.add()
                                               for _ in range(per)])
              for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert counter.value == start + 8 * per
