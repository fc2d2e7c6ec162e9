"""The narrow wire tiers (int4 and fp8), the host-native fused codec and
the encode paths of ``tests/test_codec_tiers.py`` through the port.

The reference file's host-codec, int4 and fp8 cases, its parity matrix
and its wire codecs end to end, with the same names and parametrised
cases, run through ``repro_torch.kernels.state_push`` and the port's
``state/wire.py`` and state tiers on ``device="cpu"``.  Its cost-model
cases are twinned in ``tests/test_torch_wire_fabric.py`` and are not
repeated here.  The reference's ``xla`` and ``pallas_interpret``
backends are the port's ``auto`` and ``torch``, as there: a device value
is a CPU tensor, which both take to the kernels' plain PyTorch versions,
and numpy operands on ``auto`` with ``device="cpu"`` take the copied host
codec.  Each twin asserts what its reference test asserts, with its
bounds (scales may differ by one ULP between the host codec and the
device path; fp8 ties may land one e4m3 step apart).

One twin diverges, recorded in ROADMAP queue 3 "Differences kept":
``test_device_chunked_encode_matches_single_shot``.  The port has no
pipelined chunk path; its twin holds the one-pass encode at the
reference's chunked size against the plain quantiser bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.state_push import hostcodec
from repro_torch.kernels.state_push import ops
from repro_torch.state.kv import GlobalTier as _GlobalTier
from repro_torch.state.local import LocalTier
from repro_torch.state.wire import available_wires, get_codec
from torch_twin_planes import port_planes_disarmed  # noqa: F401

REFERENCE_CHUNK_ROWS = 4096   # repro.kernels.state_push.ops.DEVICE_CHUNK_ROWS


def GlobalTier(*args, **kwargs):
    """The port's global tier with its codec on the CPU."""
    return _GlobalTier(*args, device="cpu", **kwargs)


def _dev(x: np.ndarray) -> torch.Tensor:
    """A device value: the reference's ``jnp.asarray``, a CPU tensor here."""
    return torch.from_numpy(np.array(x))


BACKENDS = ("auto", "torch")
ODD_SIZES = (1, 5, 130, 1000, 4097)

needs_fp8 = pytest.mark.skipif(not hostcodec.fp8_available(),
                               reason="ml_dtypes not installed")


def _np(x):
    """Host numpy of a wire buffer or residual (numpy or a tensor)."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _pair(n, seed=0, scale=1.0):
    rng = _rng(seed)
    eff = (rng.normal(size=n) * scale).astype(np.float32)
    base = (rng.normal(size=n) * scale).astype(np.float32)
    return eff, base


# -- host codec: conservation, pad no-op, odd sizes, chunk invariance ---------


@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("n", ODD_SIZES)
def test_hostcodec_residual_conserves_delta(qmax, n):
    """deq + residual == delta exactly — error feedback loses nothing."""
    eff, base = _pair(n, seed=n)
    q, s, numel, resid = hostcodec.encode_quant(eff, base, qmax=qmax)
    assert numel == n and resid.shape == (n,)
    deq = hostcodec.decode_rows(q, s, n)
    np.testing.assert_allclose(deq + resid, eff - base, atol=1e-6)
    assert np.abs(q.astype(np.int32)).max() <= qmax


@pytest.mark.parametrize("qmax", [127, 7])
def test_hostcodec_pad_region_is_zero(qmax):
    n = 130                                   # 2 rows, 126 pad lanes
    eff, base = _pair(n, seed=3)
    q, s, numel, _ = hostcodec.encode_quant(eff, base, qmax=qmax)
    assert q.shape == (2, 128) and numel == n
    assert np.all(q.reshape(-1)[n:] == 0)


@pytest.mark.parametrize("chunk_rows", [1, 3, 7, 1024])
def test_hostcodec_chunked_matches_unchunked_bitwise(chunk_rows):
    """Chunks split on row boundaries and scales are per-row, so any chunk
    size yields bit-identical wire buffers."""
    n = 9 * 128 + 17
    eff, base = _pair(n, seed=9)
    q1, s1, _, r1 = hostcodec.encode_quant(eff, base, qmax=127, chunk_rows=chunk_rows)
    q2, s2, _, r2 = hostcodec.encode_quant(eff, base, qmax=127)
    assert np.array_equal(q1, q2)
    assert np.array_equal(s1, s2)
    assert np.array_equal(r1, r2)


def test_hostcodec_none_base_is_zero_base():
    eff, _ = _pair(1000, seed=4)
    q1, s1, _, r1 = hostcodec.encode_quant(eff, None)
    q2, s2, _, r2 = hostcodec.encode_quant(eff, np.zeros_like(eff))
    assert np.array_equal(q1, q2) and np.array_equal(s1, s2)
    assert np.array_equal(r1, r2)


def test_hostcodec_exact_matches_subtract():
    eff, base = _pair(4097, seed=5)
    out = hostcodec.encode_exact(eff, base, chunk_rows=2)
    np.testing.assert_array_equal(out, eff - base)


# -- int4 nibble packing ------------------------------------------------------


def test_int4_pack_roundtrips_full_code_range():
    q = np.tile(np.arange(-7, 8, dtype=np.int8), (3, 128))[:, :128]
    packed = hostcodec.pack_int4(q)
    assert packed.shape == (3, 64) and packed.dtype == np.uint8
    assert np.array_equal(hostcodec.unpack_int4(packed), q)


def test_int4_frame_halves_payload():
    eff, base = _pair(256 << 8, seed=6)
    f8 = get_codec("int8").encode(eff, base, backend="auto", device="cpu")[0]
    f4 = get_codec("int4").encode(eff, base, backend="auto", device="cpu")[0]
    assert f4.payload.nbytes * 2 == f8.payload.nbytes


# -- fp8 tier -----------------------------------------------------------------


@needs_fp8
@pytest.mark.parametrize("n", ODD_SIZES)
def test_hostcodec_fp8_conserves_and_never_nans(n):
    # huge dynamic range: without the pre-cast clip these overflow to NaN
    eff, base = _pair(n, seed=n, scale=1e4)
    q, s, numel, resid = hostcodec.encode_fp8(eff, base)
    deq = hostcodec.decode_rows(q, s, numel)
    assert not np.isnan(deq).any()
    np.testing.assert_allclose(deq + resid, eff - base, atol=1e-6)
    # e4m3 relative step is 2^-3: per-element error ≤ |delta|/8 + eps
    delta = eff - base
    assert np.abs(deq - delta).max() <= np.abs(delta).max() / 8.0 + 1e-6


@needs_fp8
def test_fp8_codec_registered_only_when_available():
    assert "fp8" in available_wires()
    assert get_codec("fp8").name == "fp8"


# -- xla / pallas_interpret parity matrix -------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("n", [130, 1000])
def test_quant_parity_host_vs_device(backend, qmax, n):
    """The device encode and the host fast path agree to quantisation
    precision (scales may differ by one ULP — see module docstring)."""
    eff, base = _pair(n, seed=qmax + n)
    qh, sh, _, _ = hostcodec.encode_quant(eff, base, qmax=qmax)
    qd, sd, numel, _ = ops.encode_quant(_dev(eff), _dev(base),
                                        qmax=qmax, backend=backend)
    assert numel == n
    deq_h = hostcodec.decode_rows(qh, sh, n)
    deq_d = hostcodec.decode_rows(_np(qd), _np(sd), n)
    step = np.abs(eff - base).max() / qmax
    assert np.abs(deq_h - deq_d).max() <= step + 1e-6


@needs_fp8
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [130, 1000])
def test_fp8_parity_host_vs_device(backend, n):
    """fp8 ties at half-step boundaries can land a full e4m3 step apart
    across backends — the bound is in fp8-step units, deliberately loose."""
    eff, base = _pair(n, seed=n)
    qh, sh, _, _ = hostcodec.encode_fp8(eff, base)
    qd, sd, numel, _ = ops.encode_fp8(_dev(eff), _dev(base),
                                      backend=backend)
    assert numel == n
    deq_h = hostcodec.decode_rows(qh, sh, n)
    deq_d = hostcodec.decode_rows(_np(qd).astype(np.float32),
                                  _np(sd), n)
    assert not np.isnan(deq_d).any()
    # one fp8 step of the largest magnitude in the row set
    bound = np.abs(eff - base).max() / 4.0 + 1e-6
    assert np.abs(deq_h - deq_d).max() <= bound


@pytest.mark.parametrize("backend", BACKENDS)
def test_residual_conservation_device_paths(backend):
    """Fused device encode's residual also conserves: deq + resid == delta
    to f32 rounding."""
    eff, base = _pair(1000, seed=11)
    q, s, n, resid = ops.encode_quant(_dev(eff), _dev(base),
                                      qmax=127, backend=backend)
    deq = hostcodec.decode_rows(_np(q), _np(s), n)
    np.testing.assert_allclose(deq + _np(resid), eff - base, atol=1e-5)


def test_device_chunked_encode_matches_single_shot():
    """Values past the reference's ``DEVICE_CHUNK_ROWS`` rows (4,096) take
    its pipelined chunk path there.  The port has none (a difference kept,
    ROADMAP queue 3): its device encode is one kernel call, or one pass of
    the plain version, over all the rows at any size.  So the twin holds
    the encode at that size against a single-shot call of the plain
    quantiser on the same rows, bitwise, and that ``ops`` has no chunk
    size to split at."""
    n = (REFERENCE_CHUNK_ROWS + 100) * 128 + 7
    eff, base = _pair(n, seed=12, scale=0.1)
    je, jb = _dev(eff), _dev(base)
    q, s, numel, resid = ops.encode_quant(je, jb, qmax=127)
    assert numel == n
    lr, _ = ops._to_rows(je)
    br, _ = ops._to_rows(jb)
    qs, ss, rs = ops.quantize_rows(lr, br, qmax=127.0, with_residual=True,
                                   backend="torch")
    assert np.array_equal(q, qs.numpy())
    assert np.array_equal(s, ss.numpy())
    np.testing.assert_array_equal(resid.numpy(),
                                  rs.numpy().reshape(-1)[:n])
    assert not hasattr(ops, "DEVICE_CHUNK_ROWS")


def test_host_fast_path_skips_jax_dispatch():
    """numpy operands on the auto backend (on the CPU) return numpy wire
    buffers computed by the host codec — bitwise equal to calling
    hostcodec directly."""
    eff, base = _pair(130, seed=13)
    q, s, n, resid = ops.encode_quant(eff, base, qmax=127, backend="auto",
                                      device="cpu")
    qh, sh, _, rh = hostcodec.encode_quant(eff, base, qmax=127)
    assert type(q) is np.ndarray
    assert np.array_equal(q, qh) and np.array_equal(s, sh)
    assert np.array_equal(resid, rh)


# -- wire codecs end to end ---------------------------------------------------


@pytest.mark.parametrize("wire", ["int4", "fp8"])
def test_narrow_tier_push_converges_with_error_feedback(wire):
    """A narrow-tier push stream converges on the global value: per-push
    quantisation error is carried by the residual, not lost."""
    if wire == "fp8" and not hostcodec.fp8_available():
        pytest.skip("ml_dtypes not installed")
    n = 256 << 8                              # 256 KB
    gt = GlobalTier()
    gt.set("w", np.zeros(n, np.float32).tobytes(), host="up")
    lt = LocalTier("h0", gt)
    lt.set_wire_tiers(wire)
    lt.pull("w")
    lt.snapshot_base("w")
    LocalTier("q", gt).pull("w")              # wire interest: frame it
    rng = _rng(17)
    view = lt.replica("w").buf.view(np.float32)
    total = np.zeros(n, np.float32)
    for _ in range(6):
        u = (rng.normal(size=n) * 0.01).astype(np.float32)
        view[:] += u
        total += u
        lt.push_delta("w", wire=wire)
    got = np.frombuffer(gt.get("w", host="check"), np.float32)
    # after the final push one residual remains un-pushed: bounded by one
    # quantisation step of the last encode's per-row absmax (~N(0, 0.01)
    # updates plus carried residual → well under one update magnitude)
    assert np.abs(got - total).max() <= 0.01
    assert np.abs(got - total).mean() <= 2e-3


def test_int4_wire_frame_decodes_through_frame_api():
    eff, base = _pair(130, seed=19)
    frame, resid = get_codec("int4").encode(eff, base, backend="auto",
                                            device="cpu")
    assert frame.wire == "int4" and frame.payload.dtype == np.uint8
    deq = frame.decode()
    np.testing.assert_allclose(deq + resid, eff - base, atol=1e-6)
    q, s = frame.codes()
    assert q.dtype == np.int8 and np.abs(q.astype(np.int32)).max() <= 7
