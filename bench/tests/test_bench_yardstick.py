"""The frozen yardstick: kernel counts by hand and against the port's
``ops.py::cost`` at the kernel table's shapes, the model FLOPs, and the
reduction of a trace to busy time, kernel times and idle gaps."""
from types import SimpleNamespace

import pytest

from bench.tests.shapes import source
from bench.yardstick import costs, flops
from bench.yardstick import trace as ytrace


def model(name: str) -> dict:
    return source(name)["model"]


def test_k5_training_forward_bound_at_granite_is_556_us():
    f, b = costs.k5(4, 4096, 4096, 32, 8, 128, True, 2, stats=True)
    assert f == 4 * 128 * 4 * 32 * (4096 * 4097 // 2)
    assert b == 2 * (2 * 4 * 4096 * 32 * 128 + 2 * 4 * 4096 * 8 * 128) \
        + 4 * 4 * 32 * 4096
    assert round(costs.bound_s(f, b) * 1e6, 2) == 556.01


# the kernel table's shapes: K5 at each training forward and prefill, K6
# at each decode, K8 at each Mamba layer's prefill, training and fan-out
K5 = [(4, 4096, 4096, 32, 8, 128, True), (4, 4096, 4096, 16, 16, 64, True),
      (4, 512, 512, 32, 32, 64, True), (1, 16, 16, 32, 32, 64, True),
      (4, 1500, 1500, 6, 6, 64, False), (4, 4096, 1500, 6, 6, 64, False)]
K6 = [(4, 544, 16, 16, 64), (4, 544, 32, 8, 128), (16, 640, 32, 8, 128),
      (1, 18, 32, 32, 64)]
K8 = [(4, 4096, 64, 64, 1, 64, 256), (4, 512, 64, 64, 1, 64, 256),
      (1, 16, 64, 64, 1, 64, 16)]


@pytest.mark.parametrize("shape", K5)
def test_k5_counts_match_the_port(shape):
    from repro_torch.kernels.flash_attention import ops
    for stats in (False, True):
        assert costs.k5(*shape, 2, stats=stats) == ops.cost(*shape, 2,
                                                            stats=stats)


@pytest.mark.parametrize("shape", K6)
def test_k6_counts_match_the_port(shape):
    from repro_torch.kernels.decode_attention import ops
    B, S, H, K, D = shape
    for n in (1, S // 2, S):
        assert costs.k6(B, H, K, D, 2, n) == ops.cost(B, S, H, K, D, 2, n)


@pytest.mark.parametrize("shape", K8)
def test_k8_counts_match_the_port(shape):
    from repro_torch.kernels.ssd_scan import ops
    assert costs.k8(*shape, 2) == ops.cost(*shape, 2)


def test_train_flops_by_hand():
    g = model("granite-3-8b")
    n = 8_170_848_256                        # granite-3-8b's parameters
    attn = 4 * 128 * 32 * 4 * (4096 * 4097 // 2) * 40
    assert flops.train_step(g, 4, 4096) == 6 * n * 4 * 4096 + 3 * attn
    z = model("zamba2-1.2b")
    shared = 2 * 2048 + 4 * 2048 * 2048 + 2 * 2048 * 8192
    weights = 1_088_160_640 + 6 * shared      # 7 applications of the block
    attn = 4 * 64 * 32 * 4 * (4096 * 4097 // 2) * 7
    ssd = 38 * sum(costs.ssd_flop_parts(4, 4096, 64, 64, 1, 64, 256))
    assert flops.train_step(z, 4, 4096) == 6 * weights * 4 * 4096 \
        + 3 * (attn + ssd)


def test_serving_flops_by_hand():
    g = model("granite-3-8b")
    n, vd = 8_170_848_256, 49155 * 4096
    assert flops.prefill(g, 16, 512) == 2 * (n - vd) * 16 * 512 \
        + 2 * vd * 16 + 4 * 128 * 32 * 16 * (512 * 513 // 2) * 40
    assert flops.decode(g, 16, 600) == \
        2 * n * 16 + 4 * 128 * 32 * 16 * 600 * 40


def _ev(name, start, end, device):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_a_trace_reduces_to_busy_time_kernels_and_gaps():
    ev = [_ev(ytrace.WINDOW, 0, 1000, False),
          _ev("bench.step", 0, 600, False),
          _ev("bench.batch", 600, 1000, False),
          _ev("void flash_tc_kernel<128, true>(CUtensorMap)", 100, 300, True),
          _ev("void flash_tc_kernel<128, true>(CUtensorMap)", 250, 400, True),
          _ev("Memcpy HtoD (Pageable -> Device)", 700, 750, True),
          _ev("bench.step", 0, 600, True),        # the span's device shadow
          _ev("void decode_kernel<__nv_bfloat16, 128, 4>(int)", 990, 1200,
              True)]
    t = ytrace.reduce(ev)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx((300 + 50 + 10) * 1e-6)
    assert t.kernels["flash_tc_kernel"] == (pytest.approx(350e-6), 2)
    assert t.kernels["decode_kernel"] == (pytest.approx(10e-6), 1)
    assert t.count(("flash_tc_kernel", "decode_kernel")) == 3
    assert [(g[0], round(g[1] * 1e6)) for g in t.idle_gaps] == [
        ("bench.step", 300), ("bench.batch", 240), ("bench.step", 100)]
    assert sum(g[1] for g in t.idle_gaps) == \
        pytest.approx(t.window_s - t.busy_s)
    assert ytrace.kernel_name("at::native::vectorized_elementwise_kernel<4>") \
        == "vectorized_elementwise_kernel"
    assert ytrace.kernel_name("void (anonymous namespace)::decode_kernel<"
                              "__nv_bfloat16, 128, 4>(int)") == "decode_kernel"


def test_shared_readers_read_nothing_where_nothing_was_measured():
    from bench.yardstick import readers
    t = ytrace.Trace(window_s=2.0, busy_s=1.5, kernels={}, device_ops=[],
                     idle_gaps=[])
    ctx = SimpleNamespace(flops=989e12, window_s=2.0, trace=t)
    assert readers.mfu(ctx) == pytest.approx(50.0)
    assert readers.idle(ctx) == pytest.approx(25.0)
    empty = SimpleNamespace(flops=0, window_s=2.0, trace=ytrace.Trace(
        window_s=2.0, busy_s=0.0, kernels={}, device_ops=[], idle_gaps=[]))
    assert readers.mfu(empty) is None and readers.idle(empty) is None
