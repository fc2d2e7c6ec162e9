"""The readers of the program's device spans (``train.*_ms``,
``generate.*_ms``): None where the program's registry observed nothing
under their names (a program without the spans), the expected ms from a
registry a test fills, and None from the train readers where a step was
read in part (a span dropped, or counts that disagree)."""
from types import SimpleNamespace

import pytest

from bench import harness
from repro_torch.telemetry import metrics

TRAIN = ("train.forward_ms", "train.backward_ms", "train.flash_bwd_ms",
         "train.update_ms")
GENERATE = ("generate.prefill_ms", "generate.decode_step_ms",
            "generate.host_wait_ms")
CTX = SimpleNamespace(model={}, traffic={}, trace=None, window_s=1.0,
                      flops=0.0, extra={})


@pytest.fixture
def registry(monkeypatch):
    """A registry of the test's own in the process registry's place."""
    reg = metrics.Registry()
    monkeypatch.setattr(metrics, "registry", lambda: reg)
    return reg


def _read(name):
    return harness.reader(name).read(CTX)


@pytest.mark.parametrize("name", TRAIN + GENERATE)
def test_a_reader_gives_none_on_an_empty_registry(registry, name):
    assert _read(name) is None
    registry.histogram("faasm_train_update_ms")     # made, never observed
    registry.histogram("faasm_serve_prefill_ms")
    assert _read(name) is None


def test_the_train_readers_give_ms_a_step(registry):
    """Two steps of two microbatches, ten flash backward calls each."""
    for ms in (300.0, 100.0):
        registry.histogram("faasm_train_update_ms").observe(ms)
    for ms in (100.0, 120.0, 140.0, 160.0):
        registry.histogram("faasm_train_forward_ms").observe(ms)
        registry.histogram("faasm_train_backward_ms").observe(3 * ms)
    for _ in range(20):
        registry.histogram("faasm_train_flash_bwd_ms").observe(38.5)
    assert _read("train.update_ms") == pytest.approx(200.0)
    assert _read("train.forward_ms") == pytest.approx(260.0)
    assert _read("train.backward_ms") == pytest.approx(780.0)
    assert _read("train.flash_bwd_ms") == pytest.approx(385.0)


def test_a_train_reader_without_a_step_gives_none(registry):
    registry.histogram("faasm_train_forward_ms").observe(100.0)
    assert _read("train.forward_ms") is None


def _two_steps(registry):
    for ms in (300.0, 100.0):
        registry.histogram("faasm_train_update_ms").observe(ms)
    for ms in (100.0, 120.0):
        registry.histogram("faasm_train_forward_ms").observe(ms)
        registry.histogram("faasm_train_backward_ms").observe(3 * ms)
        registry.histogram("faasm_train_flash_bwd_ms").observe(38.5)


def test_the_train_readers_give_none_after_a_dropped_span(registry):
    """A replay's late spans dropped (its backward and update) while its
    forward was read: every train reader gives None, not a sum of parts."""
    _two_steps(registry)
    assert _read("train.forward_ms") == pytest.approx(110.0)
    registry.histogram("faasm_train_forward_ms").observe(500.0)
    registry.counter("faasm_telemetry_device_spans_dropped_total").inc(2)
    assert {n: _read(n) for n in TRAIN} == dict.fromkeys(TRAIN)


@pytest.mark.parametrize("extra", ["faasm_train_forward_ms",
                                   "faasm_train_backward_ms",
                                   "faasm_train_flash_bwd_ms"])
def test_the_train_readers_give_none_on_counts_that_disagree(registry,
                                                             extra):
    """One more forward or backward than the other, or a span read a
    number of times no whole number of steps makes: None, even where no
    drop was counted."""
    _two_steps(registry)
    registry.histogram(extra).observe(50.0)
    got = {n: _read(n) for n in TRAIN}
    if extra == "faasm_train_flash_bwd_ms":
        assert got["train.flash_bwd_ms"] is None
        assert got["train.update_ms"] == pytest.approx(200.0)
    else:
        assert got == dict.fromkeys(TRAIN)


def test_the_generate_readers_give_means(registry):
    for ms in (200.0, 220.0):
        registry.histogram("faasm_serve_prefill_ms").observe(ms)
    for ms in (12.0, 14.0, 16.0):
        registry.histogram("faasm_serve_decode_step_ms").observe(ms)
    registry.histogram("faasm_serve_host_wait_ms").observe(5.5)
    assert _read("generate.prefill_ms") == pytest.approx(210.0)
    assert _read("generate.decode_step_ms") == pytest.approx(14.0)
    assert _read("generate.host_wait_ms") == pytest.approx(5.5)


def test_each_reader_reads_its_own_histogram(registry):
    """A histogram of another name moves no reader but its own."""
    registry.histogram("faasm_train_update_ms").observe(10.0)
    registry.histogram("faasm_serve_host_wait_ms").observe(1.0)
    got = {n: _read(n) for n in TRAIN + GENERATE}
    assert got == {**dict.fromkeys(TRAIN + GENERATE), "train.update_ms": 10.0,
                   "generate.host_wait_ms": 1.0}
