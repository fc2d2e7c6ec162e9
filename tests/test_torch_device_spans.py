"""Device spans (``repro_torch.telemetry.device``) and their sites.

On the CPU: disarmed sites take nothing (no range, no event, no ring
write, no histogram); under ``torch.profiler`` an eager train step and the
eager serving loop put their ``faasm.*`` ranges in the profile and time
nothing without the card; a stand-in capture with timing events of its
own (host-clock ones, re-recorded at each replay as a CUDA graph's
event-record nodes are) shows the captured step's spans registered with
the step, read only after armed replays, dropped when a replay rewrote
them unread, and read by a scrape after ``close``; the serving loop's
batch spans and host wait read from a stand-in's events, and no host
wait for a batch without decode steps.

On the card (marker ``cuda``): every armed replay of a captured train
step and of the serving loop is timed, the step's forward, backward and
update add up to the replay's own device time, and generation is bitwise
the same armed as disarmed.  No JAX here.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import smoke_config, smoke_shape
from repro_torch.data import PipelineConfig, make_batch
from repro_torch.launch.step_graphs import ServeGraphs, eager_generate
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train_graphs import GraphedTrainStep
from repro_torch.models import ExecConfig, build_model
from repro_torch.models.weights import trainable
from repro_torch.optim import SGD
from repro_torch.telemetry import device, metrics
from torch_twin_planes import port_planes_disarmed  # noqa: F401

TRAIN = ("train.forward", "train.backward", "train.update")
SERVE = ("serve.prefill", "serve.decode_step", "serve.host_wait")
B, S, NEW = 2, 16, 5


def _counts(names):
    reg = metrics.registry()
    out = {}
    for n in names:
        h = reg.get(device.histogram_name(n))
        out[n] = 0 if h is None else h.count
    return out


def _grown(before, names):
    after = _counts(names)
    return {n: after[n] - before[n] for n in names}


def _dropped():
    c = metrics.registry().get(device.DROPPED)
    return 0 if c is None else c.value


def _train_setup(n_micro=1):
    cfg = smoke_config("qwen1.5-0.5b")
    shape = smoke_shape("train")
    model = build_model(cfg, ExecConfig(loss_chunk=16, microbatches=n_micro))
    opt = SGD(lr=0.05)
    params = trainable(model.init(torch.Generator().manual_seed(0), "cpu"))
    batches = [{k: torch.from_numpy(v) for k, v in make_batch(
        cfg, shape, PipelineConfig(seed=0), i).items()} for i in range(6)]
    return make_train_step(model, opt, shape), opt, params, batches


def _served():
    cfg = smoke_config("qwen1.5-0.5b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32)
    return model, params, tokens


@pytest.fixture(autouse=True)
def read_before():
    """What earlier tests left unread is read before the test counts."""
    device.resolve()


@pytest.fixture
def no_card_events(monkeypatch):
    """Any CUDA event made fails the test."""
    def refuse(*a, **kw):
        raise AssertionError("a CUDA event was made without the card")
    monkeypatch.setattr(torch.cuda, "Event", refuse)


# -- disarmed and profiled sites on the CPU -----------------------------------

def test_disarmed_sites_take_nothing(no_card_events):
    """Disarmed, a site is the shared no-op context, even for the card's
    device; an eager train step and the eager loop make no ring write and
    observe no histogram."""
    assert not telemetry.enabled() and not device.armed()
    for name in TRAIN + ("train.flash_bwd",):
        span = device.device_span(name, torch.device("cuda"))
        assert span is device._OFF
        with span as s:
            assert s.ms is None
    step, opt, params, batches = _train_setup()
    model, sparams, tokens = _served()
    before = _counts(TRAIN + SERVE)
    step(params, opt.init(params), batches[0])
    eager_generate(model, sparams, tokens, NEW)
    assert _grown(before, TRAIN + SERVE) == dict.fromkeys(TRAIN + SERVE, 0)
    tr = telemetry.enable()
    assert tr.writes == 0 and tr.spans() == []


def test_profiled_steps_carry_the_programs_ranges(no_card_events):
    """Under the profiler an eager train step and the eager loop put each
    site's ``faasm.*`` range among the profile's events; without the card
    the spans time nothing."""
    from torch.profiler import ProfilerActivity, profile
    step, opt, params, batches = _train_setup()
    model, sparams, tokens = _served()
    before = _counts(TRAIN + SERVE)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert device.armed()
        step(params, opt.init(params), batches[0])
        eager_generate(model, sparams, tokens, NEW)
    assert not device.armed()
    names = [e.name for e in prof.events()]
    for span in TRAIN + SERVE[:2]:
        assert f"faasm.{span}" in names, span
    assert names.count("faasm.serve.decode_step") == NEW - 1
    assert _grown(before, TRAIN + SERVE) == dict.fromkeys(TRAIN + SERVE, 0)


# -- a stand-in capture with timing events ------------------------------------

class HostEvent:
    """A CUDA timing event on the host clock of its capture: ``record``
    stamps it, ``query`` is its capture's ``done``."""

    def __init__(self, capture):
        self.capture, self.t = capture, None

    def record(self):
        self.t = self.capture.tick
        self.capture.tick += 1.0

    def query(self):
        return self.capture.done

    def elapsed_time(self, end):
        return end.t - self.t

    def synchronize(self):
        pass


class TimedGraph:
    """A replay records its capture's events again, in capture order, as a
    CUDA graph's event-record nodes do (the step's Python does not run)."""

    def __init__(self, capture):
        self.capture = capture

    def replay(self):
        self.capture.replayed += 1
        for e in self.capture.events:
            e.record()

    def reset(self):
        self.capture.resets += 1


class TimedCapture:
    """``CudaCapture`` on the CPU, with the timing events of the spans
    recorded in its capture; ``done`` is whether the device has run them."""

    def __init__(self):
        self.events, self.tick, self.done = [], 0.0, True
        self.replayed = self.resets = 0

    def on_stream(self, after_current=True):
        return contextlib.nullcontext()

    def event(self):
        e = HostEvent(self)
        self.events.append(e)
        return e

    def capture(self, body):
        self.events.clear()
        body()
        return TimedGraph(self)


def test_a_captured_steps_spans_are_read_after_armed_replays_only():
    """The spans recorded in the capture are the step's; a disarmed replay
    leaves them unread, an armed one has them read at the next call (each
    1 ms: one tick between its two events), into the histograms and the
    rings, tagged with the step."""
    step, opt, params, batches = _train_setup()
    cap = TimedCapture()
    graphed = GraphedTrainStep(step, "cpu", capture=cap)
    state = opt.init(params)
    params, state, _ = graphed(params, state, batches[0])     # warm-up
    assert cap.events == []
    before = _counts(TRAIN)
    params, state, _ = graphed(params, state, batches[1])     # capture
    assert [s.name for s in graphed.spans.spans] == list(TRAIN)
    assert len(cap.events) == 2 * len(TRAIN)
    params, state, _ = graphed(params, state, batches[2])     # disarmed
    assert _grown(before, TRAIN) == dict.fromkeys(TRAIN, 0)
    tr = telemetry.enable()
    params, state, _ = graphed(params, state, batches[3])     # armed
    assert _grown(before, TRAIN) == dict.fromkeys(TRAIN, 0)   # not yet read
    params, state, _ = graphed(params, state, batches[4])     # reads it
    telemetry.disable()
    assert _grown(before, TRAIN) == dict.fromkeys(TRAIN, 1)
    h = metrics.registry().get("faasm_train_forward_ms")
    assert h.max == 1.0
    got = [s for s in tr.take() if s.cat == "device"]
    assert [s.name for s in got] == list(TRAIN)
    assert {s.tags["step"] for s in got} == {2}
    assert all(abs(s.dur - 1e-3) < 1e-9 for s in got)
    graphed.close()


def test_an_overwritten_span_is_dropped_and_a_scrape_reads_after_close():
    """An armed replay's spans not done when the next replay comes are
    dropped and counted, never read from the next replay's events; the
    last armed replay's are read by a scrape of the registry after the
    step is closed."""
    step, opt, params, batches = _train_setup()
    cap = TimedCapture()
    graphed = GraphedTrainStep(step, "cpu", capture=cap)
    state = opt.init(params)
    for b in batches[:2]:
        params, state, _ = graphed(params, state, b)
    before, dropped = _counts(TRAIN), _dropped()
    telemetry.enable()
    cap.done = False                       # the device is still running it
    params, state, _ = graphed(params, state, batches[2])
    metrics.registry().snapshot()          # a scrape leaves it unread
    assert _grown(before, TRAIN) == dict.fromkeys(TRAIN, 0)
    params, state, _ = graphed(params, state, batches[3])
    assert _dropped() - dropped == len(TRAIN)
    assert _grown(before, TRAIN) == dict.fromkeys(TRAIN, 0)
    cap.done = True
    telemetry.disable()
    graphed.close()
    assert cap.resets == 1
    metrics.registry().snapshot()
    assert _grown(before, TRAIN) == dict.fromkeys(TRAIN, 1)
    assert _dropped() - dropped == len(TRAIN)


class ServeCapture(TimedCapture):
    """The serving loop's: its timing events are the batch's spans',
    recorded by the loop itself; a replay runs nothing."""

    def capture(self, body):
        body()
        return self

    def replay(self):
        pass

    def reset(self):
        pass


def test_the_serving_loops_batch_spans_read_from_its_events():
    """With timing events, each batch's prefill is read armed or not and
    gives ``Generation``'s times; armed, each decode step and the batch's
    host wait too: the batch's first-to-last time less its replays'."""
    model, params, tokens = _served()
    cap = ServeCapture()
    graphs = ServeGraphs(model, params, B, S, S + NEW, "cpu", capture=cap)
    before = _counts(SERVE)
    run = graphs.generate(tokens, NEW)
    assert _grown(before, SERVE) == {"serve.prefill": 1,
                                     "serve.decode_step": 0,
                                     "serve.host_wait": 0}
    # events in order: first, prefill start and end, last
    assert run.prefill_s == 1e-3 and run.decode_s == 1e-3
    tr = telemetry.enable()
    run = graphs.generate(tokens, NEW)
    assert _grown(before, SERVE) == {"serve.prefill": 2,
                                     "serve.decode_step": NEW - 1,
                                     "serve.host_wait": 1}
    # first, prefill (2), NEW - 1 decode steps (2 each), last: every
    # event one tick after the one before, so the waits are the ticks
    # between spans: first -> prefill, each span -> the next, -> last
    assert run.decode_s == pytest.approx((2 * (NEW - 1) + 1) * 1e-3)
    wait = [s for s in tr.take() if s.name == "serve.host_wait"]
    assert len(wait) == 1 and wait[0].cat == "device"
    assert abs(wait[0].dur - (NEW + 1) * 1e-3) < 1e-9
    assert wait[0].tags["lead_ms"] == 1.0 and wait[0].tags["batch"] == 1
    telemetry.disable()


def test_a_batch_without_decode_steps_publishes_no_host_wait():
    """With one new token there is no decode step: armed or not, the batch
    publishes its prefill alone, and its decode seconds are the copies'
    after it."""
    model, params, tokens = _served()
    cap = ServeCapture()
    graphs = ServeGraphs(model, params, B, S, S + NEW, "cpu", capture=cap)
    before = _counts(SERVE)
    graphs.generate(tokens, 1)
    telemetry.enable()
    run = graphs.generate(tokens, 1)
    telemetry.disable()
    assert run.ids.shape == (B, 1)
    assert _grown(before, SERVE) == {"serve.prefill": 2,
                                     "serve.decode_step": 0,
                                     "serve.host_wait": 0}
    assert run.prefill_s == 1e-3 and run.decode_s == 1e-3


# -- the card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_train(card, n_micro):
    from repro_torch.configs.base import ShapeConfig
    cfg = smoke_config("qwen1.5-0.5b").with_overrides(
        dtype="bfloat16", param_dtype="bfloat16")
    shape = ShapeConfig("spans_train", "train", 256, 4)
    model = build_model(cfg, ExecConfig(loss_chunk=64, microbatches=n_micro))
    opt = SGD(lr=0.05)
    params = trainable(model.init(torch.Generator(device=card).manual_seed(0),
                                  card))
    batches = [{k: torch.from_numpy(v).to(card) for k, v in make_batch(
        cfg, shape, PipelineConfig(seed=0), i).items()} for i in range(7)]
    return cfg, make_train_step(model, opt, shape), opt, params, batches


@pytest.mark.cuda
@pytest.mark.parametrize("n_micro", [1, 2])
def test_captured_step_spans_time_every_armed_replay(card, n_micro):
    """The event nodes captured into the step are read once per armed
    replay (the forward and backward once a microbatch, the plain flash
    backward once a layer and microbatch), never for a disarmed one, none
    dropped when each step is waited for.  With one microbatch, forward,
    backward and update add up to within 3% of the replay's own device
    time, from events around ``graph.replay()``; with two, the gradients'
    accumulation between them lies outside every span, 4.5% of this
    step on an H100, so they add up to within 10%."""
    cfg, step, opt, params, batches = _card_train(card, n_micro)
    names = TRAIN + ("train.flash_bwd",)
    graphed = GraphedTrainStep(step, card)
    state = opt.init(params)
    for b in batches[:3]:                     # warm-up, capture, disarmed
        params, state, _ = graphed(params, state, b)
        torch.cuda.synchronize()
    n_flash = cfg.n_layers * n_micro           # one backward a layer
    before, dropped = _counts(names), _dropped()
    reg = metrics.registry()

    def sums():
        return sum(reg.get(device.histogram_name(n)).sum for n in TRAIN)

    telemetry.enable()
    ratios = []
    for b in batches[3:]:
        s0 = _counts(names)
        params, state, _ = graphed(params, state, b)      # armed
        # one more replay, alone between events on the caller's stream
        graphed._load(b)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        graphed.spans.replaying()                 # reads the call's spans
        s1 = sums()
        start.record()
        graphed.graph.replay()
        end.record()
        graphed.spans.replayed(0.0)
        torch.cuda.synchronize()
        reg.snapshot()                            # reads this replay's
        ratios.append((sums() - s1) / start.elapsed_time(end))
        assert _grown(s0, names) == {
            "train.forward": 2 * n_micro, "train.backward": 2 * n_micro,
            "train.update": 2, "train.flash_bwd": 2 * n_flash}
    telemetry.disable()
    assert _dropped() == dropped
    low = 0.97 if n_micro == 1 else 0.9
    assert all(low <= r <= 1.001 for r in ratios), ratios
    assert _grown(before, names)["train.update"] == 2 * len(batches[3:])
    graphed.close()


def _card_served(card):
    cfg = smoke_config("qwen1.5-0.5b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(0), card)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32, device=card)
    return model, params, tokens


@pytest.mark.cuda
def test_serving_spans_time_every_armed_replay(card):
    """Each batch's prefill is timed armed or not; armed, every decode
    replay and the batch's host wait too, which with the replays' spans
    makes up the batch's first-to-last device time."""
    model, params, tokens = _card_served(card)
    graphs = ServeGraphs(model, params, B, S, S + NEW, card)
    before = _counts(SERVE)
    run = graphs.generate(tokens, NEW)
    assert run.prefill_s > 0 and run.decode_s > 0
    assert _grown(before, SERVE) == {"serve.prefill": 1,
                                     "serve.decode_step": 0,
                                     "serve.host_wait": 0}
    telemetry.enable()
    for _ in range(3):
        graphs.generate(tokens, NEW)
    telemetry.disable()
    assert _grown(before, SERVE) == {"serve.prefill": 4,
                                     "serve.decode_step": 3 * (NEW - 1),
                                     "serve.host_wait": 3}
    assert metrics.registry().get("faasm_serve_host_wait_ms").min >= 0
    graphs.close()


@pytest.mark.cuda
def test_generation_is_bitwise_the_same_armed_and_disarmed(card):
    """Ids and kept logits of the graphed loop, with no sync after the
    prefill, are bitwise the same disarmed, armed by the tracer and armed
    by the profiler, and the eager loop's."""
    from torch.profiler import ProfilerActivity, profile
    model, params, tokens = _card_served(card)
    graphs = ServeGraphs(model, params, B, S, S + NEW, card)
    runs = [graphs.generate(tokens, NEW, keep_logits=True)]
    telemetry.enable()
    runs.append(graphs.generate(tokens, NEW, keep_logits=True))
    telemetry.disable()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        runs.append(graphs.generate(tokens, NEW, keep_logits=True))
    runs.append(eager_generate(model, params, tokens, NEW, keep_logits=True))
    for run in runs[1:]:
        assert torch.equal(run.ids, runs[0].ids)
        for a, b in zip(run.logits, runs[0].logits):
            assert torch.equal(a, b)
    graphs.close()
