"""The fan-out's compiled forward (``repro_torch.launch.call_graphs``) and
the pinned host leaves (``launch/serve.py::HostLeaves``) on the CPU, where
there are no CUDA graphs and no pinned memory.

A stand-in capture takes ``CudaCapture``'s place, one per slot: its
capture runs the forward's Python once, as a capture does, each replay
runs it again (or nothing), and its timing events read the host clock.
That holds what :class:`CallGraphs` does around the graphs (a slot per
call, a capture per new prompt length and slot, launch accounting, one
cancellation checkpoint per replay, freeing on close) against the eager
forward; the card tests in ``tests/test_torch_cuda.py`` hold the real
graphs bitwise against it.  ``serve.pinned_empty`` is monkeypatched
where a test asks for pinning.  ``serve.main --device cpu`` runs the eager forward
and touches no graph API.  The Fig. 7 twin and its benchmark run on the
CPU.  No JAX here.
"""
import contextlib
import pickle
import re
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import cancellation
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import ExecutableCache, Faaslet, ProtoFaaslet
from repro_torch.kernels.common import LaunchCounter
from repro_torch.launch import serve
from repro_torch.launch.call_graphs import CallGraphs, param_bytes
from repro_torch.models import build_model
from torch_host_events import HostStamp

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "examples"))
sys.path.insert(0, str(REPO))

ARCHS = ["qwen1.5-0.5b", "mamba2-130m"]
S = 16


class StandInGraph:
    def __init__(self, body, capture):
        self.body, self.capture = body, capture

    def replay(self):
        cap = self.capture
        cap.log.append("replay")
        if cap.active:
            cap.overlaps += 1
        cap.active = True
        try:
            if cap.hold is not None:
                cap.hold.wait(10)
            if cap.replay_error is not None:
                raise cap.replay_error
            if cap.run_on_replay:
                self.body()
        finally:
            cap.active = False

    def reset(self):
        self.capture.resets += 1
        self.body = None


class StandInCapture:
    """``CudaCapture`` on the CPU, one per slot."""

    def __init__(self, run_on_replay=True, hold=None, capture_error=None,
                 replay_error=None):
        self.run_on_replay, self.hold = run_on_replay, hold
        self.capture_error, self.replay_error = capture_error, replay_error
        self.log, self.captured = [], 0
        self.active, self.overlaps, self.resets = False, 0, 0

    def on_stream(self, after_current=True):
        return contextlib.nullcontext()

    def capture(self, body):
        self.captured += 1
        if self.capture_error is not None:
            raise self.capture_error
        body()
        return StandInGraph(body, self)

    def event(self):
        return HostStamp()


def _factory(made, **kw):
    def make(index):
        assert 0 <= index < 8
        cap = StandInCapture(**kw)
        made.append(cap)
        return cap
    return make


class Spy:
    """A model whose forward counts its runs and one launch of ``counter``
    each (the eager warm-up counts it, a capture records it)."""

    def __init__(self, model, counter=None):
        self.cfg, self._model, self.counter = model.cfg, model, counter
        self.runs = 0

    def logits(self, params, tokens):
        self.runs += 1
        if self.counter is not None:
            self.counter.add()
        return self._model.logits(params, tokens)


def _served(arch, seed=0):
    cfg = smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    return model, serve.host_leaves(params)


def _prompts(cfg, n, length=S, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (1, length)).astype(np.int32)
            for _ in range(n)]


def _eager(model, leaves, prompt):
    with torch.no_grad():
        p = serve.bind_params(model.cfg, leaves, torch.device("cpu"))
        return model.logits(p, torch.from_numpy(prompt))[0, -1]


@pytest.mark.parametrize("arch", ARCHS)
def test_a_call_gives_the_eager_forwards_token_and_logits(arch):
    model, leaves = _served(arch)
    made = []
    graphs = CallGraphs(model, 2, "cpu", capture_factory=_factory(made))
    for prompt in _prompts(model.cfg, 3) + _prompts(model.cfg, 2, 7):
        want = _eager(model, leaves, prompt)
        got = graphs(leaves, prompt, keep_logits=True)
        assert got.token == int(torch.argmax(want))
        assert torch.equal(got.logits, want)
        assert got.h2d_ms >= 0 and got.forward_ms >= 0
    assert graphs.replays == 5 and graphs.slots == 1
    assert graphs.captures == 2 and made[0].captured == 2
    graphs.close()
    assert graphs.slots == 0 and made[0].resets == 2


def test_no_slot_serves_two_calls_at_once():
    model, leaves = _served("qwen1.5-0.5b")
    prompts = _prompts(model.cfg, 32)
    want = [int(torch.argmax(_eager(model, leaves, p))) for p in prompts]
    made = []
    graphs = CallGraphs(model, 4, "cpu", capture_factory=_factory(made))
    got, errors = [None] * len(prompts), []

    def worker(k):
        try:
            for i in range(k, len(prompts), 8):
                got[i] = graphs(leaves, prompts[i]).token
        except Exception as e:            # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert got == want
    assert 1 <= len(made) <= 4 and graphs.slots == len(made)
    assert sum(c.overlaps for c in made) == 0
    assert sum(c.log.count("replay") for c in made) == len(prompts)
    assert graphs.captures == len(made) and graphs.replays == len(prompts)
    graphs.close()


def test_each_replay_is_one_launch_log_replay_and_one_checkpoint(monkeypatch):
    model, leaves = _served("mamba2-130m")
    counter = LaunchCounter()
    spy = Spy(model, counter)
    made = []
    graphs = CallGraphs(spy, 1, "cpu",
                        capture_factory=_factory(made, run_on_replay=False))
    prompts = _prompts(model.cfg, 4)
    graphs(leaves, prompts[0])
    # the warm-up's launch is counted, the capture's recorded: one each
    assert graphs.warmup_launches.count(counter) == 1
    assert counter.value == 1 + 1              # the warm-up, one replay
    log = made[0].log
    log.clear()
    monkeypatch.setattr(cancellation, "checkpoint",
                        lambda: log.append("checkpoint"))
    for p in prompts[1:]:
        graphs(leaves, p)
    assert log == ["checkpoint", "replay"] * 3
    assert counter.value == 1 + 4 and spy.runs == 2
    assert graphs.replays == 4 and graphs.captures == 1


def test_a_new_prompt_length_captures_once_per_slot_and_never_runs_eager():
    model, leaves = _served("qwen1.5-0.5b")
    spy = Spy(model)
    made = []
    graphs = CallGraphs(spy, 1, "cpu",
                        capture_factory=_factory(made, run_on_replay=False))
    lengths = [16, 16, 8, 16, 8, 8, 24]
    for n in lengths:
        graphs(leaves, _prompts(model.cfg, 1, n)[0])
    # each length: one eager warm-up and one capture, then replays only
    assert graphs.captures == 3 and made[0].captured == 3
    assert spy.runs == 2 * 3
    assert graphs.replays == len(lengths) and made[0].log.count("replay") == 7
    with pytest.raises(ValueError, match=r"one \(1, S\)"):
        graphs(leaves, np.zeros((2, 16), np.int32))


def test_close_frees_a_busy_slot_only_after_its_call_returns():
    model, leaves = _served("qwen1.5-0.5b")
    hold = threading.Event()
    caps = []

    def make(index):                # the first slot's replay waits for hold
        cap = StandInCapture(hold=None if caps else hold)
        cap.index = index
        caps.append(cap)
        return cap

    graphs = CallGraphs(model, 2, "cpu", capture_factory=make)
    prompts = _prompts(model.cfg, 2)
    done = []
    busy = threading.Thread(target=lambda: done.append(
        graphs(leaves, prompts[0]).token))
    busy.start()
    deadline = time.monotonic() + 30
    while not caps or not caps[0].active:
        assert time.monotonic() < deadline
        time.sleep(0.001)
    graphs(leaves, prompts[1])                 # a second slot, now idle
    assert graphs.slots == 2
    graphs.close()
    assert caps[1].resets == 1                 # the idle slot: at once
    assert caps[0].resets == 0 and graphs.slots == 1
    hold.set()
    busy.join(30)
    assert not busy.is_alive() and len(done) == 1
    assert caps[0].resets == 1 and graphs.slots == 0
    graphs(leaves, prompts[1])                 # a late call still runs
    assert graphs.slots == 0 and len(caps) == 3 and caps[2].resets == 1
    # a slot index freed is taken again: its stream on the card
    assert [c.index for c in caps] == [0, 1, 0]


@pytest.mark.parametrize("where", ["capture", "replay"])
def test_a_failed_capture_or_replay_fails_the_call_and_drops_the_slot(where):
    model, leaves = _served("qwen1.5-0.5b")
    spy = Spy(model)
    made = []
    err = RuntimeError(f"{where} failed")
    graphs = CallGraphs(spy, 1, "cpu", capture_factory=_factory(
        made, **{f"{where}_error": err}))
    with pytest.raises(RuntimeError, match=f"{where} failed"):
        graphs(leaves, _prompts(model.cfg, 1)[0])
    assert graphs.slots == 0 and graphs.replays == 0
    assert spy.runs == (1 if where == "capture" else 2)   # the warm-up only
    assert made[0].resets == (0 if where == "capture" else 1)


def test_call_graphs_need_the_card_or_a_capture():
    model, _ = _served("qwen1.5-0.5b")
    with pytest.raises(ValueError, match="CUDA graphs need the card"):
        CallGraphs(model, 2, "cpu")
    with pytest.raises(ValueError, match="capacity 0"):
        CallGraphs(model, 0, "cpu", capture_factory=StandInCapture)


@pytest.mark.parametrize("arch", ARCHS + ["zamba2-1.2b"])
def test_param_bytes_counts_what_a_call_copies(arch):
    model, leaves = _served(arch)
    assert param_bytes(model.cfg) == sum(
        x.numel() * x.element_size() for x in leaves.values())
    full = get_config(arch)
    want = {"qwen1.5-0.5b": 927_975_424, "mamba2-130m": 257_970_432,
            "zamba2-1.2b": 2_176_335_872}[arch]
    assert param_bytes(full) == want


# -- the pinned host leaves ----------------------------------------------------

@pytest.fixture
def pins(monkeypatch):
    """``pinned_empty`` without a card: a pageable buffer, recorded."""
    seen = []

    def fake(numel, dtype):
        seen.append(dtype)
        return torch.empty(numel, dtype=dtype)

    monkeypatch.setattr(serve, "pinned_empty", fake)
    return seen


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pin", [False, True])
def test_host_leaves_pickle_to_equal_values_and_pin_only_when_asked(
        arch, pin, pins):
    model, leaves = _served(arch)
    dtypes = {x.dtype for x in leaves.values()}
    assert isinstance(leaves, serve.HostLeaves) and not leaves.pin
    assert pins == [] and set(leaves.flats) == dtypes
    made = serve.HostLeaves(leaves, pin=pin)
    assert len(pins) == (len(dtypes) if pin else 0)   # one buffer a dtype
    back = pickle.loads(pickle.dumps(made))
    assert len(pins) == (2 * len(dtypes) if pin else 0)
    assert back.pin == pin and list(back) == list(leaves)
    assert back.layout == made.layout == leaves.layout
    for name in leaves:
        assert back[name].dtype == leaves[name].dtype
        assert torch.equal(back[name], leaves[name])
        flat = back.flats[back[name].dtype]           # a view of its buffer
        assert back[name].untyped_storage().data_ptr() == \
            flat.untyped_storage().data_ptr()
    assert torch.bfloat16 in dtypes


@pytest.mark.parametrize("arch", ARCHS + ["zamba2-1.2b"])
def test_flat_layout_puts_every_leaf_on_a_256_byte_boundary(arch):
    from repro_torch.launch.call_graphs import flat_layout
    _, leaves = _served(arch)
    layout, sizes = flat_layout((n, t.dtype, t.shape)
                                for n, t in leaves.items())
    assert [e[0] for e in layout] == list(leaves)
    ends = {}
    for name, dtype, offset, shape in layout:
        assert offset * dtype.itemsize % 256 == 0
        assert offset >= ends.get(dtype, 0)           # no overlap
        ends[dtype] = offset + int(np.prod(shape))
    assert ends == sizes


def test_leaves_pin_once_per_decoded_snapshot_and_per_copy_restore(pins):
    _, leaves = _served("mamba2-130m")
    n = len(leaves.flats)                      # f32 and bf16 buffers
    f = Faaslet("infer", "host0")
    proto = ProtoFaaslet.capture(
        f, {"params": serve.HostLeaves(leaves, pin=True)})
    assert len(pins) == n                      # the init's own copy
    a = proto.restore("host0")[1]["params"]
    b = proto.restore("host1")[1]["params"]
    assert a is b and len(pins) == 2 * n       # one decoded template
    c = proto.restore_copy("host0")[1]["params"]
    assert c is not a and len(pins) == 3 * n   # a full restore pins again
    assert all(torch.equal(c[k], leaves[k]) for k in leaves)


def test_leaves_of_another_model_fail_the_call():
    model, _ = _served("qwen1.5-0.5b")
    _, other = _served("mamba2-130m")
    graphs = CallGraphs(model, 1, "cpu", capture_factory=_factory([]))
    with pytest.raises(ValueError, match="packed for another model"):
        graphs(other, _prompts(model.cfg, 1)[0])
    assert graphs.slots == 0


def test_executable_cache_closes_what_it_drops():
    closed = []

    class Entry:
        def __init__(self, name):
            self.name = name

        def close(self):
            closed.append(self.name)

    cache = ExecutableCache()
    cache.get_or_build("k", lambda: Entry("a"))
    assert cache.get("k").name == "a" and cache.get("x") is None
    cache.evict("k")
    assert closed == ["a"] and not cache.contains("k")
    cache.evict("k")                           # nothing to drop
    cache.get_or_build("k", lambda: Entry("b"))
    cache.get_or_build("j", lambda: "a plain function has no close")
    cache.clear()
    assert closed == ["a", "b"] and cache.stats()["entries"] == 0
    assert cache.stats()["misses"] == 3


# -- the launcher and the Fig. 7 twin on the CPU -------------------------------

def _refuse_graph_apis(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CUDA graph API was called on the CPU")

    for name in ("CUDAGraph", "graph", "graph_pool_handle", "Stream",
                 "Event"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(serve, "CallGraphs", refuse)
    monkeypatch.setattr(serve, "pinned_empty", refuse)


def test_serve_fans_out_on_the_cpu_with_no_graph_api(monkeypatch, capsys):
    _refuse_graph_apis(monkeypatch)
    res = serve.main(["--smoke", "--device", "cpu", "--new-tokens", "2",
                      "--faasm-requests", "16"])
    r = res["faasm"]
    out = capsys.readouterr().out
    assert re.search(r"per call: parameter copy [\d.]+ms \(0\.000 GB\), "
                     r"forward [\d.]+ms; 0 captures in 0\.0ms", out), out
    assert all(t is not None for t in r["tokens"])
    assert r["captures"] == 0 and "replays" not in r
    assert r["param_bytes"] == param_bytes(res["cfg"])
    assert r["forward_ms"] > 0 and r["infer_ms"] >= r["forward_ms"]


def test_fig7_twin_runs_both_modes_on_the_cpu(monkeypatch, capsys):
    import inference_serving_torch as twin
    _refuse_graph_apis(monkeypatch)
    results = twin.main(["--smoke", "--device", "cpu", "--requests", "8"])
    out = capsys.readouterr().out
    lines = re.findall(r"\[(faaslet|container) +cold=(0|20)%\] p50= *[\d.]+ms"
                       r" p99= *[\d.]+ms init= *[\d.]+ms tput= *[\d.]+ req/s"
                       r" batch= *[\d.]+ req/s", out)
    assert lines == [("faaslet", "0"), ("faaslet", "20"),
                     ("container", "0"), ("container", "20")], out
    assert "serving qwen1.5-0.5b-smoke (8 requests)" in out
    for r in results:
        assert len(r["tokens"]) == len(r["batch_tokens"]) == 8
        assert r["captures"] == 0 and set(r["cold_captures"]) <= {0}
    # a container cold start rebuilds the cached forward; a Faaslet's not
    assert [r["misses"] for r in results] == [1, 1, 1,
                                             1 + len(results[3]
                                                     ["cold_captures"])]
    # every run draws the same prompts (the reference's rng draws)
    assert all(r["tokens"] == results[0]["tokens"] for r in results)


def test_fig7_benchmark_twin_emits_the_reference_quantities(capsys):
    from benchmarks import bench_inference_torch
    bench_inference_torch.main(["--device", "cpu"])
    rows = [l.split(",")[0] for l in capsys.readouterr().out.splitlines()
            if l.startswith("fig7_infer_torch/")]
    assert rows == [f"fig7_infer_torch/{m}/cold{c}/{q}"
                    for m in ("faaslet", "container") for c in (0, 20)
                    for q in ("p50", "init")]
