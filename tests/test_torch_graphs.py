"""The serving loop's compiled step (``repro_torch.launch.step_graphs``) on
the CPU, where there are no CUDA graphs.

A stand-in graph takes ``torch.cuda.CUDAGraph``'s place: its capture runs
the step's Python once, as a capture does, and each replay runs it again.
That holds what the launcher does around the graphs (static buffers, the
position advanced in the step, shapes, launch accounting, one
cancellation checkpoint per replay) against the eager loop; the card
tests in ``tests/test_torch_cuda.py`` hold the real graphs bitwise
against it.  ``serve.main --device cpu`` runs the eager loop and touches
no graph API.  No JAX here.
"""
import contextlib
import threading

import numpy as np
import pytest
import torch

from repro_torch import cancellation
from repro_torch.configs import smoke_config
from repro_torch.kernels.common import LaunchCounter, LaunchLog
from repro_torch.launch import serve, step_graphs
from repro_torch.launch.step_graphs import ServeGraphs, eager_generate
from repro_torch.models import build_model
from torch_host_events import HostStamp

ARCHS = ["qwen1.5-0.5b", "deepseek-moe-16b", "mamba2-130m", "zamba2-1.2b"]
B, S, NEW = 2, 16, 5


class StandInGraph:
    """``torch.cuda.CUDAGraph``'s replay and reset; ``log`` records each
    replay in order."""

    def __init__(self, body, log, name):
        self.body, self.log, self.name = body, log, name

    def replay(self):
        self.log.append(f"replay {self.name}")
        if self.body is not None:
            self.body()

    def reset(self):
        self.body = None


class StandInCapture:
    """``CudaCapture`` on the CPU: the capture runs the step once, as a
    CUDA capture runs its Python (with ``run_on_replay`` False the replays
    then run nothing)."""

    def __init__(self, run_on_replay=True):
        self.log, self.names = [], iter(("prefill", "decode"))
        self.run_on_replay = run_on_replay

    def on_stream(self):
        return contextlib.nullcontext()

    def capture(self, body):
        body()
        return StandInGraph(body if self.run_on_replay else None, self.log,
                            next(self.names))

    def event(self):
        return HostStamp()


def _served(arch, seed=0):
    cfg = smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32)
    return model, params, tokens


def test_captured_launches_reach_no_total_until_each_replay():
    c = LaunchCounter()
    with LaunchLog(capturing=True) as graph:
        c.add()
        c.add((8, 16))
        c.add((8, 16))
        c.add((16, 8))
    assert c.value == 0 and c.by_key() == {}
    assert graph.count(c) == 4
    assert graph.by_key(c) == {(8, 16): 2, (16, 8): 1}
    graph.replay()
    assert c.value == 4 and c.by_key() == {(8, 16): 2, (16, 8): 1}
    graph.replay()
    assert c.value == 8 and c.by_key() == {(8, 16): 4, (16, 8): 2}
    c.reset()
    assert c.value == 0 and c.by_key() == {}
    graph.replay()
    assert c.value == 4 and c.by_key() == {(8, 16): 2, (16, 8): 1}
    c.add()                                   # outside the log: counted
    assert c.value == 5 and graph.count(c) == 4


def test_an_eager_log_counts_as_usual_and_keeps_a_tally():
    c, other = LaunchCounter(), LaunchCounter()
    with LaunchLog() as warm:
        c.add("a")
        c.add()
        other.add()
    assert c.value == 2 and c.by_key() == {"a": 1} and other.value == 1
    assert warm.count(c) == 2 and warm.by_key(c) == {"a": 1}
    assert warm.count(other) == 1
    c.add()
    assert warm.count(c) == 2


def test_a_capture_on_one_thread_leaves_another_threads_launches_counted():
    c = LaunchCounter()
    started, done = threading.Event(), threading.Event()

    def eager():
        started.wait(5)
        for _ in range(10):
            c.add()
        done.set()

    t = threading.Thread(target=eager)
    t.start()
    with LaunchLog(capturing=True) as graph:
        c.add()
        started.set()
        assert done.wait(5)
    t.join(5)
    assert not t.is_alive()
    assert c.value == 10 and graph.count(c) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_replayed_steps_give_the_eager_loops_ids_and_logits(arch):
    model, params, tokens = _served(arch)
    want = eager_generate(model, params, tokens, NEW, keep_logits=True)
    graphs = ServeGraphs(model, params, B, S, S + NEW, "cpu",
                         capture=StandInCapture())
    for run in range(2):                      # the second replays, no capture
        got = graphs.generate(tokens, NEW, keep_logits=True)
        assert got.ids.dtype == torch.int32 and torch.equal(got.ids, want.ids)
        assert len(got.logits) == NEW
        for a, b in zip(got.logits, want.logits):
            assert torch.equal(a, b)
        assert graphs.replays == {"prefill": run + 1,
                                  "decode": (run + 1) * (NEW - 1)}
    assert int(graphs.idx[0]) == S + NEW - 1
    graphs.close()


def test_each_replay_is_one_cancellation_checkpoint(monkeypatch):
    model, params, tokens = _served("qwen1.5-0.5b")
    cap = StandInCapture(run_on_replay=False)
    graphs = ServeGraphs(model, params, B, S, S + NEW, "cpu", capture=cap)
    monkeypatch.setattr(cancellation, "checkpoint",
                        lambda: cap.log.append("checkpoint"))
    graphs.generate(tokens, NEW)
    steps = ["prefill"] + ["decode"] * (NEW - 1)
    assert cap.log == [e for s in steps for e in ("checkpoint", f"replay {s}")]


def test_a_cancel_lands_within_one_step():
    model, params, tokens = _served("qwen1.5-0.5b")
    cap = StandInCapture(run_on_replay=False)
    graphs = ServeGraphs(model, params, B, S, S + NEW, "cpu", capture=cap)
    checks = []

    def check():
        checks.append(1)
        if len(checks) == 3:
            raise TimeoutError("cancelled")

    cancellation.install(check, slice_s=0.0)
    try:
        with pytest.raises(TimeoutError):
            graphs.generate(tokens, NEW)
    finally:
        cancellation.clear()
    assert cap.log == ["replay prefill", "replay decode"]


def test_other_shapes_raise_and_nothing_recaptures():
    model, params, tokens = _served("mamba2-130m")
    cap = StandInCapture()
    graphs = ServeGraphs(model, params, B, S, S + NEW, "cpu", capture=cap)
    with pytest.raises(ValueError, match="decode at position None"):
        graphs.step()
    with pytest.raises(ValueError, match=r"captured for \(2, 16\)"):
        graphs.generate(tokens[:, :8], 2)
    with pytest.raises(ValueError, match=r"captured for \(2, 16\)"):
        graphs.generate(torch.cat([tokens, tokens]), 2)
    with pytest.raises(ValueError, match="1 to 5"):
        graphs.generate(tokens, NEW + 1)
    with pytest.raises(ValueError, match="1 to 5"):
        graphs.generate(tokens, 0)
    graphs.generate(tokens, NEW)
    graphs.step()                             # the cache's last position
    with pytest.raises(ValueError, match="the cache holds 21"):
        graphs.step()
    assert graphs.replays == {"prefill": 1, "decode": NEW}
    with pytest.raises(ValueError, match="CUDA graphs need the card"):
        ServeGraphs(model, params, B, S, S + NEW, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_the_cpu_runs_the_eager_loop_and_no_graph_api(arch,
                                                                monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CUDA graph API was called on the CPU")

    for name in ("CUDAGraph", "graph", "graph_pool_handle", "Stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(serve, "ServeGraphs", refuse)
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--new-tokens", "4", "--batch", "3"], keep_logits=True)
    assert res["graphs"] is None and res["capture_s"] == 0.0
    model, params, tokens = res["model"], res["params"], res["tokens"]
    cache = model.init_cache(3, 16 + 4, "cpu")
    with torch.no_grad():                     # the loop, written out
        logits, cache, n = model.prefill(params, tokens, cache)
        ids = [logits.argmax(-1).to(torch.int32)]
        for i in range(3):
            idx = torch.full((3,), n + i, dtype=torch.int32)
            logits, cache = model.decode_step(params, ids[-1], cache, idx)
            ids.append(logits.argmax(-1).to(torch.int32))
    assert torch.equal(res["gen"], torch.stack(ids, dim=1))
    for i, lg in enumerate(res["logits"]):
        assert torch.equal(lg.argmax(-1).to(torch.int32), res["gen"][:, i])


def test_eager_generate_is_the_module_serve_runs_on_the_cpu(monkeypatch):
    calls = []
    real = step_graphs.eager_generate

    def spy(*a, **kw):
        calls.append(a[3])
        return real(*a, **kw)

    monkeypatch.setattr(serve, "eager_generate", spy)
    serve.main(["--smoke", "--device", "cpu", "--new-tokens", "3"])
    assert calls == [3]
