"""The captured train step (``repro_torch.launch.train_graphs``) on the CPU,
where there are no CUDA graphs.

A stand-in capture takes ``CudaCapture``'s place.  As a CUDA capture, it
runs the step's Python once and leaves every tensor the step writes as it
found it (it puts the parameters and optimizer state back), and each
replay runs the recorded step again with no wrapper counting a launch
(a replay runs no Python).  That holds what the captured step does around
the graph against the eager step, three steps each: the batches go
through the static buffers, the metrics come back as copies, the capture
comes after a checkpoint's restore, launch counts are added once per
replay, the graphed factory refuses the CPU without a stand-in, and the
launchers run the eager step on the CPU and touch no graph API.  The card
rows in ``tests/test_torch_cuda.py`` hold the real graphs bitwise against
the eager step.  No JAX here.
"""
import contextlib
import copy
import threading

import pytest
import torch

from repro_torch.configs import smoke_config, smoke_shape
from repro_torch.data import PipelineConfig, make_batch
from repro_torch.kernels.common import LaunchCounter, LaunchLog
from repro_torch.launch import train_graphs
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train_graphs import GraphedTrainStep, written
from repro_torch.models import ExecConfig, build_model
from repro_torch.models.weights import trainable
from repro_torch.optim import SGD, AdamW, warmup_cosine
from torch_host_events import HostStamp

STEPS = 3


class StandInGraph:
    """``torch.cuda.CUDAGraph``'s replay and reset: a replay runs the step
    again, its wrappers' launches recorded by an open capturing log and so
    counted by no counter (the graph's log adds them)."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        with LaunchLog(capturing=True, all_threads=True):
            self.body()

    def reset(self):
        self.body = None


class StandInCapture:
    """``CudaCapture`` on the CPU.  ``captured`` keeps the parameters each
    capture recorded."""

    def __init__(self):
        self.captured = []

    def on_stream(self):
        return contextlib.nullcontext()

    def capture(self, body):
        owner = body.__self__
        kept = [t.detach().clone()
                for t in written(owner.params, owner.state)]
        body()
        with torch.no_grad():
            for t, k in zip(written(owner.params, owner.state), kept):
                t.copy_(k)
        self.captured.append(owner.params)
        return StandInGraph(body)

    def event(self):
        return HostStamp()


def _batches(cfg, shape):
    return [{k: torch.from_numpy(v) for k, v in make_batch(
        cfg, shape, PipelineConfig(seed=0), i).items()} for i in range(STEPS)]


def _setup(arch, opt_name, n_micro):
    cfg = smoke_config(arch)
    shape = smoke_shape("train")
    model = build_model(cfg, ExecConfig(loss_chunk=16, microbatches=n_micro))
    sched = warmup_cosine(0.05, warmup=1, total=STEPS)
    opt = SGD(lr=sched, momentum=0.9) if opt_name == "sgd" else \
        AdamW(lr=sched)
    params = trainable(model.init(torch.Generator().manual_seed(0), "cpu"))
    return cfg, shape, model, opt, params


def _run(step, params, state, batches):
    metrics = []
    for batch in batches:
        params, state, m = step(params, state, batch)
        metrics.append(m)
    return params, state, metrics


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-130m"])
def test_captured_steps_equal_the_eager_steps(arch, opt_name, n_micro):
    """Three steps through the captured step (warm-up, capture and replay,
    replay) give the eager step's loss, aux loss, gradient norm,
    parameters and optimizer state at every step, bitwise: each replay
    reads its batch from the static buffers, and the recorded update
    advances the step counter the schedule reads."""
    cfg, shape, model, opt, params = _setup(arch, opt_name, n_micro)
    batches = _batches(cfg, shape)
    eager = make_train_step(model, opt, shape)
    p_e = copy.deepcopy(params)
    p_e, s_e, m_e = _run(eager, p_e, opt.init(p_e), batches)

    capture = StandInCapture()
    graphed = GraphedTrainStep(eager, "cpu", capture=capture)
    p_g, s_g, m_g = _run(graphed, params, opt.init(params), batches)
    assert graphed.replays == STEPS - 1 and capture.captured == [params]
    for k in batches[0]:                       # the last batch, copied in
        assert torch.equal(graphed.batch[k], batches[-1][k])
        assert graphed.batch[k] is not batches[-1][k]
    for a, b in zip(m_g, m_e):
        assert set(a) == set(b) == {"loss", "aux_loss", "grad_norm"}
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert int(s_g.step) == int(s_e.step) == STEPS
    for a, b in zip(written(p_g, s_g), written(p_e, s_e)):
        assert torch.equal(a, b)


def test_returned_metrics_are_copies_not_the_graphs_outputs():
    """A list of the losses of three steps holds three values: each
    replay's metrics are copies of the graph's static outputs, which the
    next replay overwrites."""
    cfg, shape, model, opt, params = _setup("qwen1.5-0.5b", "sgd", 1)
    graphed = GraphedTrainStep(make_train_step(model, opt, shape), "cpu",
                               capture=StandInCapture())
    state = opt.init(params)
    losses = []
    for batch in _batches(cfg, shape):
        params, state, metrics = graphed(params, state, batch)
        losses.append(metrics["loss"])
    assert len({float(x) for x in losses}) == STEPS
    static = graphed.out["loss"]
    assert all(x is not static and x.data_ptr() != static.data_ptr()
               for x in losses)
    assert torch.equal(losses[-1], static)


def test_all_threads_log_takes_another_threads_launches():
    """Autograd runs a CUDA backward on a thread of its own: a capture's
    log open on every thread records that thread's launches, uncounted,
    and adds them at each replay; a log of this thread only misses them."""
    c = LaunchCounter()

    def other():
        c.add("recompute")

    with LaunchLog(capturing=True, all_threads=True) as shared:
        c.add("forward")
        t = threading.Thread(target=other)
        t.start()
        t.join(5)
    assert c.value == 0 and shared.by_key(c) == {"forward": 1,
                                                 "recompute": 1}
    shared.replay()
    assert c.by_key() == {"forward": 1, "recompute": 1}
    c.reset()
    with LaunchLog(capturing=True) as mine:
        t = threading.Thread(target=other)
        t.start()
        t.join(5)
    assert mine.count(c) == 0 and c.value == 1
    c.add()                                     # no log open: counted
    assert c.value == 2 and shared.count(c) == 2


def test_launch_counts_are_replayed_per_step():
    """A step whose kernels launch on this thread and on another (the
    backward's) counts them once per step through the warm-up, the
    capture's first replay and each later replay, by key; the graph's log
    holds one step's launches, the warm-up's log the same."""
    c = LaunchCounter()

    def step(params, state, batch):
        c.add("fwd")
        t = threading.Thread(target=c.add, args=("bwd",))
        t.start()
        t.join(5)
        with torch.no_grad():
            params.w.add_(batch["x"])
        return params, state._replace(step=state.step + 1), batch["x"].sum()

    class P(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(3))

    from repro_torch.optim.sgd import SGDState
    params = P()
    state = SGDState(step=torch.zeros((), dtype=torch.int32), momentum=())
    graphed = GraphedTrainStep(step, "cpu", capture=StandInCapture())
    n = 4
    for i in range(n):
        params, state, out = graphed(params, state,
                                     {"x": torch.full((3,), float(i))})
        assert c.by_key() == {"fwd": i + 1, "bwd": i + 1}
        assert float(out) == 3.0 * i
    assert graphed.launches.by_key(c) == {"fwd": 1, "bwd": 1}
    assert graphed.warmup_launches.by_key(c) == {"fwd": 1, "bwd": 1}
    assert int(state.step) == n
    assert torch.equal(params.w, torch.full((3,), float(sum(range(n)))))


def test_graphed_factory_refuses_a_non_cuda_device():
    step = lambda p, s, b: (p, s, {})           # noqa: E731
    with pytest.raises(ValueError, match="CUDA graphs need the card"):
        GraphedTrainStep(step, "cpu")
    assert train_graphs.for_device(step, "cpu") is step


def test_a_replay_refuses_other_tensors_and_other_shapes():
    """A captured step replays on the parameters and state it captured and
    on batches of the captured shapes; a step that hands back new
    parameters cannot be captured."""
    cfg, shape, model, opt, params = _setup("qwen1.5-0.5b", "sgd", 1)
    graphed = GraphedTrainStep(make_train_step(model, opt, shape), "cpu",
                               capture=StandInCapture())
    state = opt.init(params)
    batches = _batches(cfg, shape)
    params, state, _ = graphed(params, state, batches[0])
    params, state, _ = graphed(params, state, batches[1])
    with pytest.raises(ValueError, match="parameters and state it captured"):
        graphed(copy.deepcopy(params), state, batches[2])
    short = {k: v[:1] for k, v in batches[2].items()}
    with pytest.raises(ValueError, match="captured for"):
        graphed(params, state, short)
    fresh = lambda p, s, b: (copy.deepcopy(p), s, {})   # noqa: E731
    other = GraphedTrainStep(fresh, "cpu", capture=StandInCapture())
    other(params, state, batches[0])
    with pytest.raises(RuntimeError, match="returned new parameters"):
        other(params, state, batches[1])


def test_a_closed_step_frees_its_graph_and_refuses_a_call():
    """``close`` resets the graph and drops the static buffers; the step
    is then done with (no second capture), and its eager step stays
    callable."""
    cfg, shape, model, opt, params = _setup("qwen1.5-0.5b", "sgd", 1)
    graphed = GraphedTrainStep(make_train_step(model, opt, shape), "cpu",
                               capture=StandInCapture())
    state = opt.init(params)
    batches = _batches(cfg, shape)
    for b in batches[:2]:
        params, state, _ = graphed(params, state, b)
    graph = graphed.graph
    graphed.close()
    assert graph.body is None and graphed.graph is None
    assert graphed.batch is None and graphed.out is None
    with pytest.raises(RuntimeError, match="was closed"):
        graphed(params, state, batches[2])
    _, state, m = graphed.step(params, state, batches[2])
    assert int(state.step) == 3 and torch.isfinite(m["loss"])


def test_an_all_threads_capture_is_the_only_log_open():
    """A training capture takes every thread's launches, so it refuses to
    open beside another open log, and no log opens while it is open: a
    serving slot's launches would otherwise count into the graph's."""
    with LaunchLog():
        with pytest.raises(RuntimeError, match="only launch log"):
            with LaunchLog(capturing=True, all_threads=True):
                pass
    seen = []

    def other():
        try:
            with LaunchLog(capturing=True):
                pass
        except RuntimeError as e:
            seen.append(str(e))

    with LaunchLog(capturing=True, all_threads=True):
        t = threading.Thread(target=other)
        t.start()
        t.join(5)
    assert len(seen) == 1 and "only launch log" in seen[0]
    with LaunchLog(all_threads=True), LaunchLog():   # no capture: both fine
        pass
    with LaunchLog(capturing=True, all_threads=True):
        pass                                # all closed again


def _no_graphs(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA graph API was called on the CPU")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", refuse)


def _launcher(which):
    if which == "train":
        from repro_torch.launch import train
        return train.main
    import importlib
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    try:
        return importlib.import_module("train_lm_torch").main
    finally:
        sys.path.pop(0)


@pytest.mark.parametrize("which", ["train", "example"])
def test_launchers_on_the_cpu_build_no_graph(which, tmp_path, monkeypatch):
    _no_graphs(monkeypatch)
    res = _launcher(which)(["--smoke", "--device", "cpu", "--steps", "3",
                            "--ckpt-dir", str(tmp_path)])
    assert not isinstance(res["step"], GraphedTrainStep)
    assert len(res["losses"]) == 3


@pytest.mark.parametrize("which", ["train", "example"])
def test_the_capture_comes_after_a_restore(which, tmp_path, monkeypatch):
    """Resumed from a checkpoint, the launcher captures the step on the
    restored parameters (not those it drew before the restore), and the
    captured run's losses and parameters equal the eager run's from the
    same checkpoint, bitwise."""
    import shutil
    main = _launcher(which)
    common = ["--smoke", "--device", "cpu", "--ckpt-every", "0"]
    main(common + ["--steps", "2", "--ckpt-dir", str(tmp_path / "a")])
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    eager = main(common + ["--steps", "5", "--resume", "--ckpt-dir",
                           str(tmp_path / "a")])
    capture = StandInCapture()
    made = []

    def graphed(step, device):
        made.append(GraphedTrainStep(step, device, capture=capture))
        return made[-1]

    monkeypatch.setattr(train_graphs, "for_device", graphed)
    got = main(common + ["--steps", "5", "--resume", "--ckpt-dir",
                         str(tmp_path / "b")])
    assert got["step"] is made[0] and made[0].replays == 2
    assert capture.captured == [got["params"]]
    assert [float(x) for x in got["losses"]] == \
        [float(x) for x in eager["losses"]]
    for a, b in zip(written(got["params"], got["state"]),
                    written(eager["params"], eager["state"])):
        assert torch.equal(a, b)
