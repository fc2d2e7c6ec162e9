"""The twins of the paper's experiments against the reference's, on the CPU.

Each twin (``examples/*_torch.py``, ``benchmarks/bench_*_torch.py``) runs
in-process beside its reference (``examples/*.py``, ``benchmarks/*.py``,
JAX package) with the same seeds, the port on ``device="cpu"``.  Held:
the quickstart's output, return code and vector; the chained matmul's
merged product bitwise; Fig. 6 with one worker bitwise on both wires
(weights, hinge, accuracy); the Fig. 6 contrast at 2 and 4 workers in
both packages; every benchmark twin's rows under its ``_torch`` name.

Transfer bytes are held exactly, with one known difference: a
Proto-Faaslet snapshot is a pickle, and the port's names its class
``repro_torch.core.proto.ProtoFaaslet``, six bytes longer than the
reference's, so every snapshot the global tier moves (an upload or a
host's first restore) counts six bytes more in the port.  With two
hosts and four executors the quickstart's pull bytes race in both
packages (a worker finds its host's replica warm or cold); its
transfer is held on one host with one worker slot, where they do not.
"""
import collections
import re
import sys
import threading
from pathlib import Path

import jax  # noqa: F401  (both frameworks load in the test process)
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
for _d in (REPO / "examples", REPO):
    if str(_d) not in sys.path:
        sys.path.insert(0, str(_d))

import matmul_chained  # noqa: E402
import matmul_chained_torch  # noqa: E402
import quickstart  # noqa: E402
import quickstart_torch  # noqa: E402
import sgd_hogwild  # noqa: E402
import sgd_hogwild_torch  # noqa: E402
from repro.core import FaasmRuntime as RefRuntime  # noqa: E402
from repro_torch.core import FaasmRuntime as PortRuntime  # noqa: E402
from repro_torch.data import make_sparse_dataset  # noqa: E402
from torch_twin_planes import port_planes_disarmed  # noqa: E402,F401

CPU = ["--device", "cpu"]
SNAPSHOT_EXTRA = len("repro_torch") - len("repro")   # bytes per snapshot


def _recording(base, record: dict, **force):
    """A runtime class that keeps its calls' outputs, its transfer bytes
    and its final weight vector (if any) in ``record`` at shutdown, with
    ``force`` overriding constructor arguments."""

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**kw, **force})

        def output(self, cid):
            out = super().output(cid)
            record.setdefault("outputs", []).append(out)
            return out

        def shutdown(self):
            record["transfer"] = self.transfer_bytes()
            record["pushed"] = dict(self.global_tier.bytes_pushed)
            if self.global_tier.exists("weights"):
                record["weights"] = np.frombuffer(
                    self.global_tier.get("weights", host="check"),
                    np.float32).copy()
            super().shutdown()

    return Recording


def _lines(text: str) -> dict:
    return dict(line.split(":", 1) for line in text.splitlines()
                if ":" in line)


# -- quickstart ----------------------------------------------------------------


def test_quickstart_twin_prints_the_references_lines(capsys, monkeypatch):
    ref = {}
    monkeypatch.setattr(quickstart, "FaasmRuntime",
                        _recording(RefRuntime, ref))
    quickstart.main()
    want = capsys.readouterr().out
    port = {}
    monkeypatch.setattr(quickstart_torch, "FaasmRuntime",
                        _recording(PortRuntime, port))
    r = quickstart_torch.main(CPU)
    got = capsys.readouterr().out
    for key in ("return code", "output", "accumulated state"):
        assert _lines(got)[key] == _lines(want)[key]
    assert got.splitlines()[-1] == want.splitlines()[-1] == "quickstart OK"
    assert [k for k in _lines(got)] == [k for k in _lines(want)]
    vec = np.zeros(8, np.float32)
    for i in range(8):
        vec[i % 8] += i
    assert r["rc"] == 0 and np.array_equal(r["final"], vec)
    assert r["output"] == ref["outputs"][-1] == port["outputs"][-1]
    # the workers' pushes move the same bytes; the uploads (two snapshots)
    # six bytes more each in the port
    up = port["pushed"].pop("upload") - ref["pushed"].pop("upload")
    assert up == 2 * SNAPSHOT_EXTRA
    assert sum(port["pushed"].values()) == sum(ref["pushed"].values())


def test_quickstart_transfer_bytes_on_one_slot(capsys, monkeypatch):
    """On one host with one worker slot beside the orchestrator the
    transfer is the same in every run; the port's is the reference's plus
    the snapshots' names (two uploads, two first restores)."""
    ref, port = {}, {}
    monkeypatch.setattr(quickstart, "FaasmRuntime", _recording(
        RefRuntime, ref, n_hosts=1, capacity=2))
    monkeypatch.setattr(quickstart_torch, "FaasmRuntime", _recording(
        PortRuntime, port, n_hosts=1, capacity=2))
    quickstart.main()
    want = int(_lines(capsys.readouterr().out)["transfer bytes"])
    r = quickstart_torch.main(CPU)
    got = int(_lines(capsys.readouterr().out)["transfer bytes"])
    assert got == r["transfer_bytes"] == port["transfer"]
    assert want == ref["transfer"]
    assert got - want == 4 * SNAPSHOT_EXTRA


# -- chained matmul (Fig. 8's example) ------------------------------------------


@pytest.mark.parametrize("n", [64, 128])
def test_matmul_twin_merges_the_same_product(n, capsys, monkeypatch):
    ref = {}
    monkeypatch.setattr(matmul_chained, "FaasmRuntime",
                        _recording(RefRuntime, ref))
    monkeypatch.setattr(sys, "argv", ["matmul_chained.py", "--n", str(n),
                                      "--splits", "2"])
    matmul_chained.main()
    want = capsys.readouterr().out
    r = matmul_chained_torch.main(["--n", str(n), "--splits", "2", *CPU])
    got = capsys.readouterr().out
    np.testing.assert_array_equal(
        r["out"], np.frombuffer(ref["outputs"][-1], np.float32).reshape(n, n))
    assert r["rel_err"] < 1e-5
    assert r["transfer_bytes"] - ref["transfer"] == 4 * SNAPSHOT_EXTRA
    mask = lambda s: re.sub(r"\d+\.\d+s ", "", s)          # the wall time
    assert mask(got) == mask(want)


# -- HOGWILD SGD (Fig. 6's example) ----------------------------------------------


@pytest.fixture(scope="module")
def data():
    """Above the int8 floor (2,048 f32 weights, 8 KB), so the int8 wire
    runs its codec."""
    return make_sparse_dataset(2048, 256, density=0.1, seed=0)[:2]


@pytest.mark.parametrize("mode", ["faaslet", "container"])
@pytest.mark.parametrize("wire", ["exact", "int8"])
def test_fig6_one_worker_is_the_references_bitwise(data, mode, wire,
                                                    monkeypatch):
    X, y = data
    ref = {}
    monkeypatch.setattr(sgd_hogwild, "FaasmRuntime",
                        _recording(RefRuntime, ref))
    want = sgd_hogwild.run_mode(mode, X, y, 1, 2, 2, wire=wire)
    got = sgd_hogwild_torch.run_mode(mode, X, y, 1, 2, 2, wire=wire,
                                     device="cpu")
    np.testing.assert_array_equal(got["weights"], ref["weights"])
    assert got["hinge"] == want["hinge"] and got["acc"] == want["acc"]
    # metrics reset after the uploads: a Faaslet restores each function's
    # snapshot once (two pulls); a container cold-starts without one
    extra = 2 * SNAPSHOT_EXTRA if mode == "faaslet" else 0
    assert round((got["transfer_mb"] - want["transfer_mb"]) * 1e6) == extra


def test_fig6_int8_one_worker_encodes_each_push(data):
    """The int8 run pushes once per epoch through the quantised codec."""
    from repro_torch import telemetry
    X, y = data
    tel = telemetry.enable()
    sgd_hogwild_torch.run_mode("faaslet", X, y, 1, 2, 2, wire="int8",
                               device="cpu")
    pushes = [s for s in tel.drain() if s.name == "wire.push"]
    assert [s.tags["wire"] for s in pushes] == ["int8", "int8"]


@pytest.fixture(scope="module")
def wide():
    """Wide enough that the columns' pulls, not the weight vector's,
    set the transfer (at 2,048 x 256 the two modes move ~0.45 MB alike)."""
    return make_sparse_dataset(4096, 512, density=0.1, seed=0)[:2]


class _ReadingClock:
    """A clock that advances one microsecond at each reading: a call's
    held time becomes the readings taken while it runs, whatever the
    host's load."""

    def __init__(self):
        self._t, self._lock = 0.0, threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            self._t += 1e-6
            return self._t


def _in_worker_order(monkeypatch, example, host_cls, served):
    """Each epoch's ``weight_update`` calls take a warm instance, run and
    go back to the warm pool in worker order, all of them at once.

    Which warm instance a call takes is a race in both runtimes: a
    container that served the same column range in the epoch before
    pulls nothing new, and if every call of an epoch finds its own, the
    containers move no more bytes than the Faaslets (seen once in about
    20 runs of two workers).  Here worker w takes its instance once
    worker w - 1 has taken one; every worker holds its instance until all
    have one (so an epoch runs on as many instances as workers); and
    worker w returns its instance after worker w - 1.  The warm pool is
    last-in first-out, so each epoch's worker w takes the instance worker
    W - 1 - w returned: at two and four workers no container sees the
    same range twice.  ``served`` gets each call's instance by (run,
    epoch, worker), so the test can check that this still holds
    (:func:`_check_worker_order`)."""
    turns = collections.defaultdict(threading.Event)   # (run, step, w)
    epochs, lock = collections.Counter(), threading.Lock()
    here = threading.local()            # this thread's call: (run, epoch)
    real_run, real_build = host_cls._run, example.build_functions
    per, runtimes = {}, []              # columns per worker, by run

    def wait(key):
        assert turns[key].wait(60), key

    def run(self, call):
        if call.fn != "weight_update":
            return real_run(self, call)
        r = id(self.runtime)
        w = int(np.frombuffer(call.input, np.int32)[0]) // per[r]
        with lock:
            e = epochs[(r, w)]
            epochs[(r, w)] += 1
        here.call = (r, e)
        if w:
            wait((r, "took", e, w - 1))
        try:
            return real_run(self, call)
        finally:
            turns[(r, "back", e, w)].set()

    def build(n_features, n_cols, n_workers, n_epochs, **kw):
        update, main = real_build(n_features, n_cols, n_workers, n_epochs,
                                  **kw)

        def weight_update(api):
            r, e = here.call
            w = int(np.frombuffer(api.read_call_input(), np.int32)[0]) // per[r]
            served[(r, e, w)] = api.faaslet
            turns[(r, "took", e, w)].set()
            wait((r, "took", e, n_workers - 1))
            rc = update(api)
            if w:
                wait((r, "back", e, w - 1))
            return rc

        def sgd_main(api):
            runtimes.append(api.runtime)     # alive, so no run's id is reused
            per[id(api.runtime)] = n_cols // n_workers
            return main(api)
        return weight_update, sgd_main

    monkeypatch.setattr(host_cls, "_run", run)
    monkeypatch.setattr(example, "build_functions", build)


def _check_worker_order(served, n_runs, workers, epochs):
    """Each of ``n_runs`` runs served every worker in every epoch, and no
    worker's range ran on the instance that ran it the epoch before: fails
    if the warm pool stops handing instances back last-in first-out, so
    that the forced order no longer keeps the containers' pulls apart."""
    runs = sorted({r for r, _, _ in served})
    assert len(runs) == n_runs, runs
    for r in runs:
        assert {(e, w) for q, e, w in served if q == r} == {
            (e, w) for e in range(epochs) for w in range(workers)}
        for e in range(1, epochs):
            for w in range(workers):
                assert served[(r, e, w)] is not served[(r, e - 1, w)], \
                    (r, e, w)


@pytest.fixture
def seeded_runs(monkeypatch):
    """Both packages' Fig. 6 runs on the reading clock and in worker order
    (:class:`_ReadingClock`, :func:`_in_worker_order`); returns the
    instance that served each call."""
    from repro.core import runtime as ref_runtime
    from repro.telemetry import clock as ref_clock
    from repro_torch.core import runtime as port_runtime
    from repro_torch.telemetry import clock as port_clock
    clock = _ReadingClock()
    monkeypatch.setattr(ref_clock, "now", clock)
    monkeypatch.setattr(port_clock, "now", clock)
    served = {}
    _in_worker_order(monkeypatch, sgd_hogwild, ref_runtime.Host, served)
    _in_worker_order(monkeypatch, sgd_hogwild_torch, port_runtime.Host,
                     served)
    return served


@pytest.mark.parametrize("workers", [2, 4])
@pytest.mark.parametrize("wire", ["exact", "int8"])
def test_fig6_contrast_holds_in_both_packages(wide, workers, wire,
                                              seeded_runs):
    """HOGWILD with several workers races in both packages, so the values
    are not held; the paper's contrast is: containers move more bytes and
    hold more billable memory than Faaslets.  Two races would hide it at
    times: billable memory is memory times held time, and under a loaded
    host the Faaslet run's held time could grow past the container's
    ratio, so the runs bill on a clock of readings; and which warm
    container serves which worker is run in worker order
    (``seeded_runs``)."""
    X, y = wide
    pairs = [[run(mode, X, y, workers, 2, 2, wire=wire)
              for mode in ("faaslet", "container")]
             for run in (sgd_hogwild.run_mode,
                         lambda *a, **k: sgd_hogwild_torch.run_mode(
                             *a, **k, device="cpu"))]
    _check_worker_order(seeded_runs, 4, workers, 2)
    for f, c in pairs:
        assert c["transfer_mb"] > f["transfer_mb"]
        assert c["billable_gbs"] > f["billable_gbs"]
        assert f["acc"] > 0.5 and c["acc"] > 0.5


def test_fig6_twin_prints_the_references_lines(capsys):
    argv = ["--workers", "1", "--features", "2048", "--examples", "256",
            "--epochs", "2", "--wire", "int8"]
    old = sys.argv
    sys.argv = ["sgd_hogwild.py", *argv]
    try:
        sgd_hogwild.main()
    finally:
        sys.argv = old
    want = capsys.readouterr().out
    results = sgd_hogwild_torch.main([*argv, *CPU])
    got = capsys.readouterr().out
    mask = lambda s: re.sub(r"(wall|billable)=\S+", r"\1=", s)
    assert mask(got) == mask(want)
    assert [r["mode"] for r in results] == ["faaslet", "container"]


# -- the benchmark twins' rows ---------------------------------------------------


def _rows(text: str) -> list:
    return [line.split(",", 1)[0] for line in text.splitlines()
            if re.match(r"^[a-z0-9_]+/", line)]


def test_fig6_and_fig8_benchmark_twins_emit_the_references_rows(
        capsys, monkeypatch):
    from benchmarks import (bench_matmul, bench_matmul_torch,
                            bench_sgd_training, bench_sgd_training_torch)
    monkeypatch.chdir(REPO)          # the reference imports "examples" by cwd
    for ref, twin, table in ((bench_sgd_training, bench_sgd_training_torch,
                              "fig6_sgd"),
                             (bench_matmul, bench_matmul_torch,
                              "fig8_matmul")):
        ref.main()
        want = _rows(capsys.readouterr().out)
        twin.main(CPU)
        got = _rows(capsys.readouterr().out)
        assert want and got == [w.replace(f"{table}/", f"{table}_torch/")
                                for w in want]


def test_fig9_twin_emits_every_row_on_the_cpu(capsys):
    from benchmarks import bench_micro_torch
    m = bench_micro_torch.main(CPU)
    out = capsys.readouterr().out
    names = ["flash_attention", "decode_attention", "ssd_chunked", "moe_gmm",
             "state_push_fused", "state_push_quantize", "state_push_apply_q",
             "host_interface_call"]
    assert _rows(out) == [f"fig9_micro_torch/{n}" for n in names]
    assert all("plain version only (cpu)" in line
               for line in out.splitlines()[:7])
    assert "(cpu)" in out.splitlines()[7] and m.launches == {}


def test_dispatch_twin_emits_every_row_on_the_cpu(capsys):
    from benchmarks import bench_dispatch_torch
    rs = bench_dispatch_torch.main(20, "cpu", hold_floors=False)
    rows = _rows(capsys.readouterr().out)
    assert rows == [f"dispatch_torch/{m}/{k}" for m in ("faaslet", "container")
                    for k in ("warm_latency_p50", "serial_throughput",
                              "batch_throughput")]
    assert set(bench_dispatch_torch.floors(rs[0])) == {"p99", "batch"}


def test_run_torch_drives_a_table_on_the_cpu(capsys):
    from benchmarks import run_torch
    assert list(run_torch.TABLES) == ["fig6", "fig7", "fig8", "fig9", "tab3",
                                      "dispatch", "roofline"]
    run_torch.main(["fig8", *CPU])
    out = capsys.readouterr().out
    assert out.startswith("name,us_per_call,derived")
    assert len([r for r in _rows(out) if r.startswith("fig8_matmul_torch/")]) \
        == 4
