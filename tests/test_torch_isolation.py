"""The port stands alone: it imports nothing of JAX or of ``repro``, and its
entry point runs on the card unless the CPU is asked for."""
import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks load in the test process)
import pytest
import torch

from repro_torch.core import FaasmRuntime
from repro_torch.launch import serve
from repro_torch.state.kv import GlobalTier

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"] + sorted(REPO.glob("examples/*_torch.py")) + \
    sorted(REPO.glob("benchmarks/*_torch.py"))
TWINS = ["quickstart_torch", "matmul_chained_torch", "sgd_hogwild_torch",
         "benchmarks.bench_sgd_training_torch", "benchmarks.bench_matmul_torch",
         "benchmarks.bench_dispatch_torch", "benchmarks.bench_micro_torch",
         "benchmarks.bench_coldstart_torch", "benchmarks.run_torch"]
# readers of the dry-run's artifacts: they run on no device
READERS = ["benchmarks.bench_roofline_torch", "benchmarks.report_torch"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax_or_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_launcher_loads_no_jax_or_repro():
    code = ("import sys, repro_torch.launch.serve, repro_torch.models.weights\n"
            "import repro_torch.launch.train, repro_torch.launch.steps\n"
            "import repro_torch.launch.train_graphs\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
            "import repro_torch.distributed.elastic\n"
            "import repro_torch.distributed.pipeline\n"
            "import repro_torch.checkpoint, repro_torch.optim, repro_torch.data\n"
            "import repro_torch.core, repro_torch.state\n"
            "import repro_torch.kernels.state_push\n"
            "import repro_torch.analysis.sanitizer, repro_torch.telemetry\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_the_paper_twins_are_scanned():
    names = {p.name for p in PORT_FILES}
    assert {"quickstart_torch.py", "matmul_chained_torch.py",
            "sgd_hogwild_torch.py", "bench_sgd_training_torch.py",
            "bench_matmul_torch.py", "bench_dispatch_torch.py",
            "bench_micro_torch.py", "bench_coldstart_torch.py",
            "run_torch.py", "inference_serving_torch.py", "train_lm_torch.py",
            "bench_inference_torch.py"} <= names


def test_importing_the_paper_twins_loads_no_jax_or_repro():
    code = ("import sys\n"
            f"sys.path[:0] = [{str(REPO / 'examples')!r}, {str(REPO)!r}]\n"
            + "".join(f"import {m}\n" for m in TWINS + READERS)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def _twin(name: str):
    for d in (REPO / "examples", REPO):
        if str(d) not in sys.path:
            sys.path.insert(0, str(d))
    return importlib.import_module(name)


NO_CARD_CALLS = {   # twin: how its entry point is called by default
    "quickstart_torch": lambda m, out: m.main([]),
    "matmul_chained_torch": lambda m, out: m.main([]),
    "sgd_hogwild_torch": lambda m, out: m.main([]),
    "benchmarks.bench_sgd_training_torch": lambda m, out: m.main([]),
    "benchmarks.bench_matmul_torch": lambda m, out: m.main([]),
    "benchmarks.bench_dispatch_torch": lambda m, out: m.main(),
    "benchmarks.bench_micro_torch": lambda m, out: m.main([]),
    "benchmarks.bench_coldstart_torch": lambda m, out: m.main(out_dir=out),
    "benchmarks.run_torch": lambda m, out: m.main(["fig8"]),
}


@pytest.mark.parametrize("name", TWINS)
def test_paper_twins_raise_without_a_card(name, monkeypatch, tmp_path,
                                          capsys):
    """Each twin runs on the card by default: without one it raises the
    runtime's error before any row, and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _twin(name)
    try:
        NO_CARD_CALLS[name](mod, tmp_path)
    except (RuntimeError, SystemExit) as e:
        err = str(e) + capsys.readouterr().err
    else:
        pytest.fail(f"{name} ran without a card")
    assert "no CUDA device" in err
    out = capsys.readouterr().out.replace("name,us_per_call,derived", "")
    assert "," not in out and not any(tmp_path.iterdir())


def test_serve_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke"])                  # --device cuda by default
    with pytest.raises(ValueError, match="--device"):
        serve.main(["--smoke", "--device", "meta"])


def test_runtime_raises_without_a_card(monkeypatch):
    """The runtime and its state plane run on the card by default; the CPU
    only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaasmRuntime()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GlobalTier()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run_faasm_fanout(None, None, 8, 1)     # device="cuda" default
    rt = FaasmRuntime(n_hosts=1, device="cpu")
    try:
        assert rt.device.type == "cpu" and rt.global_tier.device == rt.device
        assert all(h.local_tier.device == rt.device
                   for h in rt.hosts.values())
    finally:
        rt.shutdown()


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a card — and from a directory holding only the script — it
    exits non-zero and prints no result."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes((REPO / "chip_smoke.py").read_bytes())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for script in (REPO / "chip_smoke.py", alone):
        r = subprocess.run([sys.executable, str(script)], env=env,
                           cwd=script.parent, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
