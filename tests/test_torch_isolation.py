"""The port stands alone: it imports nothing of JAX or of ``repro``, and its
entry point runs on the card unless the CPU is asked for."""
import ast
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
    [REPO / "chip_smoke.py"]
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
