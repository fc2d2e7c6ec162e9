"""``BENCHMARK.json`` against the benchmark's contract, the files each cell
names found by name, the result line's shape, and no module the
benchmark runs importing JAX or the JAX package."""
import ast
import json
import os
import subprocess
import sys

import pytest

from bench import harness
from bench.harness import BENCH, NAME, ROOT, UNIT

TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
METRIC = {"name", "unit", "better", "bound", "source"}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_benchmark_json_has_the_contract_keys(bench):
    assert set(bench) == TOP
    assert bench["command"] == ["python3", "bench/run.py"]
    assert bench["paths"] == ["bench"]
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_names_and_units_keep_to_the_contract(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    names += [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
    names += [r for c in bench["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for k in ("end_to_end", "per_layer"):
        assert all(UNIT.match(m["unit"]) for m in bench[k])
        assert all(m["better"] in ("lower", "higher") for m in bench[k])
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in bench[k]]
        assert len(got) == len(set(got)), k
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_finds_its_files_by_name(bench):
    used = set()
    for w in bench["workloads"]:
        c = harness.cell(bench, w["name"])
        used.add(c.config_name)
        assert c.config["registry_id"] and c.config["source"]
        assert c.config["reduced"] == \
            {x["name"]: x for x in bench["configs"]}[c.config_name]["reduced"]
        assert (BENCH / "drivers" / f"{c.traffic['driver']}.py").is_file()
        assert hasattr(harness.driver(c), "run")
        assert c.limits and all(v > 0 for v in c.limits.values())
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in names
            assert hasattr(harness.reader(m["name"]), "read")
    assert used == {c["name"] for c in bench["configs"]}


def test_per_layer_metrics_name_layers_alike(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)
    moves = {m["name"] for m in bench["end_to_end"]}
    assert all(m["moves"] in moves for m in bench["per_layer"])


def test_the_result_line_has_its_keys_and_the_checks_last():
    checks = [harness.Check("loss_gap", 1e-5, 1e-3),
              harness.Check("grad_norm_gap", float("nan"), 1e-2)]
    line = harness.result_line(
        checks=checks, attempted=7, failed=0,
        metrics={"setup_s": {"value": 31.5, "unit": "s"}},
        device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                "count": 1, "memory_peak_bytes": 1},
        breakdown={"device_ops": [], "idle_gaps": []})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["correct"] is False                 # a NaN never passes
    assert line["checks"]["loss_gap"] == {"value": 1e-5, "limit": 1e-3}
    json.dumps(line)
    assert harness.result_line(checks=checks[:1], attempted=1, failed=0,
                               metrics={}, device={})["correct"] is True


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models",
                                      "jaxtyping", "bench.run"]) == []
    assert harness.forbidden_modules(["repro.core", "jax", "jaxlib.xla",
                                      "flax.linen"]) == \
        ["flax.linen", "jax", "jaxlib.xla", "repro.core"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    found = {}
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        bad = [m for m in _imports(path)
               if m.split(".", 1)[0] in harness.FORBIDDEN + ("benchmarks",)]
        if bad:
            found[str(path)] = bad
    assert not found


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "granite-3-8b.train", "--seed", "2147483659",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "card" in p.stderr
