"""What the benchmark finds by name: the cells, configurations, traffic
mixes, limits and per-layer readers of ``BENCHMARK.json``, and the
result line.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration is ``configs/<config>.json`` (its ``file`` in
``BENCHMARK.json``), the mix ``traffic/<traffic>.json``, whose
``driver`` names the module of ``drivers/`` that runs it, the limits of
the cell's output checks ``limits/<cell>.json``, and each per-layer
metric a reader ``metrics/<metric>.py`` with a ``read(ctx)`` that returns
the number, or None where the trace holds nothing for it.  So a cell, a
mix or a metric is added by adding files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# top-level modules that may not be loaded in a run: JAX and the JAX
# package (compared whole: the port's name starts with the package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict                  # the configuration's file
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict]        # the cell's end-to-end metrics
    per_layer: List[dict]         # the cell's per-layer metrics

    @property
    def model(self) -> dict:
        return self.config["model"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with every file it names, loaded."""
    w = {x["name"]: x for x in bench["workloads"]}.get(name)
    if w is None:
        raise KeyError(f"no workload {name!r}; the cells are "
                       f"{', '.join(x['name'] for x in bench['workloads'])}")
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if (
        name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=name, chips=w["chips"], config_name=w["config"],
                config=_json(root / cfg["file"]), traffic_name=w["traffic"],
                traffic=_json(root / "bench" / "traffic"
                              / f"{w['traffic']}.json"),
                limits=_json(root / "bench" / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def driver(c: Cell):
    return importlib.import_module(f"bench.drivers.{c.traffic['driver']}")


def reader(metric: str, root: Path = ROOT):
    """The module ``metrics/<metric>.py`` (its name may hold dots)."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path.relative_to(root)}")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def result_line(*, checks: List[Check], attempted: int, failed: int,
                metrics: Dict[str, dict], device: Dict[str, Any],
                breakdown: Optional[dict] = None) -> dict:
    """The last line's object; ``checks`` comes last, each number compared
    beside its limit."""
    out = {"correct": bool(checks) and all(c.ok for c in checks),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return out
