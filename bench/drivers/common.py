"""What every driver shares: the run's settings, the port's configuration
built from the cell's file, token rows drawn from the seed, the traced
window and the driver's outcome."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.harness import Cell, Check
from bench.yardstick.trace import WINDOW, Trace, reduce


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float                 # the process's start, ``time.perf_counter``


@dataclasses.dataclass
class Outcome:
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Check]
    memory_peak_bytes: int
    flops: float                    # model FLOPs of the window's work
    trace: Optional[Trace] = None
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)
    check_s: float = 0.0            # the reference's check after the window
    unit_s: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Window:
    outputs: list                   # what each unit returned
    unit_s: List[float]             # each unit's seconds
    t0: float                       # the first unit's start
    seconds: float                  # the first start to the last end
    next_unit: int


def window(device: torch.device, seconds: float, body, first: int) -> Window:
    """``body(unit)`` for unit = first, first + 1, ..., each ending in a
    synchronise, until ``seconds`` have passed since the first began."""
    outs, times = [], []
    sync(device)
    t0 = prev = now()
    unit = first
    while True:
        outs.append(body(unit))
        sync(device)
        t = now()
        times.append(t - prev)
        prev, unit = t, unit + 1
        if t - t0 >= seconds:
            break
    return Window(outs, times, t0, prev - t0, unit)


def port_config(c: Cell):
    """The port's configuration of the cell: its registry entry with every
    size of the cell's file."""
    from repro_torch.configs import get_config
    m = dict(c.model)
    family = m.pop("family")
    cfg = get_config(c.config["registry_id"]).with_overrides(**m)
    if cfg.family != family:
        raise ValueError(f"{c.config_name}: the port's {cfg.family!r} is not "
                         f"the file's {family!r}")
    return cfg


def port_params(cfg, weights: Dict[str, torch.Tensor], train: bool):
    """The port's parameter module over the benchmark's weights (the
    tensors themselves: every name must match, nothing is copied)."""
    from repro_torch.models.weights import params_class, trainable
    p = params_class(cfg)(cfg, device="meta")
    p.load_state_dict(weights, strict=True, assign=True)
    return trainable(p) if train else p


def token_rows(seed: int, unit: int, rows: int, length: int, vocab: int,
               repeat_p: float) -> np.ndarray:
    """(rows, length) int32 token ids of unit ``unit`` of seed ``seed``:
    uniform ids, each after the first repeating its left neighbour with
    probability ``repeat_p`` (so a model can learn the stream)."""
    rng = np.random.default_rng([seed % (1 << 64), unit])
    fresh = rng.integers(0, vocab, size=(rows, length))
    repeat = rng.random((rows, length)) < repeat_p
    repeat[:, 0] = False
    src = np.where(repeat, 0, np.arange(length)[None, :])
    src = np.maximum.accumulate(src, axis=1)
    return np.take_along_axis(fresh, src, axis=1).astype(np.int32)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    """A host span of the benchmark's own, seen in a trace."""
    return torch.profiler.record_function(f"bench.{name}")


def traced(device: torch.device, body, units: int) -> Trace:
    """``body(i)`` for i < ``units`` under the profiler, in one window that
    ends in a synchronise, reduced."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            for i in range(units):
                body(i)
            sync(device)
    return reduce(prof.events())


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def memory_peak(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" \
        else 0


def now() -> float:
    return time.perf_counter()


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 in the reference."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
