"""Training traffic: whole SGD steps of the port's train step, back to
back.

Set-up builds one object, the port's ``make_train_step`` over the
configuration (captured as a CUDA graph by ``GraphedTrainStep`` on the
card), on weights the benchmark draws from the seed, and drives it
through its first ``checked_steps`` steps on rows that all differ, each
batch drawn on the host and copied in as the launcher does.  The window
then runs further steps of that same object until ``--seconds`` have
passed, each ending in a synchronise.  After the window the program is
freed and the plain reference follows the first steps from the same
weights and batches (:func:`reference_readings`); the two are compared
by :func:`checks`.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Optional

import torch

from bench.drivers.common import (Outcome, Run, free, memory_peak, no_tf32,
                                  now, port_config, port_params, span,
                                  token_rows, traced, window)
from bench.harness import Check
from bench.reference import model as ref
from bench.reference.weights import iter_weights, make_weights
from bench.yardstick import flops as yflops

GRAD_FLOOR = 1e-3       # leaves under this share of the median gradient


@dataclasses.dataclass
class Readings:
    losses: List[float]
    grad_norms: List[float]
    change1: Dict[str, float]        # per leaf |p1 - p0|
    change3: Dict[str, float]        # per leaf |p_n - p0| after the n steps
    grad1: Optional[Dict[str, float]] = None   # per leaf |g1| (reference)


def batch(run: Run, unit: int) -> Dict[str, torch.Tensor]:
    """Unit ``unit``'s batch (tokens, targets, mask), drawn on the host and
    copied to the device."""
    t, m = run.cell.traffic, run.cell.model
    rows = token_rows(run.seed, unit, t["batch"], t["seq"] + 1,
                      m["vocab_size"], t["repeat_p"])
    host = {"tokens": rows[:, :-1], "targets": rows[:, 1:],
            "mask": torch.ones(rows[:, 1:].shape, dtype=torch.float32)}
    return {k: (torch.from_numpy(v.copy()) if not isinstance(v, torch.Tensor)
                else v).to(run.device) for k, v in host.items()}


@torch.no_grad()
def changes(params: Dict[str, torch.Tensor], run: Run) -> Dict[str, float]:
    """|p - p0| of every leaf, p0 the seed's weights drawn again."""
    specs = ref.param_specs(run.cell.model)
    norms = {}
    for name, p0 in iter_weights(specs, run.seed, run.device):
        norms[name] = torch.linalg.vector_norm(
            params[name].float() - p0.float())
    vals = torch.stack(list(norms.values())).tolist()
    return dict(zip(norms, vals))


class Program:
    """The port's train step on the seed's weights (the system under test)."""

    def __init__(self, run: Run) -> None:
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch.steps import make_train_step
        from repro_torch.launch.train_graphs import GraphedTrainStep
        from repro_torch.models import ExecConfig, build_model
        from repro_torch.optim import SGD
        t = run.cell.traffic
        self.run = run
        cfg = port_config(run.cell)
        model = build_model(cfg, ExecConfig(remat=t["remat"],
                                            loss_chunk=t["loss_chunk"]))
        opt = SGD(lr=t["lr"])
        weights = make_weights(ref.param_specs(run.cell.model), run.seed,
                               run.device)
        self.params = port_params(cfg, weights, train=True)
        self.state = opt.init(self.params)
        step = make_train_step(model, opt, ShapeConfig(
            "bench_train", "train", t["seq"], t["batch"]))
        self.step = (GraphedTrainStep(step, run.device)
                     if run.device.type == "cuda" else step)

    def __call__(self, unit: int) -> dict:
        with span("batch"):
            b = batch(self.run, unit)
        with span("step"):
            self.params, self.state, out = self.step(self.params, self.state,
                                                     b)
        return out

    def named(self) -> Dict[str, torch.Tensor]:
        return dict(self.params.named_parameters())

    def first_steps(self, n: int) -> Readings:
        """Steps 0 .. n-1 (the warm-up, the capture and replays)."""
        outs, change1 = [], None
        for i in range(n):
            outs.append(self(i))
            if i == 0:
                change1 = changes(self.named(), self.run)
        change3 = changes(self.named(), self.run)
        return Readings([float(o["loss"]) for o in outs],
                        [float(o["grad_norm"]) for o in outs],
                        change1, change3)

    def close(self) -> None:
        if hasattr(self.step, "close"):
            self.step.close()
        self.step = self.params = self.state = None


def reference_readings(run: Run, n: int, prec: str = "bf16",
                       rows: Optional[int] = None) -> Readings:
    """The plain reference over the same weights and first ``n`` batches
    (their first ``rows`` rows if given): the loss and gradient norm of
    each step, each leaf's change after one and after ``n`` steps, and
    each leaf's first gradient."""
    m, lr = run.cell.model, run.cell.traffic["lr"]
    p = make_weights(ref.param_specs(m), run.seed, run.device)
    losses, gnorms, change1, grad1 = [], [], None, None
    for i in range(n):
        b = {k: v[:rows] for k, v in batch(run, i).items()}
        with no_tf32():
            value, grads = ref.train_step(p, m, b, lr, prec)
        g = {k: torch.linalg.vector_norm(v.float()) for k, v in grads.items()}
        gn = torch.linalg.vector_norm(torch.stack(list(g.values())))
        losses.append(float(value))
        gnorms.append(float(gn))
        if i == 0:
            grad1 = dict(zip(g, torch.stack(list(g.values())).tolist()))
            change1 = changes(p, run)
        del grads, g
    out = Readings(losses, gnorms, change1, changes(p, run), grad1)
    del p
    free(run.device)
    return out


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float],
               kept) -> Dict[str, float]:
    """The gap of norms of each kept leaf, against the larger of its own
    and the median leaf's reference norm."""
    med = statistics.median(want[n] for n in kept)
    return {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in kept}


def _worst_leaf(gaps: Dict[str, float]) -> tuple:
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def numbers(got: Readings, want: Readings) -> Dict[str, tuple]:
    """Each number compared: name -> (value, what it was read at)."""
    gmed = statistics.median(want.grad1.values())
    kept = [n for n, g in want.grad1.items() if g >= GRAD_FLOOR * gmed]
    out = {}
    loss = [abs(a - b) / abs(b) for a, b in zip(got.losses, want.losses)]
    gn = [abs(a - b) / b for a, b in zip(got.grad_norms, want.grad_norms)]
    out["loss_gap"] = (max(loss) if all(map(math.isfinite, got.losses))
                       else float("inf"), f"step {loss.index(max(loss))}")
    out["grad_norm_gap"] = (max(gn) if all(map(math.isfinite, got.grad_norms))
                            else float("inf"), f"step {gn.index(max(gn))}")
    out["change1_gap"] = _worst_leaf(_leaf_gaps(got.change1, want.change1,
                                                kept))
    last = _leaf_gaps(got.change3, want.change3, kept)
    out["change3_gap"] = _worst_leaf(last)
    out["change3_median_gap"] = (statistics.median(last.values()),
                                 f"median of {len(last)} leaves")
    return out


def checks(got: Readings, want: Readings, limits: dict) -> List[Check]:
    nums = numbers(got, want)
    return [Check(k, nums[k][0], limits[k]) for k in limits]


def run(r: Run, program_cls=Program) -> Outcome:
    t, m = r.cell.traffic, r.cell.model
    n_checked = t["checked_steps"]
    prog = program_cls(r)
    first = prog.first_steps(n_checked)
    w = window(r.device, r.seconds, lambda u: prog(u)["loss"], n_checked)
    steps = len(w.outputs)
    trace = (traced(r.device, lambda j: prog(w.next_unit + j), 2)
             if r.trace else None)
    peak = memory_peak(r.device)
    failed = sum(1 for x in w.outputs if not math.isfinite(float(x)))
    prog.close()
    del prog
    free(r.device)
    tc = now()
    want = reference_readings(r, n_checked)
    checked = checks(first, want, r.cell.limits)
    tokens = steps * t["batch"] * t["seq"]
    return Outcome(
        setup_s=w.t0 - r.t_start, window_s=w.seconds, attempted=steps,
        failed=failed, end_to_end={"train_tokens_per_s": tokens / w.seconds},
        checks=checked, memory_peak_bytes=peak,
        flops=steps * yflops.train_step(m, t["batch"], t["seq"]),
        trace=trace, check_s=now() - tc, unit_s=w.unit_s)


def readings(r: Run, control: bool = False,
             fault: Optional[str] = None) -> Dict[str, tuple]:
    """The numbers :func:`checks` compares for seed ``r.seed``: the
    program's first steps against the reference's, or with ``control``
    the reference computed in float8 in the program's place, or with
    ``fault="half_batch"`` the reference over half of each batch's rows
    in the program's place."""
    n = r.cell.traffic["checked_steps"]
    if fault == "half_batch":
        got = reference_readings(r, n, rows=r.cell.traffic["batch"] // 2)
    elif control:
        got = reference_readings(r, n, "fp8")
    else:
        prog = Program(r)
        got = prog.first_steps(n)
        prog.close()
        del prog
        free(r.device)
    return numbers(got, reference_readings(r, n))
