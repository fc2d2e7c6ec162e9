"""The Faaslet fan-out: a closed loop of waves of single-shot inference
requests through the port's Faasm runtime, each wave one parent's
scatter and gather.

Set-up draws the weights from the seed, starts ``FaasmRuntime`` (one
host of ``executors`` executors), creates the shared ``serve/stats``
vector, uploads the port's ``infer`` function (``make_infer_function``:
each call copies the model's leaves from pinned host memory into an
executor's slot and replays its captured forward, then adds its token to
``serve/stats`` and pushes the delta over the ``wire`` format), and
serves one wave to warm every executor.  The window then submits a wave
of ``wave`` requests with ``invoke_many``, waits for all of them with
``wait_all``, and submits the next, until ``--seconds`` have passed: the
load is the wave's ``wave`` requests in flight, and the rate is what the
runtime completes.  A request is timed from its wave's submission to
its settle.

After the window the runtime is shut down and every request's token is
read by the plain reference (the widest gap by which a served token's
logit lies below the reference's best), and ``serve/stats`` is held to
the counts of the tokens the runtime served.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

from bench.drivers.common import (Outcome, Run, free, memory_peak, no_tf32,
                                  now, port_config, span, token_rows, traced,
                                  window)
from bench.harness import Check
from bench.reference import model as ref
from bench.reference.weights import make_weights
from bench.yardstick import flops as yflops

_HIST = {"param_copy_ms": "faasm_serve_param_h2d_ms",
         "forward_ms": "faasm_serve_call_forward_ms",
         "stats_ms": "faasm_serve_call_stats_ms",
         "infer_ms": "faasm_serve_infer_ms"}
STATS = "serve/stats"


def prompts(run: Run, wave: int) -> np.ndarray:
    t = run.cell.traffic
    return token_rows(run.seed, wave, t["wave"], t["prompt"],
                      run.cell.model["vocab_size"], t["repeat_p"])


class Program:
    """The port's Faasm runtime serving ``infer`` over the seed's weights
    (the system under test); a call serves one wave and returns each
    request's (return code, latency s, token)."""

    def __init__(self, run: Run) -> None:
        from repro_torch.core import FaasmRuntime
        from repro_torch.launch.serve import HostLeaves, make_infer_function
        from repro_torch.models import build_model
        from repro_torch.state.ddo import VectorAsync
        t, m = run.cell.traffic, run.cell.model
        self.run = run
        cfg = port_config(run.cell)
        model = build_model(cfg)
        weights = make_weights(ref.param_specs(m), run.seed, run.device)
        leaves = HostLeaves(weights)             # copied to the host
        del weights
        free(run.device)
        self.rt = FaasmRuntime(n_hosts=1, capacity=t["executors"],
                               device=run.device)
        VectorAsync.create(self.rt.global_tier, STATS,
                           np.zeros(m["vocab_size"], np.float32))
        self.rt.upload(make_infer_function(
            model, leaves, prompt_len=t["prompt"], state_wire=t["wire"],
            device=self.rt.device))
        self.served: Dict[int, List[tuple]] = {}

    def submit(self, wave: int) -> List[int]:
        """The wave's requests, submitted in one ``invoke_many``."""
        with span("submit"):
            return self.rt.invoke_many(
                "infer", [r.tobytes() for r in prompts(self.run, wave)],
                state_hint=[STATS])

    def collect(self, wave: int, cids: List[int], t0: float) -> List[tuple]:
        """Wait for a wave's requests: (return code, seconds from the
        wave's submission at ``t0`` to the request's settle, token,
        seconds from its own submission to its settle) each."""
        with span("wait"):
            rcs = self.rt.wait_all(cids, timeout=600)
        out = []
        for c, rc in zip(cids, rcs):
            call = self.rt.call(c)
            tok = (int(np.frombuffer(call.output, np.int32)[0])
                   if rc == 0 and len(call.output) >= 4 else None)
            out.append((rc, call.t_end - t0, tok, call.latency))
        self.served[wave] = out
        return out

    def __call__(self, wave: int) -> List[tuple]:
        """One wave: submitted, then waited for."""
        t0 = now()
        return self.collect(wave, self.submit(wave), t0)

    def histograms(self) -> Dict[str, tuple]:
        out = {}
        for k, name in _HIST.items():
            h = self.rt.metrics.get(name)
            out[k] = (h.count, h.sum) if h is not None else (0, 0.0)
        return out

    def stats(self) -> np.ndarray:
        return np.frombuffer(self.rt.global_tier.get(STATS, host="main"),
                             np.float32).copy()

    def close(self) -> None:
        self.rt.shutdown()
        self.rt = None


def answered(run: Run, served: Dict[int, List[tuple]]) -> tuple:
    """(prompts (n, S), tokens (n,)) of every request the runtime served."""
    rows, toks = [], []
    for wave, out in sorted(served.items()):
        p = prompts(run, wave)
        for i, x in enumerate(out):
            if x[2] is not None:
                rows.append(p[i])
                toks.append(x[2])
    return (torch.from_numpy(np.stack(rows)).to(run.device),
            torch.tensor(toks, device=run.device))


def reference_logits(run: Run, seqs: torch.Tensor, prec: str = "bf16"):
    """The reference's f32 logits at the last position of each prompt."""
    m = run.cell.model
    p = make_weights(ref.param_specs(m), run.seed, run.device)
    last = torch.tensor([seqs.shape[1] - 1], device=run.device)
    with no_tf32():
        out = torch.cat([ref.last_logits(p, m, seqs[i:i + 256], last,
                                         prec)[:, 0]
                         for i in range(0, len(seqs), 256)])
    del p
    free(run.device)
    return out


def widest_gap(logits: torch.Tensor, toks: torch.Tensor) -> float:
    """How far below the best logit the worst token's logit lies."""
    return float((logits.max(-1).values
                  - logits.gather(-1, toks[:, None])[:, 0]).max())


def stats_gap(program_stats: np.ndarray, served) -> float:
    """The largest gap between ``serve/stats`` and the count of each token
    among the requests the runtime served."""
    counts = np.zeros_like(program_stats)
    for out in served.values():
        for x in out:
            if x[2] is not None:
                counts[x[2]] += 1
    return float(np.abs(program_stats - counts).max())


def p95(latencies_ms: List[float]) -> float:
    return statistics.quantiles(latencies_ms, n=20, method="inclusive")[18]


def run(r: Run, program_cls=Program) -> Outcome:
    t, m = r.cell.traffic, r.cell.model
    prog = program_cls(r)
    prog(0)                                   # a wave to warm each executor
    h0 = prog.histograms()
    w = window(r.device, r.seconds, prog, 1)
    h1 = prog.histograms()
    reqs = [x for out in w.outputs for x in out]
    trace = (traced(r.device, lambda j: prog(w.next_unit + j), 2)
             if r.trace else None)
    peak = memory_peak(r.device)
    stats = prog.stats()
    served = dict(prog.served)
    prog.close()
    del prog
    free(r.device)
    ok = [x for x in reqs if x[0] == 0]
    lat = [x[1] * 1e3 if x[0] == 0 else float("inf") for x in reqs]
    tc = now()
    seqs, toks = answered(r, served)
    nums = {"logit_gap": widest_gap(reference_logits(r, seqs), toks),
            "stats_gap": stats_gap(stats, served)}
    calls = {k: (h1[k][0] - h0[k][0], h1[k][1] - h0[k][1]) for k in h1}
    extra = {k: s / n for k, (n, s) in calls.items() if n}
    if "infer_ms" in extra and ok:
        extra["queue_wait_ms"] = (statistics.fmean(x[3] for x in ok) * 1e3
                                  - extra["infer_ms"])
    return Outcome(
        setup_s=w.t0 - r.t_start, window_s=w.seconds, attempted=len(reqs),
        failed=len(reqs) - len(ok),
        end_to_end={"fanout_req_per_s": len(ok) / w.seconds,
                    "fanout_p95_ms": p95(lat)},
        checks=[Check(k, nums[k], r.cell.limits[k]) for k in r.cell.limits],
        memory_peak_bytes=peak,
        flops=len(ok) * yflops.forward(m, 1, t["prompt"]), trace=trace,
        extra=extra, check_s=now() - tc, unit_s=w.unit_s)


def readings(r: Run, control: bool = False) -> Dict[str, tuple]:
    """The widest gap over three waves' tokens, or with ``control`` that of
    the tokens the reference computed in float8 puts first at the same
    prompts; and the program's ``serve/stats`` gap."""
    prog = Program(r)
    for w in range(3):
        prog(w)
    stats, served = prog.stats(), dict(prog.served)
    prog.close()
    del prog
    free(r.device)
    seqs, toks = answered(r, served)
    want = reference_logits(r, seqs)
    if control:
        toks = reference_logits(r, seqs, "fp8").argmax(-1)
    return {"logit_gap": (widest_gap(want, toks), "three waves"),
            "stats_gap": (stats_gap(stats, served), "serve/stats")}
