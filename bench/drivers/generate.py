"""Batch generation: back-to-back batches of greedy requests through the
port's captured serving loop (``ServeGraphs.generate``: one prefill
replay, then one decode replay a token).

Set-up draws the weights from the seed, builds the loop (its eager
warm-up and the two captures) and serves one batch.  The window serves
batches of fresh prompts until ``--seconds`` have passed.  After it the
program is freed and a sample of the window's requests, drawn from the
seed, is read by the plain reference's full forward over each prompt and
its served tokens: the widest gap by which a served token's logit lies
below the reference's best at its position (:func:`gaps`).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench.drivers.common import (Outcome, Run, free, memory_peak, no_tf32,
                                  now, port_config, port_params, span,
                                  token_rows, traced, window)
from bench.harness import Check
from bench.reference import model as ref
from bench.reference.weights import make_weights
from bench.yardstick import flops as yflops


def prompts(run: Run, unit: int) -> torch.Tensor:
    t = run.cell.traffic
    return torch.from_numpy(token_rows(
        run.seed, unit, t["batch"], t["prompt"], run.cell.model["vocab_size"],
        t["repeat_p"])).to(run.device)


class Program:
    """The port's serving loop on the seed's weights (the system under
    test); a call serves one batch and returns its ids (B, new_tokens)."""

    def __init__(self, run: Run) -> None:
        from repro_torch.launch.step_graphs import ServeGraphs
        from repro_torch.models import build_model
        t = run.cell.traffic
        self.run = run
        cfg = port_config(run.cell)
        self.model = build_model(cfg)
        self.params = port_params(cfg, make_weights(
            ref.param_specs(run.cell.model), run.seed, run.device),
            train=False)
        self.graphs = None
        if run.device.type == "cuda":
            self.graphs = ServeGraphs(self.model, self.params, t["batch"],
                                      t["prompt"],
                                      t["prompt"] + t["new_tokens"],
                                      run.device)

    def __call__(self, unit: int) -> torch.Tensor:
        from repro_torch.launch.step_graphs import eager_generate
        new = self.run.cell.traffic["new_tokens"]
        with span("prompts"):
            tokens = prompts(self.run, unit)
        with span("generate"):
            if self.graphs is not None:
                return self.graphs.generate(tokens, new).ids
            return eager_generate(self.model, self.params, tokens, new).ids

    def close(self) -> None:
        if self.graphs is not None:
            self.graphs.close()
        self.graphs = self.params = self.model = None


def sample(run: Run, units: List[int]) -> List[tuple]:
    """(unit, row) of the requests the check reads: drawn from the seed,
    one of them from the last batch served."""
    t = run.cell.traffic
    rng = np.random.default_rng([run.seed % (1 << 64), 1 << 30])
    k = t["sampled_requests"]
    picks = [(units[-1], int(rng.integers(t["batch"])))]
    while len(picks) < k:
        pick = (int(rng.choice(units)), int(rng.integers(t["batch"])))
        if pick not in picks:
            picks.append(pick)
    return picks


def sequences(run: Run, served: Dict[int, torch.Tensor], picks) -> tuple:
    """(each sampled prompt followed by its served tokens but the last,
    the served tokens (k, new))."""
    rows, ids = [], []
    for unit, row in picks:
        p = prompts(run, unit)[row]
        s = served[unit][row].to(run.device)
        rows.append(torch.cat([p, s[:-1].to(p.dtype)]))
        ids.append(s)
    return torch.stack(rows), torch.stack(ids).long()


def reference_logits(run: Run, seqs: torch.Tensor, prec: str = "bf16"):
    """The reference's logits at the positions that chose each served
    token: (k, new, V) f32."""
    t, m = run.cell.traffic, run.cell.model
    p = make_weights(ref.param_specs(m), run.seed, run.device)
    pos = torch.arange(t["prompt"] - 1, t["prompt"] + t["new_tokens"] - 1,
                       device=run.device)
    with no_tf32():
        out = ref.last_logits(p, m, seqs, pos, prec)
    del p
    free(run.device)
    return out


def gaps(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the best logit there."""
    return logits.max(-1).values - logits.gather(-1, ids[..., None])[..., 0]


def numbers(widest: float, at: tuple) -> Dict[str, tuple]:
    return {"logit_gap": (widest, f"request {at}")}


def _widest(g: torch.Tensor, picks) -> tuple:
    flat = int(torch.argmax(g))
    r, j = divmod(flat, g.shape[1])
    return float(g.max()), (picks[r], j)


def run(r: Run, program_cls=Program) -> Outcome:
    t, m = r.cell.traffic, r.cell.model
    prog = program_cls(r)
    prog(0)                                   # one batch served in set-up
    w = window(r.device, r.seconds, prog, 1)
    served = dict(enumerate(w.outputs, start=1))
    trace = (traced(r.device, lambda j: prog(w.next_unit + j), 1)
             if r.trace else None)
    peak = memory_peak(r.device)
    served = {u: ids.cpu() for u, ids in served.items()}
    prog.close()
    del prog
    free(r.device)
    tc = now()
    picks = sample(r, sorted(served))
    seqs, ids = sequences(r, served, picks)
    widest, at = _widest(gaps(reference_logits(r, seqs), ids.to(r.device)),
                         picks)
    nums = numbers(widest, at)
    batches = len(served)
    per_batch = yflops.prefill(m, t["batch"], t["prompt"]) + sum(
        yflops.decode(m, t["batch"], t["prompt"] + 1 + j)
        for j in range(t["new_tokens"] - 1))
    return Outcome(
        setup_s=w.t0 - r.t_start, window_s=w.seconds,
        attempted=batches * t["batch"], failed=0,
        end_to_end={"generate_tokens_per_s":
                    batches * t["batch"] * t["new_tokens"] / w.seconds},
        checks=[Check(k, nums[k][0], r.cell.limits[k]) for k in r.cell.limits],
        memory_peak_bytes=peak, flops=batches * per_batch, trace=trace,
        check_s=now() - tc, unit_s=w.unit_s)


def readings(r: Run, control: bool = False) -> Dict[str, tuple]:
    """The program's widest gap over a sample of two batches' requests or,
    with ``control``, that of the tokens the reference computed in float8
    puts first at each position of the same sequences."""
    prog = Program(r)
    served = {u: prog(u).cpu() for u in (1, 2)}
    prog.close()
    del prog
    free(r.device)
    picks = sample(r, sorted(served))
    seqs, ids = sequences(r, served, picks)
    want = reference_logits(r, seqs)
    if control:
        ids = reference_logits(r, seqs, "fp8").argmax(-1)
    return numbers(*_widest(gaps(want, ids.to(r.device)), picks))
