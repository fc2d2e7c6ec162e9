"""Each cell's output check against faults of the timed path and against
its control, driven on the CPU at smoke sizes.

A run here skips the look for a card and drives the rest of a cell's run
(set-up, window, the check against the plain reference) through the
cell's own driver and limits, with the timed path broken underneath:
``correct`` must come out false, and the number the fault breaks must
read far above a sound run's.  The control (the reference computed in
float8 in the program's place) must read well above the program at the
same size on at least one number.  The hybrid family's training and the
fan-out's driver, which no cell runs yet, are driven on smoke cells made
here: the port's zamba2-1.2b registry shape under the train mix, and the
granite configuration under the fan-out mix.
"""
import copy
import dataclasses
import json
import time

import pytest
import torch

from bench import harness
from bench.drivers import fanout, generate, train
from bench.drivers.common import Run
from bench.harness import BENCH, Check
from bench.tests.shapes import source

SMOKE = {
    "granite-3-8b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=257),
    "zamba2-1.2b": dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                        head_dim=16, d_ff=128, vocab_size=257, ssm_state=16,
                        ssm_headdim=16, ssm_chunk=16, attn_every=2),
}
TRAFFIC = {"train": dict(batch=4, seq=64, loss_chunk=16),
           "generate": dict(batch=4, prompt=16, new_tokens=8,
                            sampled_requests=3),
           "fanout": dict(wave=8, executors=2)}
TRAIN = ["granite-3-8b.train", "zamba2-1.2b.train"]
# smoke cells of what no cell of BENCHMARK.json runs: (configuration,
# traffic mix, the limits the cell's checks would read)
UNLISTED = {"zamba2-1.2b.train": ("zamba2-1.2b", "train",
                                  "granite-3-8b.train"),
            "granite-3-8b.fanout": ("granite-3-8b", "fanout",
                                    {"logit_gap": 0.4, "stats_gap": 0.5})}


def _cell(name: str) -> harness.Cell:
    bench = harness.load_benchmark()
    if name not in UNLISTED:
        return harness.cell(bench, name)
    config, traffic, limits = UNLISTED[name]
    if isinstance(limits, str):
        limits = harness.cell(bench, limits).limits
    return harness.Cell(
        name=name, chips=1, config_name=config, config=source(config),
        traffic_name=traffic,
        traffic=json.loads((BENCH / "traffic" / f"{traffic}.json")
                           .read_text()),
        limits=limits, end_to_end=[], per_layer=[])


def smoke_run(name: str, seed: int = 2 ** 31 + 11) -> Run:
    c = dataclasses.replace(_cell(name))
    c.config = copy.deepcopy(c.config)
    c.config["model"].update(SMOKE[c.config_name])
    c.traffic = dict(c.traffic, **TRAFFIC[c.traffic_name])
    return Run(cell=c, seed=seed, seconds=0.2, trace=False,
               device=torch.device("cpu"), t_start=time.perf_counter())


def values(out) -> dict:
    return {c.name: c.value for c in out.checks}


def correct(out) -> bool:
    return harness.result_line(checks=out.checks, attempted=out.attempted,
                               failed=out.failed, metrics={},
                               device={})["correct"]


@pytest.fixture(scope="module", params=TRAIN)
def sound_train(request):
    r = smoke_run(request.param)
    return r, values(train.run(r))


def test_train_step_that_leaves_its_state_unchanged_fails(sound_train,
                                                          monkeypatch):
    from repro_torch.optim import sgd
    r, sound = sound_train
    monkeypatch.setattr(sgd.SGD, "update",
                        lambda self, grads, state, params: (params, state))
    out = train.run(smoke_run(r.cell.name))
    got = values(out)
    assert not correct(out)
    assert got["change3_median_gap"] > 0.5      # nothing moved
    assert got["change3_median_gap"] > 10 * sound["change3_median_gap"]


def test_train_step_that_drops_half_the_batch_fails(sound_train,
                                                    monkeypatch):
    from repro_torch.models.model import Model
    r, sound = sound_train
    loss = Model.loss

    def half(self, params, batch):
        rows = batch["tokens"].shape[0] // 2
        return loss(self, params, {k: v[:rows] for k, v in batch.items()})

    monkeypatch.setattr(Model, "loss", half)
    out = train.run(smoke_run(r.cell.name))
    got = values(out)
    assert not correct(out)
    assert got["grad_norm_gap"] > 10 * sound["grad_norm_gap"]


@pytest.mark.parametrize("name", TRAIN)
def test_train_control_reads_above_the_program(name):
    r = smoke_run(name)
    n = r.cell.traffic["checked_steps"]
    want = train.reference_readings(r, n)
    prog = train.Program(r)
    got = train.numbers(prog.first_steps(n), want)
    ctl = train.numbers(train.reference_readings(r, n, "fp8"), want)
    assert any(ctl[k][0] > 3 * got[k][0] for k in r.cell.limits), (got, ctl)


def _altered(call):
    """``call`` with the first token of each answer changed."""
    def wrapped(self, unit):
        out = call(self, unit)
        if isinstance(out, torch.Tensor):
            out = out.clone()
            out[:, 0] = (out[:, 0] + 1) % self.run.cell.model["vocab_size"]
            return out
        V = self.run.cell.model["vocab_size"]
        return [x[:2] + (None if x[2] is None else (x[2] + 1) % V,) + x[3:]
                for x in out]
    return wrapped


def test_generation_with_an_altered_token_fails(monkeypatch):
    r = smoke_run("granite-3-8b.generate")
    sound = values(generate.run(r))
    monkeypatch.setattr(generate.Program, "__call__",
                        _altered(generate.Program.__call__))
    out = generate.run(smoke_run("granite-3-8b.generate"))
    assert not correct(out)
    assert values(out)["logit_gap"] > 10 * max(sound["logit_gap"], 1e-3)


def test_generation_control_reads_above_the_program():
    r = smoke_run("granite-3-8b.generate")
    got = generate.readings(r)["logit_gap"][0]
    ctl = generate.readings(r, control=True)["logit_gap"][0]
    assert ctl > 3 * got and ctl > 0


def test_fanout_with_an_altered_token_fails(monkeypatch):
    r = smoke_run("granite-3-8b.fanout")
    sound = values(fanout.run(r))
    collect = fanout.Program.collect

    def altered(self, wave, cids, t0):
        out = _altered(lambda p, w: collect(p, w, cids, t0))(self, wave)
        self.served[wave] = out
        return out

    monkeypatch.setattr(fanout.Program, "collect", altered)
    out = fanout.run(smoke_run("granite-3-8b.fanout"))
    got = values(out)
    assert not correct(out)
    assert got["logit_gap"] > 10 * max(sound["logit_gap"], 1e-3)
    assert got["stats_gap"] >= 1.0


def test_fanout_control_reads_above_the_program():
    r = smoke_run("granite-3-8b.fanout")
    got = fanout.readings(r)["logit_gap"][0]
    ctl = fanout.readings(r, control=True)["logit_gap"][0]
    assert ctl > 3 * got and ctl > 0


def test_a_check_fails_on_nan():
    assert not Check("loss_gap", float("nan"), 1.0).ok
