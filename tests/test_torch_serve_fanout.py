"""The serving launcher's Faasm fan-out, port against the JAX package.

Both packages' runtimes serve the same prompts (``default_rng(0)``, as the
launcher draws them) with the same smoke-model weights (the JAX tree, loaded
by ``weights.from_jax_params``) through their ``infer`` functions, with the
shared ``serve/stats`` vector on the int8 wire.  The vocabulary is widened
to 1,280 so that the stats vector (5,120 bytes) is above the int8 wire's
4,096-byte floor; at the smoke vocabulary (257) it would ride the exact
wire.  Tokens agree in at least 90% of the requests (bf16 near-ties may
flip).  The port's final stats equal the histogram of its own tokens within
the int8 bound, absmax/127·1.01 per push.  The reference is held to what it
guarantees: it never adds a count, and it may lose a few whole ones, since
its window-miss refresh full-pulls over HOGWILD adds not yet pushed (ROADMAP
"Faults found in the port": the lost update on a window-miss refresh).
"""
import re

import jax
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke_config
from repro.core import FaasmRuntime as JaxRuntime
from repro.launch.serve import make_infer_function as jax_infer_function
from repro.models import ExecConfig as JaxExecConfig
from repro.models import build_model as jax_build_model
from repro.state.ddo import VectorAsync as JaxVectorAsync
from repro_torch.configs import smoke_config
from repro_torch.core import FaasmRuntime
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.weights import from_jax_params
from repro_torch.state.ddo import VectorAsync

ARCH, VOCAB, PROMPT, REQUESTS = "qwen1.5-0.5b", 1280, 16, 24
MIN_AGREEMENT = 0.9
REFERENCE_LOST_COUNTS = 3     # whole counts the reference may drop


def _serve(runtime, vector, fdef, payloads):
    """Run ``payloads`` through ``infer``: (tokens, final serve/stats)."""
    rt = runtime(n_hosts=1, capacity=4)
    try:
        vector.create(rt.global_tier, "serve/stats",
                      np.zeros(VOCAB, np.float32))
        rt.upload(fdef)
        cids = rt.invoke_many("infer", payloads, state_hint=["serve/stats"])
        assert rt.wait_all(cids, timeout=300) == [0] * len(payloads)
        tokens = [int(np.frombuffer(rt.output(c), np.int32)[0]) for c in cids]
        stats = np.frombuffer(rt.global_tier.get("serve/stats", host="x"),
                              np.float32).copy()
        return tokens, stats
    finally:
        rt.shutdown()


def _int8_bound(pushes: int) -> float:
    return pushes * 1.0 / 127 * 1.01      # each push adds one +1


@pytest.fixture(scope="module")
def both():
    jcfg = jax_smoke_config(ARCH).with_overrides(vocab_size=VOCAB)
    tcfg = smoke_config(ARCH).with_overrides(vocab_size=VOCAB)
    jmodel = jax_build_model(jcfg, JaxExecConfig(backend="xla"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten(jparams)
    payloads = serve.fanout_payloads(VOCAB, REQUESTS, PROMPT)
    want = _serve(JaxRuntime, JaxVectorAsync,
                  jax_infer_function(jmodel, treedef,
                                     [np.asarray(x) for x in flat],
                                     prompt_len=PROMPT, state_wire="int8"),
                  payloads)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tmodel = build_model(tcfg)
    got = _serve(lambda **kw: FaasmRuntime(**kw, device="cpu"), VectorAsync,
                 serve.make_infer_function(tmodel, serve.host_leaves(params),
                                           prompt_len=PROMPT,
                                           state_wire="int8", device="cpu"),
                 payloads)
    return want, got, tmodel, params


def test_tokens_agree_with_jax(both):
    (jtok, _), (ttok, _), _, _ = both
    agree = np.mean(np.asarray(jtok) == np.asarray(ttok))
    assert agree >= MIN_AGREEMENT, (agree, jtok, ttok)


@pytest.mark.parametrize("which", ["repro", "repro_torch"])
def test_stats_equal_the_token_histogram(both, which):
    tokens, stats = both[0] if which == "repro" else both[1]
    hist = np.bincount(tokens, minlength=VOCAB).astype(np.float32)
    bound = _int8_bound(len(tokens))
    if which == "repro_torch":
        assert np.abs(stats - hist).max() <= bound
        assert stats.sum() == pytest.approx(len(tokens), abs=_int8_bound(1))
        return
    assert (stats <= hist + bound).all()              # no count is created
    lost = hist - stats
    assert np.abs(lost - np.round(lost)).max() <= bound   # lost ones are whole
    assert len(tokens) - stats.sum() <= REFERENCE_LOST_COUNTS + _int8_bound(1)


def test_run_faasm_fanout_reports_tokens_and_stats(both):
    """The port's fan-out dict: the reference's keys, plus each request's
    token (the same as ``infer`` gives for its prompt), the warm-up wave's
    and the final global stats."""
    _, (ttok, _), tmodel, params = both
    r = serve.run_faasm_fanout(tmodel, params, VOCAB, REQUESTS,
                               prompt_len=PROMPT, capacity=4,
                               state_wire="int8", device="cpu")
    for key in ("requests", "wall_s", "throughput_rps", "p50_ms", "p99_ms",
                "degraded", "shed", "deadline_expired", "state_wire",
                "state_push_mb"):
        assert key in r
    assert r["requests"] == REQUESTS and not r["degraded"]
    assert r["tokens"] == ttok and r["warm_tokens"] == ttok[:4]
    hist = np.bincount(r["tokens"] + r["warm_tokens"],
                       minlength=VOCAB).astype(np.float32)
    assert np.abs(r["stats"] - hist).max() <= _int8_bound(REQUESTS + 4)
    assert 0 < r["state_push_mb"] < REQUESTS * VOCAB * 4 / 1e6 * 0.3
    assert 0 < r["param_h2d_ms"] < r["infer_ms"]


def test_serve_main_fans_out_on_the_cpu(capsys):
    res = serve.main(["--smoke", "--new-tokens", "2", "--faasm-requests",
                      "16", "--state-wire", "int8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"faasm fan-out: 16 reqs in [\d.]+s \([\d.]+ req/s\) "
                     r"p50=[\d.]+ms p99=[\d.]+ms", out), out
    assert re.search(r"serve/stats pushes \(int8 wire\): [\d.]+MB", out), out
    r = res["faasm"]
    assert all(t is not None for t in r["tokens"])
    hist = np.bincount(r["tokens"] + r["warm_tokens"],
                       minlength=res["cfg"].vocab_size)
    # 257 floats are below the int8 floor: the stats ride the exact wire
    np.testing.assert_array_equal(r["stats"], hist.astype(np.float32))
