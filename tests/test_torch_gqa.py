"""The grouped-query decoders of the registry against the JAX package.

qwen3-4b (per-head q/k RMSNorm), granite-3-8b (GQA, RMSNorm, gated SiLU),
starcoder2-7b (LayerNorm with a bias, biased tanh-GELU MLP, QKV and
output biases, an untied unembedding) and kimi-k2 (MoE with one shared
expert and a first dense layer) run in both packages on the CPU at their
smoke configs, with the same weights: the JAX model's parameter tree with
every bias and norm scale perturbed (seeded numpy draws), so that a
missing, misplaced or mistyped bias or scale shows (``init_params`` makes
them zeros and ones in both packages, and there none would).  starcoder2's
smoke config has 4 query heads over 1 KV head; its full config has 9 per
KV head, so it also runs with 18 over 2 (``-g9``).

Tolerances: f32 1e-4 with identical token ids; bf16 5e-2, teacher-forced
with the JAX tokens (the tolerance of ``test_arch_smoke``).  kimi-k2's
bf16 run also excuses the rows a routing flip can reach, as
``test_torch_moe`` does, with the JAX side jitted and its routing read
through an ordered ``jax.debug.callback``.  The loss and every gradient
leaf of qwen3-4b and starcoder2-7b are held against
``jax.value_and_grad`` of the reference at the same tolerances.
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.data import PipelineConfig, make_batch
from repro.models import ExecConfig as JaxExecConfig
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro_torch.configs import ShapeConfig, get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.models import ExecConfig, build_model
from repro_torch.models import moe
from repro_torch.models.weights import (Bits, from_jax_params, init_params,
                                         jax_leaf, params_class,
                                         to_jax_params, trainable)

QWEN3, GRANITE, STARCODER, KIMI = ("qwen3-4b", "granite-3-8b",
                                   "starcoder2-7b", "kimi-k2-1t-a32b")
ARCHS = (QWEN3, GRANITE, STARCODER, KIMI)
G9 = "starcoder2-7b-g9"            # 18 query heads over 2 KV heads: G 9
VARIANTS = ARCHS[:3] + (G9, KIMI)
B, S, STEPS = 2, 16, 4
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# leaves that init draws as zeros (biases) or ones (norm scales)
PERTURBED = {"bq", "bk", "bv", "bo", "b_up", "b_down", "bias",
             "scale", "q_norm", "k_norm"}


def _arch(variant):
    return STARCODER if variant == G9 else variant


def _cfgs(variant, dtype):
    kw = dict(dtype=dtype, param_dtype=dtype)
    if variant == G9:
        kw.update(n_heads=18, n_kv_heads=2)
    arch = _arch(variant)
    return (jax_smoke_config(arch).with_overrides(**kw),
            smoke_config(arch).with_overrides(**kw))


def _perturb(tree, rng):
    """Every bias and norm scale of the JAX tree replaced by a seeded draw
    (biases 0.1·N(0, 1), scales 1 + 0.1·N(0, 1)), in the leaf's dtype."""
    if isinstance(tree, list):
        return [_perturb(t, rng) for t in tree]
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out[k] = _perturb(v, rng)
        elif k in PERTURBED:
            a = np.asarray(v)
            draw = 0.1 * rng.standard_normal(a.shape)
            out[k] = ((1.0 if k in ("scale", "q_norm", "k_norm") else 0.0)
                      + draw).astype(a.dtype)
        else:
            out[k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _params(variant, dtype, seed=0):
    """The JAX model and its perturbed tree (numpy leaves), and the port's
    model on the same values; kept for the tests that read the same ones
    (none writes them)."""
    jcfg, tcfg = _cfgs(variant, dtype)
    jmodel = jax_build_model(jcfg, JaxExecConfig(backend="xla"))
    tree = _perturb(jax.tree.map(np.asarray,
                                 jmodel.init(jax.random.PRNGKey(seed))),
                    np.random.default_rng(seed + 100))
    return jmodel, tree, tcfg, from_jax_params(tree, tcfg, "cpu")


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _run_jax(model, params, tokens, teacher=None):
    logits = model.logits(params, tokens)
    cache = model.init_cache(B, S + STEPS)
    step_logits, cache, n = model.prefill(params, tokens, cache)
    out = [np.asarray(step_logits, np.float32)]
    toks = [np.asarray(jnp.argmax(step_logits, -1)).astype(np.int32)]
    decode = jax.jit(model.decode_step)
    for i in range(STEPS):
        tok = toks[-1] if teacher is None else teacher[:, i]
        step_logits, cache = decode(params, jnp.asarray(tok), cache,
                                    jnp.full((B,), n + i, jnp.int32))
        out.append(np.asarray(step_logits, np.float32))
        toks.append(np.asarray(jnp.argmax(step_logits, -1)).astype(np.int32))
    return np.asarray(logits, np.float32), out, np.stack(toks, 1)


@torch.no_grad()
def _run_port(cfg, params, tokens, teacher=None):
    model = build_model(cfg, ExecConfig())
    t = torch.from_numpy(np.asarray(tokens))
    logits = model.logits(params, t)
    cache = model.init_cache(B, S + STEPS, "cpu")
    step_logits, cache, n = model.prefill(params, t, cache)
    out = [step_logits.numpy()]
    toks = [step_logits.argmax(-1).to(torch.int32)]
    for i in range(STEPS):
        tok = toks[-1] if teacher is None else torch.from_numpy(teacher[:, i])
        step_logits, cache = model.decode_step(
            params, tok, cache, torch.full((B,), n + i, dtype=torch.int32))
        out.append(step_logits.numpy())
        toks.append(step_logits.argmax(-1).to(torch.int32))
    return logits.float().numpy(), out, torch.stack(toks, 1).numpy()


# -- configs ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == \
        dataclasses.asdict(jax_smoke_config(arch))


# published sizes (test_arch_smoke's table), and the leaves param_count
# leaves out: starcoder2's output bias and MLP biases, per layer
PUBLISHED = {QWEN3: 4.0e9, GRANITE: 8.2e9, STARCODER: 7.4e9, KIMI: 1.03e12}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_parameter_count(arch):
    """Counted on the meta device: ``param_count()`` plus the biases it
    does not count (starcoder2-7b's ``bo``, ``b_up`` and ``b_down``)."""
    cfg = get_config(arch)
    n = sum(p.numel() for p in
            params_class(cfg)(cfg, device="meta").parameters())
    uncounted = cfg.n_layers * ((cfg.d_model if cfg.o_bias else 0) + (
        cfg.d_ff + cfg.d_model if cfg.mlp_bias else 0))
    assert n == cfg.param_count() + uncounted
    assert abs(n / PUBLISHED[arch] - 1) < 0.03, n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_parameter_tree_round_trips(variant, dtype):
    """``from_jax_params`` then ``to_jax_params`` gives the perturbed JAX
    tree back bitwise, leaf for leaf and path for path: every new leaf
    (q/k norms, output and MLP biases, LayerNorm biases, the untied
    unembedding, the shared expert, the first dense layer) maps both
    ways."""
    _, tree, tcfg, params = _params(variant, dtype,
                                    seed=0 if dtype == "float32" else 1)
    back = to_jax_params(params, tcfg)
    got = jax.tree_util.tree_flatten_with_path(
        back, is_leaf=lambda x: isinstance(x, Bits))[0]
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        if isinstance(a, Bits):
            a = a.bits.view(ml_dtypes.bfloat16)
        assert a.dtype == b.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8),
                                      err_msg=jax.tree_util.keystr(path))


# -- the smoke models ----------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_f32_model_matches_jax(variant):
    jmodel, tree, tcfg, params = _params(variant, "float32")
    jparams = jax.tree.map(jnp.asarray, tree)
    tokens = _tokens(tcfg)
    j_logits, j_steps, j_ids = _run_jax(jmodel, jparams, jnp.asarray(tokens))
    t_logits, t_steps, t_ids = _run_port(tcfg, params, tokens)
    tol = TOL["float32"]
    np.testing.assert_allclose(t_logits, j_logits, atol=tol, rtol=tol)
    for j, t in zip(j_steps, t_steps):
        np.testing.assert_allclose(t, j, atol=tol, rtol=tol)
    np.testing.assert_array_equal(t_ids, j_ids)


def _record_routing(monkeypatch):
    """Every router call's expert sets, per package, in call order; the
    JAX side through an ordered callback, so that it runs jitted."""
    rec = {"jax": [], "torch": []}
    j_fn, t_fn = jax_moe.router_topk, moe.router_topk

    def j_wrap(p, cfg, x2d):
        out = j_fn(p, cfg, x2d)
        jax.debug.callback(lambda idx: rec["jax"].append(
            np.sort(np.asarray(idx), -1)), out[1], ordered=True)
        return out

    def t_wrap(p, cfg, x2d):
        out = t_fn(p, cfg, x2d)
        rec["torch"].append(np.sort(out[1].numpy(), -1))
        return out

    monkeypatch.setattr(jax_moe, "router_topk", j_wrap)
    monkeypatch.setattr(moe, "router_topk", t_wrap)
    return rec


def _clean_rows(rec, n_moe):
    """Which logits rows no routing flip can have reached (as in
    ``test_torch_moe``): calls come as the full forward, the prefill, then
    one per decode step, each ``n_moe`` layers deep."""
    flips = [(a != b).any(-1) for a, b in zip(rec["jax"], rec["torch"])]
    assert len(flips) == n_moe * (2 + STEPS)
    per_call = [np.any(flips[i:i + n_moe], axis=0)
                for i in range(0, len(flips), n_moe)]
    fwd = np.logical_or.accumulate(per_call[0].reshape(B, S), axis=1)
    prompt = per_call[1].reshape(B, S).any(1)
    steps = np.logical_or.accumulate(np.stack(per_call[2:]), axis=0)
    share = float(np.mean(np.concatenate([f.ravel() for f in flips])))
    return ~fwd, [~prompt] + [~(prompt | s) for s in steps], share


@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_model_matches_jax_teacher_forced(variant, monkeypatch):
    """bf16 leaves loaded bit-exactly, the port teacher-forced with the JAX
    tokens; for kimi-k2 the rows a routing flip can reach are excused from
    the logit tolerance, and the argmax must agree on 90% of all rows."""
    jmodel, tree, tcfg, params = _params(variant, "bfloat16", seed=1)
    jparams = jax.tree.map(jnp.asarray, tree)
    lp = params.layers[0]
    want_bits = np.asarray(jax_leaf(tree, "layers.0.ln1.scale")).view(np.uint16)
    assert lp.ln1.scale.dtype == torch.bfloat16
    np.testing.assert_array_equal(lp.ln1.scale.view(torch.uint16).numpy(),
                                  want_bits)
    tokens = _tokens(tcfg, seed=1)
    routed = variant == KIMI
    if routed:
        j_ids = _run_jax(jmodel, jparams, jnp.asarray(tokens))[2]
        rec = _record_routing(monkeypatch)
        j_logits, j_steps, _ = _run_jax(jmodel, jparams, jnp.asarray(tokens),
                                        teacher=j_ids)
        jax.effects_barrier()
    else:
        j_logits, j_steps, j_ids = _run_jax(jmodel, jparams,
                                            jnp.asarray(tokens))
    t_logits, t_steps, _ = _run_port(tcfg, params, tokens, teacher=j_ids)
    clean_fwd = np.ones((B, S), bool)
    clean_steps = [np.ones(B, bool)] * (1 + STEPS)
    if routed:
        n_moe = tcfg.n_layers - tcfg.first_k_dense
        clean_fwd, clean_steps, share = _clean_rows(rec, n_moe)
        assert share < 0.05, share
        assert clean_fwd.mean() >= 0.5, clean_fwd   # the check holds rows
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(t_logits[clean_fwd], j_logits[clean_fwd],
                               atol=tol, rtol=tol)
    for j, t, ok in zip(j_steps, t_steps, clean_steps):
        np.testing.assert_allclose(t[ok], j[ok], atol=tol, rtol=tol)
    agree = np.mean([(t.argmax(-1) == j.argmax(-1)).mean()
                     for t, j in zip([t_logits, *t_steps],
                                     [j_logits, *j_steps])])
    assert agree >= 0.9, agree


@pytest.mark.parametrize("variant", VARIANTS)
@torch.no_grad()
def test_prefill_then_decode_equals_the_full_forward(variant):
    """The port's serving path is the same model as its full forward (as
    ``test_arch_smoke::test_prefill_decode_consistency`` holds the
    reference's), here in f32 at 1e-4: the prefill's last-token logits
    and each decode step's equal the full forward over the sequence so
    far."""
    _, _, cfg, params = _params(variant, "float32", seed=2)
    model = build_model(cfg, ExecConfig())
    tokens = torch.from_numpy(_tokens(cfg, seed=2)).long().to(torch.int32)
    cache = model.init_cache(B, S + STEPS, "cpu")
    logits, cache, n = model.prefill(params, tokens, cache)
    seq = tokens
    for i in range(STEPS):
        full = model.logits(params, seq)[:, -1]
        torch.testing.assert_close(logits, full, atol=1e-4, rtol=1e-4)
        tok = logits.argmax(-1).to(torch.int32)
        seq = torch.cat([seq, tok[:, None]], 1)
        logits, cache = model.decode_step(
            params, tok, cache, torch.full((B,), n + i, dtype=torch.int32))
    torch.testing.assert_close(logits, model.logits(params, seq)[:, -1],
                               atol=1e-4, rtol=1e-4)


# -- init_params ---------------------------------------------------------------------

# leaves whose std the test names, beside the rule that every drawn leaf
# matches the JAX leaf's std (a truncated normal at 2 has 0.8796 of its
# scale as std)
EXPECTED_STD = {
    QWEN3: lambda c: {"layers.0.mlp.w_down": c.d_ff ** -0.5,
                      "layers.0.attn.wo": c.q_dim ** -0.5},
    GRANITE: lambda c: {"layers.0.mlp.w_down": c.d_ff ** -0.5},
    STARCODER: lambda c: {"unembed": c.d_model ** -0.5,
                          "layers.0.mlp.w_up": c.d_model ** -0.5,
                          "layers.0.mlp.w_down": c.d_ff ** -0.5},
    KIMI: lambda c: {"first_layers.0.mlp.w_down": c.dense_d_ff ** -0.5,
                     "layers.0.moe.shared.w_down": c.moe_d_ff ** -0.5,
                     "layers.0.moe.w_down": c.moe_d_ff ** -0.5},
}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_std_per_new_leaf(arch):
    """Every leaf as the JAX init draws it: zeros and ones (biases, norm
    scales, q/k norms, LayerNorm biases) exactly, drawn leaves by std;
    and the new leaves' own stds named."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    got = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    names = {n for n, _ in got.named_parameters()}
    stds = {}
    for name, p in got.named_parameters():
        ref, x = np.asarray(jax_leaf(want, name)), p.float().numpy()
        if ref.std() == 0:
            np.testing.assert_array_equal(x, ref)        # zeros and ones
            continue
        assert abs(x.std() / ref.std() - 1) < 0.1, name
        assert np.abs(x).max() <= np.abs(ref).max() * 1.05, name
        stds[name] = x.std()
    for name, std in EXPECTED_STD[arch](tcfg).items():
        assert abs(stds[name] / (0.8796 * std) - 1) < 0.1, name
    new = {QWEN3: ["layers.0.attn.q_norm", "layers.0.attn.k_norm"],
           STARCODER: ["layers.0.attn.bo", "layers.0.ln1.bias",
                       "final_norm.bias", "layers.0.mlp.b_up",
                       "layers.0.mlp.b_down", "unembed"],
           KIMI: ["first_layers.0.mlp.w_gate", "layers.0.moe.shared.w_up"],
           GRANITE: []}[arch]
    assert set(new) <= names, set(new) - names


# -- the serving launcher --------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_smoke_on_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--new-tokens", "4", "--batch", "3"], keep_logits=True)
    out = capsys.readouterr().out
    assert re.search(rf"{re.escape(arch)}-smoke: prefill 16 toks in "
                     r"[\d.]+ms; 3 decode steps in [\d.]+ms \([\d.]+ tok/s\)",
                     out), out
    gen = res["gen"]
    assert gen.shape == (3, 4) and gen.dtype == torch.int32
    for i, lg in enumerate(res["logits"]):
        assert lg.shape == (3, res["cfg"].vocab_size)
        assert torch.equal(lg.argmax(-1).to(torch.int32), gen[:, i])


# -- training: the loss and every gradient leaf ----------------------------------------------

def _f32(x) -> np.ndarray:
    if isinstance(x, Bits):
        x = x.bits.view(ml_dtypes.bfloat16)
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [QWEN3, STARCODER])
def test_loss_and_every_gradient_match_jax(arch, dtype):
    """``jax.value_and_grad`` of the reference's loss against autograd
    through the port's, on the perturbed weights: the loss and each leaf
    in the reference's layout (through ``to_jax_params``), the biases,
    q/k norms, LayerNorm biases and starcoder2's unembedding included."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jmodel = jax_build_model(jcfg, JaxExecConfig(backend="xla", loss_chunk=8))
    tree = _perturb(jax.tree.map(np.asarray,
                                 jmodel.init(jax.random.PRNGKey(3))),
                    np.random.default_rng(103))
    model = build_model(tcfg, ExecConfig(loss_chunk=8))
    params = trainable(from_jax_params(tree, tcfg, "cpu"))
    batch = make_batch(jcfg, ShapeConfig("t", "train", S, B),
                       PipelineConfig(seed=0), 0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _ = model.loss(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    names = [n for n, _ in params.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                list(params.parameters()))))
    tol = TOL[dtype]
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=tol,
                               rtol=tol)
    got = to_jax_params(grads, tcfg)
    g = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda x: isinstance(x, Bits))[0]
    w = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [jax.tree_util.keystr(p) for p, _ in g] == \
        [jax.tree_util.keystr(p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=tol, rtol=tol,
                                   err_msg=jax.tree_util.keystr(path))
