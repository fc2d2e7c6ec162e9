"""The port's dense decoder and serving launcher against the JAX package's.

The smoke qwen1.5-0.5b runs in both packages on the CPU with the same
weights (the JAX model's parameter tree, loaded by ``from_jax_params``):
full-sequence logits, prefill last-token logits and greedy decode steps.
f32 agrees at 1e-4 with identical token ids; bf16 (the in-repo trained
checkpoint, teacher-forced with the JAX tokens so that a near-tie cannot
fork the sequences) at 5e-2, the tolerance of ``test_arch_smoke``.
"""
import dataclasses
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import ExecConfig as JaxExecConfig
from repro.models import build_model as jax_build_model
from repro_torch.configs import ModelConfig, get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.models import ExecConfig, build_model
from repro_torch.models.weights import (from_jax_params, init_params,
                                         jax_leaf)

ARCH = "qwen1.5-0.5b"
B, S, STEPS = 2, 16, 4
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
CKPT = Path(__file__).resolve().parents[1] / "artifacts" / "train_ckpt" / "step_3"


def _cfgs(dtype):
    kw = dict(dtype=dtype, param_dtype=dtype)
    return (jax_smoke_config(ARCH).with_overrides(**kw),
            smoke_config(ARCH).with_overrides(**kw))


def _checkpoint_params():
    """The trained smoke tree of artifacts/train_ckpt (bf16 leaves stored as
    16-bit patterns), as the JAX checkpointer restores it."""
    manifest = json.loads((CKPT / "manifest.json").read_text())
    data = np.load(CKPT / "arrays.npz")
    tree = {}
    for i, (path, dtype) in enumerate(zip(manifest["paths"],
                                          manifest["dtypes"])):
        keys = re.findall(r"\['(\w+)'\]", path)
        if not path.startswith("[0]"):
            continue                                 # optimizer state
        leaf = data[f"leaf_{i}"]
        if dtype == "bfloat16":
            leaf = leaf.view(ml_dtypes.bfloat16)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def _run_jax(cfg, params, tokens, teacher=None):
    model = jax_build_model(cfg, JaxExecConfig(backend="xla"))
    logits = model.logits(params, tokens)
    cache = model.init_cache(B, S + STEPS)
    step_logits, cache, n = model.prefill(params, tokens, cache)
    out = [np.asarray(step_logits)]
    toks = [np.asarray(jnp.argmax(step_logits, -1)).astype(np.int32)]
    decode = jax.jit(model.decode_step)
    for i in range(STEPS):
        tok = toks[-1] if teacher is None else teacher[:, i]
        step_logits, cache = decode(params, jnp.asarray(tok), cache,
                                    jnp.full((B,), n + i, jnp.int32))
        out.append(np.asarray(step_logits))
        toks.append(np.asarray(jnp.argmax(step_logits, -1)).astype(np.int32))
    return np.asarray(logits), out, np.stack(toks, 1)


@torch.no_grad()
def _run_port(cfg, params, tokens, teacher=None, ec=None):
    model = build_model(cfg, ec or ExecConfig())
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
    return logits.numpy(), out, torch.stack(toks, 1).numpy()


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_configs_are_copies():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))
    assert dataclasses.asdict(smoke_config(ARCH)) == \
        dataclasses.asdict(jax_smoke_config(ARCH))


def test_f32_model_matches_jax():
    jcfg, tcfg = _cfgs("float32")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tokens = _tokens(tcfg)
    j_logits, j_steps, j_ids = _run_jax(jcfg, jparams, jnp.asarray(tokens))
    t_logits, t_steps, t_ids = _run_port(tcfg, params, tokens)
    tol = TOL["float32"]
    np.testing.assert_allclose(t_logits, j_logits, atol=tol, rtol=tol)
    for j, t in zip(j_steps, t_steps):
        np.testing.assert_allclose(t, j, atol=tol, rtol=tol)
    np.testing.assert_array_equal(t_ids, j_ids)


def test_bf16_checkpoint_matches_jax():
    jcfg, tcfg = _cfgs("bfloat16")
    tree = _checkpoint_params()
    jparams = jax.tree.map(jnp.asarray, tree)
    params = from_jax_params(tree, tcfg, "cpu")
    assert params.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params.embed.view(torch.uint16).numpy(),
        np.asarray(tree["embed"]).view(np.uint16))          # bit-exact load
    tokens = _tokens(tcfg, seed=1)
    j_logits, j_steps, j_ids = _run_jax(jcfg, jparams, jnp.asarray(tokens))
    t_logits, t_steps, _ = _run_port(tcfg, params, tokens, teacher=j_ids)
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(t_logits, j_logits, atol=tol, rtol=tol)
    for j, t in zip(j_steps, t_steps):
        np.testing.assert_allclose(t, j, atol=tol, rtol=tol)


def test_from_jax_params_refuses_a_mismatched_tree():
    jcfg, tcfg = _cfgs("float32")
    tree = jax.tree.map(np.asarray,
                        jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="embed"):
        from_jax_params(tree, tcfg.with_overrides(vocab_size=300), "cpu")


def test_init_params_follows_the_jax_distributions():
    jcfg, tcfg = _cfgs("float32")
    want = jax.tree.map(np.asarray,
                        jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    got = init_params(tcfg, gen, "cpu")
    again = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    other = init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    for name, p in got.named_parameters():
        ref, x = np.asarray(jax_leaf(want, name)), p.numpy()
        if ref.std() == 0:
            np.testing.assert_array_equal(x, ref)        # zeros and ones
        else:
            assert abs(x.std() / ref.std() - 1) < 0.05, name
            # truncated at 2 std: both maxima sit just under the cut
            assert np.abs(x).max() <= np.abs(ref).max() * 1.05, name
    for (name, a), b, c in zip(got.named_parameters(), again.parameters(),
                               other.parameters()):
        assert torch.equal(a, b), name
        if a.std() > 0:
            assert not torch.equal(a, c), name


def test_unported_families_raise():
    cfg = ModelConfig(**dataclasses.asdict(jax_smoke_config("mamba2-130m")))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg)


def test_serve_smoke_on_cpu(capsys):
    res = serve.main(["--smoke", "--device", "cpu", "--new-tokens", "4",
                      "--batch", "3"], keep_logits=True)
    out = capsys.readouterr().out
    assert re.search(r"qwen1\.5-0\.5b-smoke: prefill 16 toks in [\d.]+ms; "
                     r"3 decode steps in [\d.]+ms \([\d.]+ tok/s\)", out), out
    assert "generated ids[0]:" in out
    gen = res["gen"]
    assert gen.shape == (3, 4) and gen.dtype == torch.int32
    assert len(res["logits"]) == 4
    for i, lg in enumerate(res["logits"]):
        assert lg.shape == (3, res["cfg"].vocab_size)
        assert torch.equal(lg.argmax(-1).to(torch.int32), gen[:, i])
