"""internvl2-2b, the VLM family, against the JAX package.

The port's VLM branch of ``models/transformer.py`` runs beside
``repro.models.transformer`` on the CPU at the smoke config (3 layers, 4
query heads over 2 KV heads, RMSNorm, gated SiLU, RoPE at theta 1e6, 4
image tokens), the JAX side on ``backend="xla"``, the port's on its eager
``torch`` path, with the same weights: the JAX model's parameter tree with
every norm scale perturbed (seeded numpy draws).  The patch embeddings,
the stubbed vision frontend's output, are numpy unit normals from a seed
and go ahead of the text.

Held: the full forward's logits, the prefill and 32 decode steps (f32
1e-4 with the same ids; bf16 5e-2, teacher-forced with the JAX tokens),
decode positions starting after the patch embeddings, the serving path
against the full forward, the loss over the text positions only and
every gradient leaf against ``jax.value_and_grad`` (the loss within 1e-4,
each leaf within 1e-3 relative L2), the parameter tree both ways,
``init_params`` leaf by leaf, the launcher on the CPU and its step graphs
(with a stand-in capture) against its eager loop.
"""
import contextlib
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
from repro_torch.configs import ShapeConfig, get_config, smoke_config
from repro_torch.launch import serve, train
from repro_torch.launch.step_graphs import ServeGraphs, eager_generate
from repro_torch.models import ExecConfig, build_model
from repro_torch.models.transformer import Transformer
from repro_torch.models.weights import (Bits, from_jax_params, init_params,
                                         jax_leaf, params_class,
                                         to_jax_params, trainable)
from torch_host_events import HostStamp

ARCH = "internvl2-2b"
B, S, STEPS = 2, 12, 32
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
GRAD_REL_L2 = 1e-3


def _cfgs(dtype):
    kw = dict(dtype=dtype, param_dtype=dtype)
    return (jax_smoke_config(ARCH).with_overrides(**kw),
            smoke_config(ARCH).with_overrides(**kw))


def _perturb(tree, rng):
    """Every norm scale replaced by a seeded draw, 1 + 0.1·N(0, 1), in the
    leaf's dtype."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k == "scale":
            a = np.asarray(v)
            out[k] = (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        else:
            out[k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _params(dtype, seed=0):
    jcfg, tcfg = _cfgs(dtype)
    jmodel = jax_build_model(jcfg, JaxExecConfig(backend="xla"))
    tree = _perturb(jax.tree.map(np.asarray,
                                 jmodel.init(jax.random.PRNGKey(seed))),
                    np.random.default_rng(seed + 100))
    return jmodel, tree, tcfg, from_jax_params(tree, tcfg, "cpu")


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    image = rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model)
                                ).astype(np.float32)
    return tokens, image


def _run_jax(model, params, tokens, image, teacher=None):
    image = jnp.asarray(image)
    n_img = model.cfg.n_image_tokens
    logits = model.logits(params, tokens, image)
    cache = model.init_cache(B, n_img + S + STEPS)
    step_logits, cache, n = jax.jit(model.prefill)(params, tokens, cache,
                                                   image)
    out = [np.asarray(step_logits, np.float32)]
    toks = [np.asarray(jnp.argmax(step_logits, -1)).astype(np.int32)]
    decode = jax.jit(model.decode_step)
    for i in range(STEPS):
        tok = toks[-1] if teacher is None else teacher[:, i]
        step_logits, cache = decode(params, jnp.asarray(tok), cache,
                                    jnp.full((B,), n_img + S + i, jnp.int32))
        out.append(np.asarray(step_logits, np.float32))
        toks.append(np.asarray(jnp.argmax(step_logits, -1)).astype(np.int32))
    return np.asarray(logits, np.float32), out, np.stack(toks, 1)


@torch.no_grad()
def _run_port(cfg, params, tokens, image, teacher=None):
    model = build_model(cfg, ExecConfig())
    t, x = torch.from_numpy(tokens), torch.from_numpy(image)
    logits = model.logits(params, t, x)
    cache = model.init_cache(B, cfg.n_image_tokens + S + STEPS, "cpu")
    step_logits, cache, n = model.prefill(params, t, cache, x)
    assert n == cfg.n_image_tokens + S
    out = [step_logits.numpy()]
    toks = [step_logits.argmax(-1).to(torch.int32)]
    for i in range(STEPS):
        tok = toks[-1] if teacher is None else torch.from_numpy(teacher[:, i])
        step_logits, cache = model.decode_step(
            params, tok, cache, torch.full((B,), n + i, dtype=torch.int32))
        out.append(step_logits.numpy())
        toks.append(step_logits.argmax(-1).to(torch.int32))
    return logits.float().numpy(), out, torch.stack(toks, 1).numpy()


def _f32(x) -> np.ndarray:
    if isinstance(x, Bits):
        x = x.bits.view(ml_dtypes.bfloat16)
    return np.asarray(x).astype(np.float32)


# -- the config and the parameters -------------------------------------------------


def test_configs_are_copies():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))
    assert dataclasses.asdict(smoke_config(ARCH)) == \
        dataclasses.asdict(jax_smoke_config(ARCH))


def test_full_width_parameter_count():
    """Counted on the meta device: ``param_count()`` exactly (the language
    backbone; the vision frontend is a stub in both packages)."""
    cfg = get_config(ARCH)
    assert params_class(cfg) is Transformer
    n = sum(p.numel() for p in Transformer(cfg, device="meta").parameters())
    assert n == cfg.param_count() == 1_889_146_880


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parameter_tree_round_trips(dtype):
    _, tree, tcfg, params = _params(dtype, seed=0 if dtype == "float32" else 1)
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


def test_init_params_std_per_leaf():
    jcfg, tcfg = _cfgs("bfloat16")
    want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    got = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    stds = {}
    for name, p in got.named_parameters():
        ref, x = np.asarray(jax_leaf(want, name)), p.float().numpy()
        assert x.shape == ref.shape, name
        if ref.std() == 0:
            np.testing.assert_array_equal(x, ref)
            continue
        assert abs(x.std() / ref.std() - 1) < 0.1, name
        assert np.abs(x).max() <= np.abs(ref).max() * 1.05, name
        stds[name] = x.std()
    for name, std in {"embed": 0.02, "unembed": tcfg.d_model ** -0.5,
                      "layers.2.attn.wk": tcfg.d_model ** -0.5,
                      "layers.0.mlp.w_down": tcfg.d_ff ** -0.5}.items():
        assert abs(stds[name] / (0.8796 * std) - 1) < 0.1, name


# -- the smoke model -----------------------------------------------------------------


def test_f32_model_matches_jax():
    """The full forward's logits (patch positions included), the prefill
    and 32 free-running decode steps after the patch embeddings: every
    logit within 1e-4 and the same ids."""
    jmodel, tree, tcfg, params = _params("float32")
    tokens, image = _inputs(tcfg)
    j_logits, j_steps, j_ids = _run_jax(
        jmodel, jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens), image)
    t_logits, t_steps, t_ids = _run_port(tcfg, params, tokens, image)
    assert t_logits.shape == (B, tcfg.n_image_tokens + S, tcfg.vocab_size)
    tol = TOL["float32"]
    np.testing.assert_allclose(t_logits, j_logits, atol=tol, rtol=tol)
    for j, t in zip(j_steps, t_steps):
        np.testing.assert_allclose(t, j, atol=tol, rtol=tol)
    np.testing.assert_array_equal(t_ids, j_ids)


def test_bf16_model_matches_jax_teacher_forced():
    jmodel, tree, tcfg, params = _params("bfloat16", seed=1)
    tokens, image = _inputs(tcfg, seed=1)
    j_logits, j_steps, j_ids = _run_jax(
        jmodel, jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens), image)
    t_logits, t_steps, _ = _run_port(tcfg, params, tokens, image,
                                     teacher=j_ids)
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(t_logits, j_logits, atol=tol, rtol=tol)
    for j, t in zip(j_steps, t_steps):
        np.testing.assert_allclose(t, j, atol=tol, rtol=tol)
    agree = np.mean([(t.argmax(-1) == j.argmax(-1)).mean()
                     for t, j in zip([t_logits, *t_steps],
                                     [j_logits, *j_steps])])
    assert agree >= 0.9, agree


@torch.no_grad()
def test_prefill_then_decode_equals_the_full_forward():
    _, _, cfg, params = _params("float32", seed=2)
    model = build_model(cfg, ExecConfig())
    tokens, image = (torch.from_numpy(a) for a in _inputs(cfg, seed=2))
    cache = model.init_cache(B, cfg.n_image_tokens + S + 4, "cpu")
    logits, cache, n = model.prefill(params, tokens, cache, image)
    assert n == cfg.n_image_tokens + S
    seq = tokens
    for i in range(4):
        full = model.logits(params, seq, image)[:, -1]
        torch.testing.assert_close(logits, full, atol=1e-4, rtol=1e-4)
        tok = logits.argmax(-1).to(torch.int32)
        seq = torch.cat([seq, tok[:, None]], 1)
        logits, cache = model.decode_step(
            params, tok, cache, torch.full((B,), n + i, dtype=torch.int32))
    torch.testing.assert_close(logits, model.logits(params, seq, image)[:, -1],
                               atol=1e-4, rtol=1e-4)


def test_the_patch_embeddings_are_needed_and_read():
    _, _, cfg, params = _params("float32")
    model = build_model(cfg, ExecConfig())
    tokens, image = (torch.from_numpy(a) for a in _inputs(cfg))
    with pytest.raises(ValueError, match="patch embeddings"):
        model.logits(params, tokens)
    with torch.no_grad():
        a = model.logits(params, tokens, image)[:, -1]
        b = model.logits(params, tokens, image.flip(1))[:, -1]
    assert bool(((a - b).abs().amax(-1) > 1e-3).all())


# -- training ----------------------------------------------------------------------


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_gradient_match_jax(remat):
    """``jax.value_and_grad`` of the reference's loss (over the text
    positions only) against autograd through the port's, f32, on a batch
    of ``make_batch`` with its patch embeddings as a tensor: the loss
    within 1e-4, each leaf within 1e-3 relative L2."""
    jcfg, tcfg = _cfgs("float32")
    jmodel = jax_build_model(jcfg, JaxExecConfig(backend="xla", loss_chunk=4,
                                                 remat=remat))
    tree = _perturb(jax.tree.map(np.asarray,
                                 jmodel.init(jax.random.PRNGKey(3))),
                    np.random.default_rng(103))
    model = build_model(tcfg, ExecConfig(loss_chunk=4, remat=remat))
    params = trainable(from_jax_params(tree, tcfg, "cpu"))
    batch = make_batch(jcfg, ShapeConfig("t", "train", 16, B),
                       PipelineConfig(seed=0), 0)
    St = 16 - tcfg.n_image_tokens
    assert batch["tokens"].shape == (B, St)
    assert batch["image_embeds"].shape == (B, tcfg.n_image_tokens,
                                           tcfg.d_model)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _ = model.loss(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    names = [n for n, _ in params.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                list(params.parameters()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-4,
                               rtol=1e-4)
    got = jax.tree_util.tree_flatten_with_path(to_jax_params(grads, tcfg))[0]
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        b, key = _f32(b), jax.tree_util.keystr(path)
        assert np.linalg.norm(b) > 0, key
        assert _rel_l2(_f32(a), b) < GRAD_REL_L2, key


def test_the_loss_reads_the_text_positions_only():
    """Targets on the patch positions do not exist: the loss is the mean
    over the text rows' mask, and a mask of zeros on the text gives 0."""
    _, tcfg = _cfgs("float32")
    params = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    model = build_model(tcfg, ExecConfig(loss_chunk=0))
    tokens, image = (torch.from_numpy(a) for a in _inputs(tcfg))
    batch = {"tokens": tokens, "targets": tokens.roll(-1, 1),
             "mask": torch.ones(B, S), "image_embeds": image}
    with torch.no_grad():
        loss, _ = model.loss(params, batch)
        logits = model.logits(params, tokens, image)[:, tcfg.n_image_tokens:]
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, tcfg.vocab_size),
            batch["targets"].reshape(-1).long())
        zero, _ = model.loss(params, dict(batch, mask=torch.zeros(B, S)))
    torch.testing.assert_close(loss, want, atol=1e-5, rtol=1e-5)
    assert float(zero) == 0.0


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "2", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 2
    assert all(np.isfinite(x) for x in out["losses"])
    assert "done" in capsys.readouterr().out


def test_train_launcher_refuses_the_card(monkeypatch, tmp_path):
    """The family trains on the card as every other does: asked for the
    card (``--device cuda``, the default) on a machine with none, the
    launcher raises the no-card error, not a refusal of the family."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", ARCH, "--smoke", "--steps", "1",
                        "--ckpt-dir", str(tmp_path)] + device)


# -- the serving launcher ------------------------------------------------------------


def test_serve_smoke_on_cpu(capsys):
    """The launcher draws the prompt, then the patch embeddings, from one
    generator (the reference's order); its cache holds the patches, the
    prompt and the new tokens, and decoding starts after the patches."""
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--new-tokens", "4", "--batch", "3"], keep_logits=True)
    out = capsys.readouterr().out
    assert re.search(r"internvl2-2b-smoke: prefill 16 toks in [\d.]+ms; "
                     r"3 decode steps in [\d.]+ms \([\d.]+ tok/s\)", out), out
    cfg = res["cfg"]
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  rng.integers(0, cfg.vocab_size, (3, 16)))
    want_image = rng.normal(size=(3, cfg.n_image_tokens, cfg.d_model))
    np.testing.assert_array_equal(          # rounded as the reference's
        res["extra"].float().numpy(),
        np.asarray(jnp.asarray(want_image, jnp.bfloat16), np.float32))
    gen = res["gen"]
    assert gen.shape == (3, 4) and gen.dtype == torch.int32
    model, params, tokens = res["model"], res["params"], res["tokens"]
    n_img = cfg.n_image_tokens
    assert model.prefix_len == n_img
    assert model.extra_shape(3) == (3, n_img, cfg.d_model)
    cache = model.init_cache(3, n_img + 16 + 4, "cpu")
    with torch.no_grad():                     # the loop, written out
        logits, cache, n = model.prefill(params, tokens, cache, res["extra"])
        assert n == n_img + 16
        ids = [logits.argmax(-1).to(torch.int32)]
        for i in range(3):
            idx = torch.full((3,), n + i, dtype=torch.int32)
            logits, cache = model.decode_step(params, ids[-1], cache, idx)
            ids.append(logits.argmax(-1).to(torch.int32))
    assert torch.equal(gen, torch.stack(ids, dim=1))


class _StandInCapture:
    """``CudaCapture`` on the CPU (as ``tests/test_torch_graphs.py``'s)."""

    class Graph:
        def __init__(self, body):
            self.body = body

        def replay(self):
            self.body()

        def reset(self):
            self.body = None

    def on_stream(self):
        return contextlib.nullcontext()

    def capture(self, body):
        body()
        return self.Graph(body)

    def event(self):
        return HostStamp()


def test_step_graphs_start_decoding_after_the_patches():
    _, _, cfg, params = _params("float32")
    model = build_model(cfg, ExecConfig())
    tokens, image = (torch.from_numpy(a) for a in _inputs(cfg))
    new, n_img = 6, cfg.n_image_tokens
    want = eager_generate(model, params, tokens, new, keep_logits=True,
                          extra=image)
    graphs = ServeGraphs(model, params, B, S, n_img + S + new, "cpu",
                         capture=_StandInCapture(), extra=image)
    assert graphs.start == n_img + S
    got = graphs.generate(tokens, new, keep_logits=True)
    assert torch.equal(got.ids, want.ids)
    for a, b in zip(got.logits, want.logits):
        assert torch.equal(a, b)
    assert int(graphs.idx[0]) == n_img + S + new - 1
    with pytest.raises(ValueError, match="1 to 6"):
        graphs.generate(tokens, new + 1)
    graphs.close()


def test_the_fanout_refuses_the_family():
    _, _, cfg, params = _params("float32")
    with pytest.raises(NotImplementedError, match="Enc-dec and VLM"):
        serve.run_faasm_fanout(build_model(cfg), params, cfg.vocab_size, 2,
                               device="cpu")
