"""whisper-tiny, the encoder/decoder family, against the JAX package.

The port's ``models/encdec.py`` and cross-attention run beside
``repro.models.encdec`` on the CPU at the smoke config (2 encoder and 2
decoder layers, 8 frames, LayerNorm with a bias, biased tanh-GELU MLP,
QKV and output biases, tied embeddings), the JAX side on
``backend="xla"``, the port's on its eager ``torch`` path, with the same
weights: the JAX model's parameter tree with every bias and norm scale
perturbed (seeded numpy draws), so that a missing or misplaced bias or
scale shows.  The frames, the stubbed conv frontend's output, are numpy
unit normals from a seed.

Held: the encoder, the cross-attention alone, the full forward's logits,
the prefill and 32 decode steps (f32 1e-4 with the same ids; bf16 5e-2,
teacher-forced with the JAX tokens), the serving path against the full
forward, the loss and every gradient leaf against ``jax.value_and_grad``
(the loss within 1e-4, each leaf within 1e-3 relative L2), the parameter
tree both ways, ``init_params`` leaf by leaf, the launcher on the CPU and
its step graphs (with a stand-in capture) against its eager loop.
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
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro.models import layers as jax_layers
from repro_torch.configs import ShapeConfig, get_config, smoke_config
from repro_torch.launch import serve, train
from repro_torch.launch.step_graphs import ServeGraphs, eager_generate
from repro_torch.models import ExecConfig, attention, build_model, encdec
from repro_torch.models import layers
from repro_torch.models.weights import (Bits, from_jax_params, init_params,
                                         jax_leaf, params_class,
                                         to_jax_params, trainable)
from torch_host_events import HostStamp

ARCH = "whisper-tiny"
B, S, STEPS = 2, 12, 32
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
GRAD_REL_L2 = 1e-3
PERTURBED = {"bq", "bk", "bv", "bo", "b_up", "b_down", "bias", "scale"}


def _cfgs(dtype):
    kw = dict(dtype=dtype, param_dtype=dtype)
    return (jax_smoke_config(ARCH).with_overrides(**kw),
            smoke_config(ARCH).with_overrides(**kw))


def _perturb(tree, rng):
    """Every bias and norm scale replaced by a seeded draw (biases
    0.1·N(0, 1), scales 1 + 0.1·N(0, 1)), in the leaf's dtype."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in PERTURBED:
            a = np.asarray(v)
            out[k] = ((1.0 if k == "scale" else 0.0)
                      + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        else:
            out[k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _params(dtype, seed=0):
    """The JAX model, its perturbed tree (numpy leaves) and the port's
    model on the same values (read, never written, by the tests)."""
    jcfg, tcfg = _cfgs(dtype)
    jmodel = jax_build_model(jcfg, JaxExecConfig(backend="xla"))
    tree = _perturb(jax.tree.map(np.asarray,
                                 jmodel.init(jax.random.PRNGKey(seed))),
                    np.random.default_rng(seed + 100))
    return jmodel, tree, tcfg, from_jax_params(tree, tcfg, "cpu")


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.n_frames, cfg.d_model)
                                 ).astype(np.float32)
    return tokens, frames


def _run_jax(model, params, tokens, frames, teacher=None):
    frames = jnp.asarray(frames)
    logits = model.logits(params, tokens, frames)
    cache = model.init_cache(B, S + STEPS)
    step_logits, cache, n = jax.jit(model.prefill)(params, tokens, cache,
                                                   frames)
    out = [np.asarray(step_logits, np.float32)]
    toks = [np.asarray(jnp.argmax(step_logits, -1)).astype(np.int32)]
    decode = jax.jit(model.decode_step)
    for i in range(STEPS):
        tok = toks[-1] if teacher is None else teacher[:, i]
        step_logits, cache = decode(params, jnp.asarray(tok), cache,
                                    jnp.full((B,), S + i, jnp.int32))
        out.append(np.asarray(step_logits, np.float32))
        toks.append(np.asarray(jnp.argmax(step_logits, -1)).astype(np.int32))
    return np.asarray(logits, np.float32), out, np.stack(toks, 1)


@torch.no_grad()
def _run_port(cfg, params, tokens, frames, teacher=None):
    model = build_model(cfg, ExecConfig())
    t, f = torch.from_numpy(tokens), torch.from_numpy(frames)
    logits = model.logits(params, t, f)
    cache = model.init_cache(B, S + STEPS, "cpu")
    step_logits, cache, n = model.prefill(params, t, cache, f)
    assert n == S
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
    """Counted on the meta device against ``param_count()``, which counts
    learned positions the backbone does not have (sinusoidal in both
    packages: n_frames and 448 decoder rows) and leaves out the output
    and MLP biases of every layer and the encoder's ``ln_post``."""
    cfg = get_config(ARCH)
    n = sum(p.numel() for p in
            params_class(cfg)(cfg, device="meta").parameters())
    d = cfg.d_model
    positions = (cfg.n_frames + cfg.max_decoder_positions()) * d
    per_mlp = cfg.d_ff + d
    uncounted = (cfg.n_enc_layers * (d + per_mlp)          # bo, MLP biases
                 + cfg.n_layers * (2 * d + per_mlp)        # two bo, MLP
                 + 2 * d)                                  # ln_post
    assert n == cfg.param_count() - positions + uncounted == 36_481_920


def test_params_module_holds_the_references_leaves():
    _, tree, tcfg, params = _params("float32")
    names = [n for n, _ in params.named_parameters()]
    assert {n.split(".")[0] for n in names} == set(tree)
    assert any(n.startswith("encoder.layers.1.attn.") for n in names)
    assert "encoder.ln_post.bias" in names
    assert "layers.1.cross_attn.bo" in names and "layers.1.ln3.bias" in names
    assert "unembed" not in names            # tied
    np.testing.assert_array_equal(
        params.encoder.layers[1].mlp.b_up.numpy(),
        tree["encoder"]["layers"]["mlp"]["b_up"][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parameter_tree_round_trips(dtype):
    """``from_jax_params`` then ``to_jax_params`` gives the perturbed JAX
    tree back bitwise, leaf for leaf and path for path: the encoder's
    stacked layers and ``ln_post`` and the decoder's self- and
    cross-attention included."""
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


def test_init_params_std_per_new_leaf():
    """Every leaf as ``repro.models.encdec.init_params`` draws it: zeros
    and ones exactly, drawn leaves by std (a normal truncated at 2 has
    0.8796 of its scale as std), and the new leaves' own stds named."""
    jcfg, tcfg = _cfgs("bfloat16")
    want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    got = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    stds = {}
    for name, p in got.named_parameters():
        ref, x = np.asarray(jax_leaf(want, name)), p.float().numpy()
        assert x.shape == ref.shape, name
        if ref.std() == 0:
            np.testing.assert_array_equal(x, ref)        # zeros and ones
            continue
        assert abs(x.std() / ref.std() - 1) < 0.1, name
        assert np.abs(x).max() <= np.abs(ref).max() * 1.05, name
        stds[name] = x.std()
    d, f = tcfg.d_model, tcfg.d_ff
    for name, std in {"embed": 0.02,
                      "encoder.layers.0.attn.wq": d ** -0.5,
                      "encoder.layers.1.mlp.w_down": f ** -0.5,
                      "layers.0.cross_attn.wk": d ** -0.5,
                      "layers.1.cross_attn.wo": tcfg.q_dim ** -0.5,
                      "layers.0.self_attn.wv": d ** -0.5}.items():
        assert abs(stds[name] / (0.8796 * std) - 1) < 0.1, name
    for name in ("encoder.ln_post.scale", "layers.0.ln3.scale"):
        assert bool((dict(got.named_parameters())[name] == 1).all()), name
    for name in ("encoder.ln_post.bias", "layers.0.cross_attn.bq",
                 "layers.1.cross_attn.bo", "encoder.layers.0.mlp.b_up"):
        assert bool((dict(got.named_parameters())[name] == 0).all()), name


# -- the layers ----------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(8, 64), (1500, 384), (544, 384)])
def test_sinusoidal_positions_match_jax(n, d):
    """Within a few f32 ulps of the largest angle: the two packages' f32
    ``exp`` may round the frequencies one ulp apart, which moves an angle
    near n by up to n times that."""
    got = layers.sinusoidal_positions(n, d).numpy()
    want = np.asarray(jax_layers.sinusoidal_positions(n, d), np.float32)
    assert got.dtype == np.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4 * float(np.spacing(np.float32(n))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_jax(dtype):
    """``cross_attn_precompute`` and ``cross_attn_apply`` (non-causal
    flash attention with Sq != Sk) alone, on a decoder layer's perturbed
    cross-attention weights."""
    _, tree, tcfg, params = _params(dtype)
    jcfg = _cfgs(dtype)[0]
    jp = jax.tree.map(lambda a: jnp.asarray(a[1]),
                      tree["layers"]["cross_attn"])
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, tcfg.n_frames, tcfg.d_model)
                              ).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jk, jv = jax_attention.cross_attn_precompute(jp, jcfg,
                                                 jnp.asarray(enc, jdt))
    jy = jax_attention.cross_attn_apply(jp, jcfg, JaxExecConfig(backend="xla"),
                                        jnp.asarray(x, jdt), jk, jv)
    tdt = getattr(torch, dtype)
    p = params.layers[1].cross_attn
    with torch.no_grad():
        k, v = attention.cross_attn_precompute(
            p, tcfg, torch.from_numpy(enc).to(tdt))
        y = attention.cross_attn_apply(p, tcfg, ExecConfig(), torch.from_numpy(
            x).to(tdt), k, v)
    tol = TOL[dtype]
    assert k.shape == (B, tcfg.n_frames, tcfg.n_kv_heads, tcfg.head_dim)
    for got, want in ((k, jk), (v, jv), (y, jy)):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(dtype):
    jmodel, tree, tcfg, params = _params(dtype)
    _, frames = _inputs(tcfg, seed=3)
    want = jax_encdec.encode(jax.tree.map(jnp.asarray, tree), jmodel.cfg,
                             jmodel.ec, jnp.asarray(frames))
    with torch.no_grad():
        got = encdec.encode(params, tcfg, ExecConfig(),
                            torch.from_numpy(frames))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# -- the smoke model -----------------------------------------------------------------


def test_f32_model_matches_jax():
    """The full forward's logits, the prefill and 32 free-running decode
    steps: every logit within 1e-4 and the same ids."""
    jmodel, tree, tcfg, params = _params("float32")
    tokens, frames = _inputs(tcfg)
    j_logits, j_steps, j_ids = _run_jax(
        jmodel, jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens), frames)
    t_logits, t_steps, t_ids = _run_port(tcfg, params, tokens, frames)
    tol = TOL["float32"]
    np.testing.assert_allclose(t_logits, j_logits, atol=tol, rtol=tol)
    assert len(t_steps) == STEPS + 1
    for j, t in zip(j_steps, t_steps):
        np.testing.assert_allclose(t, j, atol=tol, rtol=tol)
    np.testing.assert_array_equal(t_ids, j_ids)


def test_bf16_model_matches_jax_teacher_forced():
    jmodel, tree, tcfg, params = _params("bfloat16", seed=1)
    assert params.layers[0].cross_attn.wq.dtype == torch.bfloat16
    tokens, frames = _inputs(tcfg, seed=1)
    j_logits, j_steps, j_ids = _run_jax(
        jmodel, jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens), frames)
    t_logits, t_steps, _ = _run_port(tcfg, params, tokens, frames,
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
    """The serving path (a cross-attention cache built once, positions from
    the cache's table) is the same model as the full forward, f32 1e-4."""
    _, _, cfg, params = _params("float32", seed=2)
    model = build_model(cfg, ExecConfig())
    tokens, frames = (torch.from_numpy(a) for a in _inputs(cfg, seed=2))
    cache = model.init_cache(B, S + 4, "cpu")
    assert cache["ck"].shape == (cfg.n_layers, B, cfg.n_frames,
                                 cfg.n_kv_heads, cfg.head_dim)
    assert cache["cross_len"].tolist() == [cfg.n_frames] * B
    logits, cache, n = model.prefill(params, tokens, cache, frames)
    seq = tokens
    for i in range(4):
        full = model.logits(params, seq, frames)[:, -1]
        torch.testing.assert_close(logits, full, atol=1e-4, rtol=1e-4)
        tok = logits.argmax(-1).to(torch.int32)
        seq = torch.cat([seq, tok[:, None]], 1)
        logits, cache = model.decode_step(
            params, tok, cache, torch.full((B,), n + i, dtype=torch.int32))
    torch.testing.assert_close(logits, model.logits(params, seq, frames)[:, -1],
                               atol=1e-4, rtol=1e-4)


def test_the_frames_reach_the_decoder():
    """Another set of frames changes every logit row (the cross-attention
    reads them), and a family without an extra input refuses one."""
    _, _, cfg, params = _params("float32")
    model = build_model(cfg, ExecConfig())
    tokens, frames = (torch.from_numpy(a) for a in _inputs(cfg))
    with torch.no_grad():
        a = model.logits(params, tokens, frames)
        b = model.logits(params, tokens, frames.flip(1))
    assert bool(((a - b).abs().amax(-1) > 1e-3).all())
    dense = build_model(smoke_config("qwen1.5-0.5b"))
    with pytest.raises(ValueError, match="no extra input"):
        dense.logits(None, tokens, frames)


# -- training ----------------------------------------------------------------------


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_gradient_match_jax(remat):
    """``jax.value_and_grad`` of the reference's loss against autograd
    through the port's, f32, on the perturbed weights and a batch of
    ``make_batch`` (its frames as a tensor): the loss within 1e-4, each
    leaf within 1e-3 relative L2 in the reference's layout (through
    ``to_jax_params``), the key biases' (zero) gradients both below
    1e-8."""
    jcfg, tcfg = _cfgs("float32")
    jmodel = jax_build_model(jcfg, JaxExecConfig(backend="xla", loss_chunk=8,
                                                 remat=remat))
    tree = _perturb(jax.tree.map(np.asarray,
                                 jmodel.init(jax.random.PRNGKey(3))),
                    np.random.default_rng(103))
    model = build_model(tcfg, ExecConfig(loss_chunk=8, remat=remat))
    params = trainable(from_jax_params(tree, tcfg, "cpu"))
    batch = make_batch(jcfg, ShapeConfig("t", "train", 16, B),
                       PipelineConfig(seed=0), 0)
    assert batch["frames"].shape == (B, tcfg.n_frames, tcfg.d_model)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = model.loss(params, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    names = [n for n, _ in params.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                list(params.parameters()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-4,
                               rtol=1e-4)
    assert float(metrics["aux_loss"]) == 0.0
    got = jax.tree_util.tree_flatten_with_path(to_jax_params(grads, tcfg))[0]
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        a, b, key = _f32(a), _f32(b), jax.tree_util.keystr(path)
        if key.endswith("['bk']"):
            # q·bk shifts a row's scores alike, which the softmax ignores:
            # the key bias's gradient is zero, both sides' round-off
            assert max(np.abs(a).max(), np.abs(b).max()) < 1e-8, key
            continue
        assert np.linalg.norm(b) > 0, key
        assert _rel_l2(a, b) < GRAD_REL_L2, key


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
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--new-tokens", "4", "--batch", "3"], keep_logits=True)
    out = capsys.readouterr().out
    assert re.search(r"whisper-tiny-smoke: prefill 16 toks in [\d.]+ms; "
                     r"3 decode steps in [\d.]+ms \([\d.]+ tok/s\)", out), out
    cfg = res["cfg"]
    assert res["model"].extra_shape(3) == (3, cfg.n_frames, cfg.d_model)
    assert res["model"].prefix_len == 0
    assert res["extra"].shape == (3, cfg.n_frames, cfg.d_model)
    assert res["extra"].dtype == torch.bfloat16
    # the reference launcher's draws: the prompt, then the frames
    rng = np.random.default_rng(0)
    want_tokens = rng.integers(0, cfg.vocab_size, (3, 16))
    want_frames = rng.normal(size=(3, cfg.n_frames, cfg.d_model))
    np.testing.assert_array_equal(res["tokens"].numpy(), want_tokens)
    np.testing.assert_array_equal(          # rounded as the reference's
        res["extra"].float().numpy(),
        np.asarray(jnp.asarray(want_frames, jnp.bfloat16), np.float32))
    gen = res["gen"]
    assert gen.shape == (3, 4) and gen.dtype == torch.int32
    for i, lg in enumerate(res["logits"]):
        assert lg.shape == (3, cfg.vocab_size)
        assert torch.equal(lg.argmax(-1).to(torch.int32), gen[:, i])
    with torch.no_grad():                     # the loop, written out
        want = eager_generate(res["model"], res["params"], res["tokens"], 4,
                              extra=res["extra"])
    assert torch.equal(want.ids, gen)


class _StandInCapture:
    """``CudaCapture`` on the CPU: the capture runs the step once, and each
    replay runs it again (as ``tests/test_torch_graphs.py``'s)."""

    class Graph:
        def __init__(self, body):
            self.body = body

        def replay(self):
            self.body()

        def reset(self):
            self.body = None

    def on_stream(self):
        import contextlib
        return contextlib.nullcontext()

    def capture(self, body):
        body()
        return self.Graph(body)

    def event(self):
        return HostStamp()


def test_step_graphs_take_the_frames_as_a_static_buffer():
    """The graphed loop (its capture stood in for) gives the eager loop's
    ids and logits bitwise, reading a copy of the frames it was built with
    (writing the caller's tensor afterwards changes nothing); graphs built
    with other frames give other ids."""
    _, _, cfg, params = _params("float32")
    model = build_model(cfg, ExecConfig())
    tokens, frames = (torch.from_numpy(a) for a in _inputs(cfg))
    new = 6
    want = eager_generate(model, params, tokens, new, keep_logits=True,
                          extra=frames)
    given = frames.clone()
    graphs = ServeGraphs(model, params, B, S, S + new, "cpu",
                         capture=_StandInCapture(), extra=given)
    given.zero_()
    got = graphs.generate(tokens, new, keep_logits=True)
    assert torch.equal(got.ids, want.ids)
    for a, b in zip(got.logits, want.logits):
        assert torch.equal(a, b)
    assert int(graphs.idx[0]) == S + new - 1
    graphs.close()
    other = ServeGraphs(model, params, B, S, S + new, "cpu",
                        capture=_StandInCapture(), extra=frames * -1.0)
    assert not torch.equal(other.generate(tokens, new).ids, want.ids)
    other.close()


def test_the_fanout_refuses_the_family():
    _, _, cfg, params = _params("float32")
    with pytest.raises(NotImplementedError, match="Enc-dec and VLM"):
        serve.run_faasm_fanout(build_model(cfg), params, cfg.vocab_size, 2,
                               device="cpu")
