"""The port's training path against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both packages (JAX
on ``backend="xla"``, whose flash attention has the custom-VJP backward the
port's plain flash backward mirrors).  Tolerances: the optimizers 1e-6 in
f32 and one bf16 ulp for bf16 parameters (the update is f32 in both, then
cast); the flash backward 2e-5 in f32 and 3e-2 in bf16 (the kernel
tolerances); the model's loss and gradients 1e-4 in f32 and 5e-2 in bf16
(the model tolerance of ``test_torch_model``), each gradient leaf compared
through ``to_jax_params`` in the reference's layout, the tied embedding's
gradient (lookup plus unembedding) as its own leaf.  The SSM and hybrid
smoke models train on 40-token rows, so the SSD scan's state crosses
chunks (16 steps each, the last one ragged).  Checkpoints written by
either package restore in the other, and the in-repo checkpoint the
reference's launcher wrote resumes in the port.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import data as jdata
from repro import optim as joptim
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models import ExecConfig as JaxExecConfig
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.optim import compression as jcomp
from repro.state.kv import GlobalTier as JaxGlobalTier
from repro_torch import checkpoint as tckpt
from repro_torch import data as tdata
from repro_torch import optim as toptim
from repro_torch.configs import ShapeConfig, smoke_config, smoke_shape
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention_bwd)
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import ExecConfig, build_model
from repro_torch.models import layers as L
from repro_torch.models.weights import (Bits, from_jax_params, to_jax_params,
                                         trainable)
from repro_torch.optim import compression as tcomp
from repro_torch.state.kv import GlobalTier

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "artifacts" / "train_ckpt"
DENSE, MOE = "qwen1.5-0.5b", "deepseek-moe-16b"
SSM, HYBRID = "mamba2-130m", "zamba2-1.2b"
SSM_ARCHS = (SSM, HYBRID)
SSM_SEQ = 40        # three SSD chunks of 16 at the smoke config, one ragged
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
B, S = 2, 16


def _f32(x) -> np.ndarray:
    """A leaf of either package (numpy, JAX, Bits, torch) as f32 numpy."""
    if isinstance(x, Bits):
        x = x.bits.view(ml_dtypes.bfloat16)
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, Bits))[0]


def _assert_trees_close(got, want, tol):
    """Leaf by leaf in the reference's layout (same paths), atol = rtol."""
    g, w = _leaves(got), _leaves(want)
    assert [jax.tree_util.keystr(p) for p, _ in g] == \
        [jax.tree_util.keystr(p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=tol, rtol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def _cfgs(arch, dtype):
    kw = dict(dtype=dtype, param_dtype=dtype)
    return (jax_smoke_config(arch).with_overrides(**kw),
            smoke_config(arch).with_overrides(**kw))


def _models(arch, dtype, loss_chunk=8, remat="full", seed=0):
    """The JAX model and parameters, and the port's on the same values."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jmodel = jax_build_model(jcfg, JaxExecConfig(backend="xla",
                                                 loss_chunk=loss_chunk))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = build_model(tcfg, ExecConfig(loss_chunk=loss_chunk, remat=remat))
    params = trainable(from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, "cpu"))
    return jmodel, jparams, model, params


def _seq(arch) -> int:
    return SSM_SEQ if arch in SSM_ARCHS else S


def _batch(cfg, rows=B, seq=S, step=0):
    return jdata.make_batch(cfg, ShapeConfig("t", "train", seq, rows),
                            jdata.PipelineConfig(seed=0), step)


def _port_grads(model, params, batch):
    (loss, metrics) = model.loss(params, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    return loss, metrics, dict(zip(names, grads))


# -- optimizers -------------------------------------------------------------------

OPTS = {
    "sgd": dict(cls="SGD"),
    "sgd_momentum": dict(cls="SGD", momentum=0.9),
    "sgd_decay": dict(cls="SGD", weight_decay=0.01),
    "sgd_momentum_decay": dict(cls="SGD", momentum=0.9, weight_decay=0.01),
    "adamw": dict(cls="AdamW"),
}


def _opt(pkg, spec, lr):
    kw = {k: v for k, v in spec.items() if k != "cls"}
    return getattr(pkg, spec["cls"])(lr=lr, **kw)


def _within_ulp(got, want, dtype):
    got, want = _f32(got), _f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        return
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), float(np.max(
        np.abs(got - want) / ulp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", list(OPTS))
def test_optimizer_matches_jax(opt, dtype):
    """Three updates from the same parameters and gradients, with the
    warm-up-cosine schedule read at the step counter."""
    jcfg, tcfg = _cfgs(DENSE, dtype)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    jopt = _opt(joptim, OPTS[opt], joptim.warmup_cosine(0.05, 2, 10))
    topt = _opt(toptim, OPTS[opt], toptim.warmup_cosine(0.05, 2, 10))
    jstate, tstate = jopt.init(jparams), topt.init(params)
    rng = np.random.default_rng(0)
    for _ in range(3):
        jgrads = jax.tree.map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype),
            jparams)
        gmod = from_jax_params(jax.tree.map(np.asarray, jgrads), tcfg, "cpu")
        jparams, jstate = jopt.update(jgrads, jstate, jparams)
        params, tstate = topt.update(dict(gmod.named_parameters()), tstate,
                                     params)
    assert int(tstate.step) == int(jstate.step) == 3
    for (_, a), (_, b) in zip(_leaves(to_jax_params(params, tcfg)),
                              _leaves(jparams)):
        _within_ulp(a, b, dtype)
    moments = [("momentum", "momentum")] if "momentum" in OPTS[opt] else \
        [("mu", "mu"), ("nu", "nu")] if opt == "adamw" else []
    for tf, jf in moments:
        for (_, a), (_, b) in zip(
                _leaves(to_jax_params(getattr(tstate, tf), tcfg)),
                _leaves(getattr(jstate, jf))):
            _within_ulp(a, b, dtype if tf == "momentum" else "float32")


@pytest.mark.parametrize("warmup,total", [(1, 8), (10, 110), (0, 5)])
def test_warmup_cosine_matches_jax(warmup, total):
    jsched = joptim.warmup_cosine(0.05, warmup, total)
    tsched = toptim.warmup_cosine(0.05, warmup, total)
    for step in range(total + 3):
        got = float(tsched(torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(float(jsched(jnp.asarray(step))),
                                    rel=1e-6, abs=1e-9)


# -- gradient accumulation, compression, data ---------------------------------------

@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_micro", [1, 4])
def test_accumulate_grads_matches_jax(n_micro, accum):
    jmodel, jparams, model, params = _models(DENSE, "float32")
    batch = _batch(jmodel.cfg, rows=4)
    jgrads, jloss, _ = jax.jit(
        lambda p, b: joptim.accumulate_grads(jmodel.loss, p, b, n_micro,
                                             accum_dtype=jnp.dtype(accum)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    grads, loss, metrics = toptim.accumulate_grads(
        model.loss, params, {k: torch.from_numpy(v) for k, v in batch.items()},
        n_micro, accum_dtype=getattr(torch, accum))
    assert set(metrics) == {"loss", "aux_loss"}
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want_dtype = torch.float32 if n_micro == 1 else getattr(torch, accum)
    assert all(g.dtype == want_dtype for g in grads.values())
    # bf16 accumulators round each of the 4 additions (one bf16 ulp each)
    tol = 1e-4 if n_micro == 1 or accum == "float32" else 2e-2
    _assert_trees_close(to_jax_params(grads, model.cfg), jgrads, tol)



def test_accumulate_grads_owns_aliased_gradients():
    """Autograd hands ``a`` and ``b`` of ``a + b`` one tensor and ``c`` of
    ``c.sum()`` a broadcast view; the accumulator, seeded from the first
    microbatch, still adds each microbatch into each leaf once."""

    class Three(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = torch.nn.Parameter(torch.ones(3, 4))
            self.b = torch.nn.Parameter(torch.ones(3, 4))
            self.c = torch.nn.Parameter(torch.ones(3, 4))

    def loss_fn(m, batch):
        loss = ((m.a + m.b) * batch["x"]).sum() + m.c.sum()
        return loss, {"loss": loss}

    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((4, 3, 4)).astype(np.float32))
    grads, loss, _ = toptim.accumulate_grads(loss_fn, Three(), {"x": x}, 2)
    want = (x[:2].sum(0) + x[2:].sum(0)) / 2
    torch.testing.assert_close(grads["a"], want)
    torch.testing.assert_close(grads["b"], want)
    torch.testing.assert_close(grads["c"], torch.ones(3, 4))
    assert float(loss) == pytest.approx(float((2 * x).sum() / 2 + 12.0),
                                        rel=1e-5)



def _grad_pairs(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 33), "b": (33,), "m": (4, 5, 6)}
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_round_trip_matches_jax(kind):
    """Two pushes with error feedback: the wire, the decoded values and the
    residual carried into the next push, as the reference's."""
    jstate = jcomp.init_state({n: jnp.asarray(g)
                               for n, g in _grad_pairs().items()})
    tstate = tcomp.init_state({n: torch.from_numpy(g)
                               for n, g in _grad_pairs().items()})
    for seed in (1, 2):
        g = _grad_pairs(seed)
        jg = {n: jnp.asarray(x) for n, x in g.items()}
        tg = {n: torch.from_numpy(x) for n, x in g.items()}
        if kind == "int8":
            jwire, jdec, jstate = jcomp.compress_int8(jg, jstate)
            twire, tdec, tstate = tcomp.compress_int8(tg, tstate)
            assert tcomp.wire_bytes_int8(twire) == jcomp.wire_bytes_int8(jwire)
        else:
            jwire, jdec, jstate = jcomp.compress_topk(jg, jstate, frac=0.1)
            twire, tdec, tstate = tcomp.compress_topk(tg, tstate, frac=0.1)
        for n in g:
            a, b = twire[n], jwire[n]
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))
            np.testing.assert_allclose(a[1].numpy(), np.asarray(b[1]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(tdec[n].numpy(), np.asarray(jdec[n]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(tstate.residual[n].numpy(),
                                       np.asarray(jstate.residual[n]),
                                       rtol=1e-5, atol=1e-6)
    q, s = tcomp.quantize_int8(torch.from_numpy(_grad_pairs()["m"]))
    back = tcomp.dequantize_int8(q, s).numpy()
    assert np.max(np.abs(back - _grad_pairs()["m"])) <= float(s.max()) / 2 + 1e-7


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_make_batch_is_bitwise_the_reference(arch):
    for shape, pc, step in [(smoke_shape("train"), (0, 1, 0), 0),
                            (ShapeConfig("t", "train", 40, 6), (3, 2, 1), 5)]:
        got = tdata.make_batch(smoke_config(arch), shape,
                               tdata.PipelineConfig(*pc), step)
        want = jdata.make_batch(jax_smoke_config(arch), shape,
                                jdata.PipelineConfig(*pc), step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_sparse_dataset_is_bitwise_the_reference():
    got = tdata.make_sparse_dataset(n_features=64, n_examples=128, seed=3)
    want = jdata.make_sparse_dataset(n_features=64, n_examples=128, seed=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    X, y, w = got
    assert tdata.hinge_loss(w, X, y) == jdata.hinge_loss(w, X, y)
    assert tdata.accuracy(w, X, y) == jdata.accuracy(w, X, y) == 1.0


# -- flash backward -------------------------------------------------------------------

FLASH_BWD_CASES = [
    # B, Sq, Sk, H, K, D, causal, q_offset, block_k
    (2, 40, 40, 4, 4, 16, True, 0, 16),       # G 1, ragged last tile
    (2, 24, 37, 8, 2, 16, False, 0, 16),      # G 4, non-causal, ragged Sk
    (1, 20, 50, 8, 2, 32, True, 30, 16),      # G 4, q_offset, ragged Sk
    (2, 32, 32, 4, 1, 16, True, 0, 16),       # MQA, whole tiles
    (1, 16, 16, 4, 4, 16, False, 0, 512),     # one tile shorter than block_k
]


def _flash_inputs(case, dtype, seed=0):
    Bq, Sq, Sk, H, K, D = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((Bq, Sq, H, D), (Bq, Sk, K, D), (Bq, Sk, K, D),
                      (Bq, Sq, H, D))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_backward_matches_jax_vjp(case, dtype):
    """The plain flash backward, fed the plain forward's statistics,
    against ``jax.vjp`` of the reference's custom-VJP flash attention."""
    causal, off, bk = case[6:]
    q, k, v, do = _flash_inputs(case, dtype)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    fn = lambda q, k, v: jax_flash(q, k, v, causal=causal, q_offset=off,
                                   backend="xla", block_k=bk)
    _, vjp = jax.vjp(fn, *(jnp.asarray(x, jd) for x in (q, k, v)))
    want = vjp(jnp.asarray(do, jd))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(td) for x in (q, k, v, do))
    out, lse = attention_ref(tq, tk, tv, causal=causal, q_offset=off,
                             return_stats=True)
    assert lse.shape == (tq.shape[0], tq.shape[2], tq.shape[1])
    got = flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal=causal,
                              q_offset=off, block_k=bk)
    tol = FLASH_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == td
        np.testing.assert_allclose(_f32(g), _f32(w), atol=tol, rtol=tol)
    # and against autograd through the plain forward
    xs = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    attention_ref(*xs, causal=causal, q_offset=off).backward(tdo)
    for g, x in zip(got, xs):
        np.testing.assert_allclose(_f32(g), _f32(x.grad), atol=tol, rtol=tol)


def test_attention_stats_are_the_rows_logsumexp():
    q, k, v, _ = _flash_inputs((2, 9, 13, 4, 2, 16), "float32")
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = attention_ref(tq, tk, tv, causal=True, q_offset=3,
                             return_stats=True)
    assert torch.equal(out, attention_ref(tq, tk, tv, causal=True,
                                          q_offset=3))
    s = torch.einsum("bqkgd,bskd->bkgqs",
                     tq.reshape(2, 9, 2, 2, 16) * 16 ** -0.5, tk)
    mask = torch.arange(13)[None, :] > (3 + torch.arange(9))[:, None]
    want = torch.logsumexp(s.masked_fill(mask, -1e30), -1).reshape(2, 4, 9)
    torch.testing.assert_close(lse, want, atol=1e-6, rtol=1e-6)


# -- the loss ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [0, 8, 5, 16])
def test_chunked_loss_and_grads_match_jax(chunk):
    """softmax_xent under chunked_loss (8: two chunks; 5 does not divide S,
    16 is S: one chunk), the loss and its gradients in h and the
    embedding (tied: the unembedding is its transpose)."""
    jcfg, tcfg = _cfgs(DENSE, "float32")
    rng = np.random.default_rng(3)
    emb = (rng.standard_normal((tcfg.vocab_size, tcfg.d_model)) * 0.2
           ).astype(np.float32)
    h = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    tg = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    jfn = lambda e, h: JL.chunked_loss({"embed": e}, jcfg, h, jnp.asarray(tg),
                                       jnp.asarray(mask), chunk)
    jloss, (je, jh) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(emb), jnp.asarray(h))

    class P(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = torch.nn.Parameter(torch.from_numpy(emb))

    p, th = P(), torch.from_numpy(h).requires_grad_()
    loss = L.chunked_loss(p, tcfg, th, torch.from_numpy(tg),
                          torch.from_numpy(mask), chunk)
    loss.backward()
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    np.testing.assert_allclose(p.embed.grad.numpy(), np.asarray(je),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jh), atol=1e-6,
                               rtol=1e-5)
    nll, denom = L.softmax_xent(th @ p.embed.T, torch.from_numpy(tg),
                                torch.from_numpy(mask))
    jnll, jden = JL.softmax_xent(jnp.asarray(h) @ jnp.asarray(emb).T,
                                 jnp.asarray(tg), jnp.asarray(mask))
    assert float(nll) == pytest.approx(float(jnll), rel=1e-5)
    assert float(denom) == float(jden)


# -- forward_train and its gradients ---------------------------------------------------------

@pytest.mark.parametrize("arch,dtype", [(DENSE, "float32"),
                                        (DENSE, "bfloat16"),
                                        (MOE, "float32"),
                                        (SSM, "float32"), (SSM, "bfloat16"),
                                        (HYBRID, "float32"),
                                        (HYBRID, "bfloat16")])
def test_forward_train_loss_and_every_gradient_match_jax(arch, dtype):
    jmodel, jparams, model, params = _models(arch, dtype)
    batch = _batch(jmodel.cfg, seq=_seq(arch))
    (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    total, metrics, grads = _port_grads(model, params, batch)
    tol = MODEL_TOL[dtype]
    for got, want in ((total, jtotal), (metrics["loss"], jm["loss"]),
                      (metrics["aux_loss"], jm["aux_loss"])):
        np.testing.assert_allclose(float(got), float(want), rtol=tol,
                                   atol=tol)
    if arch == MOE:
        assert float(metrics["aux_loss"]) > 0
    got = to_jax_params(grads, model.cfg)
    # the tied embedding's gradient: lookup plus unembedding
    np.testing.assert_allclose(_f32(got["embed"]), _f32(jgrads["embed"]),
                               atol=tol, rtol=tol)
    _assert_trees_close(got, jgrads, tol)


def test_remat_policies_give_equal_gradients():
    _remat_policies_give_equal_gradients(DENSE)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_remat_policies_give_equal_gradients(arch):
    """Each Mamba layer and each shared-block application under remat
    none, full and dots: the same gradients."""
    _remat_policies_give_equal_gradients(arch)


def _remat_policies_give_equal_gradients(arch):
    _, _, model, params = _models(arch, "float32", remat="none")
    batch = _batch(model.cfg, seq=_seq(arch))
    want = _port_grads(model, params, batch)[2]
    for remat in ("full", "dots"):
        m = build_model(model.cfg, model.ec.with_overrides(remat=remat))
        got = _port_grads(m, params, batch)[2]
        for n in want:
            torch.testing.assert_close(got[n], want[n], atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="remat"):
        build_model(model.cfg, model.ec.with_overrides(remat="some")).loss(
            params, {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("full", 2),
                                             ("dots", 2)])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_train_step_calls_the_scan_kernel_per_forward(monkeypatch, arch,
                                                          remat, per_layer):
    """The card's route on CPU tensors: ``ssd`` sends each Mamba layer
    through ``SSDScanFn``, whose kernel call (stood in for by the plain
    version) runs once per layer in the forward and once more in the
    remat recompute; the gradients are the plain path's, bitwise."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    _, _, model, params = _models(arch, "float32", remat=remat)
    batch = _batch(model.cfg, seq=_seq(arch))
    want = _port_grads(model, params, batch)[2]
    calls = []

    def kernel(*a):
        calls.append(a[-1])
        return ssd_ops.ssd_chunked(*a)

    monkeypatch.setattr(ssd_ops, "dispatch", lambda backend, x: "cuda")
    monkeypatch.setattr(ssd_ops, "_ssd_cuda", kernel)
    got = _port_grads(model, params, batch)[2]
    assert len(calls) == per_layer * model.cfg.n_layers
    for n in want:
        assert torch.equal(got[n], want[n]), n


# -- three train steps -------------------------------------------------------------------------

@pytest.mark.parametrize("arch,opt", [
    (DENSE, "sgd"), (DENSE, "adamw"), (SSM, "sgd"), (SSM, "adamw"),
    (HYBRID, "sgd"), (HYBRID, "adamw")], ids=[
    "sgd", "adamw", f"{SSM}-sgd", f"{SSM}-adamw", f"{HYBRID}-sgd",
    f"{HYBRID}-adamw"])
def test_three_train_steps_match_the_reference(arch, opt):
    """``make_train_step`` against the reference launcher's ``raw_step``
    (value_and_grad, then the update) from the same parameters and
    batches: the loss at each step and the parameters after the last.
    AdamW divides each gradient by its own magnitude plus eps, so an entry
    whose gradient is ~eps (1e-8; the tied embedding has some at 5e-8)
    turns a 1e-9 difference between the packages' gradients into a step
    difference of ~lr/10: here AdamW runs with eps 1e-3, where the
    packages' gradients (1e-4 apart) move its steps by less than 1e-7.
    Its math at the default eps is held apart, on equal gradients
    (``test_optimizer_matches_jax``)."""
    jmodel, jparams, model, params = _models(arch, "float32")
    spec = dict(OPTS[opt], **({"eps": 1e-3} if opt == "adamw" else {}))
    jopt = _opt(joptim, spec, joptim.warmup_cosine(0.05, 1, 3))
    topt = _opt(toptim, spec, toptim.warmup_cosine(0.05, 1, 3))

    @jax.jit
    def raw_step(params, state, batch):
        (loss, m), grads = jax.value_and_grad(jmodel.loss, has_aux=True)(
            params, batch)
        params, state = jopt.update(grads, state, params)
        return params, state, dict(m, loss=loss)

    shape = ShapeConfig("t", "train", _seq(arch), B)
    step = make_train_step(model, topt, shape)
    jstate, tstate = jopt.init(jparams), topt.init(params)
    for i in range(3):
        batch = _batch(jmodel.cfg, seq=_seq(arch), step=i)
        jparams, jstate, jm = raw_step(
            jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        params, tstate, tm = step(params, tstate, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) > 0
    _assert_trees_close(to_jax_params(params, model.cfg), jparams, 1e-4)


# -- checkpoints --------------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["sgd_momentum", "adamw"])
@pytest.mark.parametrize("arch", [DENSE, MOE, SSM, HYBRID])
def test_checkpoints_move_between_the_packages(tmp_path, arch, opt):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(2))
    jopt, topt = _opt(joptim, OPTS[opt], 1e-2), _opt(toptim, OPTS[opt], 1e-2)
    jstate = jopt.init(jparams)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tstate = topt.init(params)
    # the port's files are the reference's, path for path
    jckpt.Checkpointer(str(tmp_path / "jax"), keep=2).save(
        4, (jparams, jstate), blocking=True, extra={"loss": 1.5})
    tckpt.Checkpointer(str(tmp_path / "torch"), keep=2).save(
        4, (params, tstate), blocking=True, extra={"loss": 1.5})
    mj = json.loads((tmp_path / "jax" / "step_4" / "manifest.json").read_text())
    mt = json.loads((tmp_path / "torch" / "step_4" / "manifest.json").read_text())
    for key in ("step", "paths", "dtypes", "shapes", "extra"):
        assert mt[key] == mj[key], key
    # JAX -> port, into zeroed parameters and fresh state
    blank = from_jax_params(jax.tree.map(lambda x: np.zeros_like(x),
                                         jax.tree.map(np.asarray, jparams)),
                            tcfg, "cpu")
    (back, bstate), step, extra = tckpt.Checkpointer(
        str(tmp_path / "jax")).restore((blank, topt.init(blank)))
    assert back is blank and step == 4 and extra == {"loss": 1.5}
    for a, b in zip(back.parameters(), params.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert bstate.step.dtype == torch.int32 and int(bstate.step) == 0
    # port -> JAX
    (jback, _), _, _ = jckpt.Checkpointer(str(tmp_path / "torch")).restore(
        (jparams, jstate))
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jparams)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpointer_async_gc_and_refusals(tmp_path):
    _, _, _, params = _models(DENSE, "float32")
    opt = toptim.SGD()
    ck = tckpt.Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(s, (params, opt.init(params)))       # async
    ck.wait()
    assert ck.steps() == [2, 3] and ck.latest_step() == 3
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())
    with pytest.raises(ValueError, match="leaves"):
        ck.restore((params, toptim.SGD(momentum=0.9).init(params)))
    with pytest.raises(FileNotFoundError):
        tckpt.Checkpointer(str(tmp_path / "empty")).restore(params)


def test_in_repo_checkpoint_resumes_in_the_port():
    """``artifacts/train_ckpt/step_3`` (the reference launcher's ``--smoke``
    run) restores in the port without ml_dtypes, and one more step from it
    gives the reference's loss and parameters."""
    jcfg, tcfg = jax_smoke_config(DENSE), smoke_config(DENSE)
    jmodel = jax_build_model(jcfg, JaxExecConfig(backend="xla", loss_chunk=16))
    jopt = joptim.SGD(lr=joptim.warmup_cosine(0.05, 1, 5))
    jtemplate = jmodel.init(jax.random.PRNGKey(0))
    (jparams, jstate), jstep, _ = jckpt.Checkpointer(str(CKPT)).restore(
        (jtemplate, jopt.init(jtemplate)))
    model = build_model(tcfg, ExecConfig(loss_chunk=16))
    topt = toptim.SGD(lr=toptim.warmup_cosine(0.05, 1, 5))
    params = trainable(model.init(torch.Generator().manual_seed(0), "cpu"))
    (params, tstate), step, _ = tckpt.Checkpointer(str(CKPT)).restore(
        (params, topt.init(params)))
    assert step == jstep == 3 and int(tstate.step) == int(jstate.step)
    assert all(p.dtype == torch.bfloat16 for p in params.parameters())
    batch = jdata.make_batch(jcfg, smoke_shape("train"),
                             jdata.PipelineConfig(seed=0), step)
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jparams, _ = jopt.update(jgrads, jstate, jparams)
    tstep = make_train_step(model, topt, smoke_shape("train"))
    params, tstate, metrics = tstep(params, tstate, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=MODEL_TOL["bfloat16"])
    _assert_trees_close(to_jax_params(params, tcfg), jparams,
                        MODEL_TOL["bfloat16"])


@pytest.mark.parametrize("tier", ["jax", "torch"])
def test_global_tier_round_trip(tmp_path, tier):
    """save_global_tier / restore_global_tier on the port's GlobalTier; a
    file either package wrote restores in the other."""
    gt = GlobalTier(device="cpu")
    gt.set("w", np.arange(12, dtype=np.float32).tobytes(), host="h")
    gt.set("stats/serve", b"\x01\x02\x03", host="h")
    save = tckpt.save_global_tier if tier == "torch" else \
        jckpt.save_global_tier
    if tier == "torch":
        path = save(gt, str(tmp_path))
    else:
        jgt = JaxGlobalTier()
        for key in gt.keys():
            jgt.set(key, gt.get(key, host="h"), host="h")
        path = save(jgt, str(tmp_path))
    assert os.path.exists(path)
    back = GlobalTier(device="cpu")
    assert tckpt.restore_global_tier(back, str(tmp_path)) == 2
    for key in gt.keys():
        assert back.get(key, host="x") == gt.get(key, host="x")
    jback = JaxGlobalTier()
    assert jckpt.restore_global_tier(jback, str(tmp_path)) == 2


# -- the launchers ---------------------------------------------------------------------------

def test_train_launcher_runs_on_the_cpu_when_asked(tmp_path):
    _train_launcher_runs_on_the_cpu(tmp_path, [])


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_train_launcher_runs_on_the_cpu_when_asked(tmp_path, arch):
    _train_launcher_runs_on_the_cpu(tmp_path, ["--arch", arch])


def _train_launcher_runs_on_the_cpu(tmp_path, arch_args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "3", "--ckpt-dir", str(tmp_path)]
        + arch_args, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "step     2 loss" in r.stdout and r.stdout.rstrip().endswith("done")
    manifest = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert manifest["paths"][-1] == "[1].step"
    # and resumes from its own checkpoint
    out = ttrain.main(["--smoke", "--device", "cpu", "--steps", "4",
                       "--ckpt-dir", str(tmp_path), "--resume"] + arch_args)
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])


def test_train_launcher_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="needs a process group of 512"):
        ttrain.main(["--multi-pod", "--device", "cpu"])


def test_example_twin_prints_the_reference_lines(tmp_path):
    sys.path.insert(0, str(REPO / "examples"))
    import train_lm_torch as twin
    out = twin.main(["--smoke", "--device", "cpu", "--steps", "3",
                     "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 3
    assert all(np.isfinite(float(x)) for x in out["losses"])
    assert tckpt.Checkpointer(str(tmp_path)).latest_step() == 3


def _masked(text: str, ckpt_dir) -> list:
    """Output lines with the checkpoint directory and every number (and
    the padding before it) masked: the lines' wording, not their values."""
    text = text.replace(str(ckpt_dir), "<dir>")
    return [re.sub(r"\s*\d+(\.\d+)?", " #", ln) for ln in text.splitlines()]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_example_twin_prints_the_reference_lines(tmp_path, arch, capsys):
    """The twin and ``examples/train_lm.py`` for an SSM architecture: the
    same header line (name, parameter count, steps, batch and sequence)
    and the same lines after it, numbers aside."""
    sys.path.insert(0, str(REPO / "examples"))
    import train_lm_torch as twin
    argv = ["--arch", arch, "--smoke", "--steps", "3", "--ckpt-every", "0"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "examples" / "train_lm.py")]
                       + argv + ["--ckpt-dir", str(tmp_path / "jax")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    capsys.readouterr()
    out = twin.main(argv + ["--device", "cpu", "--ckpt-dir",
                            str(tmp_path / "torch")])
    printed = capsys.readouterr().out
    assert printed.splitlines()[0] == r.stdout.splitlines()[0]
    assert _masked(printed, tmp_path / "torch") == \
        _masked(r.stdout, tmp_path / "jax")
    assert len(out["losses"]) == 3
    assert all(np.isfinite(float(x)) for x in out["losses"])
    assert tckpt.Checkpointer(str(tmp_path / "torch")).latest_step() == 3
