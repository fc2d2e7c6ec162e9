"""The port's MoE decoder (deepseek-moe-16b) against the JAX package's.

Inputs come from a numpy seed and go through both packages on the CPU:
JAX on ``backend="xla"`` (``gmm`` also in Pallas interpret mode), the
port on its plain PyTorch versions.  Tolerances:

* ``gmm``: 1e-4 in f32, the reference's own (``tests/test_kernels.py``);
* ``router_topk`` and ``moe_apply`` (einsum and sorted dispatch, a
  capacity that drops tokens included): 1e-5 in f32, identical expert
  choices;
* the smoke model through ``from_jax_params``: 1e-4 in f32 with identical
  token ids; 5e-2 in bf16 (the tolerance of ``test_arch_smoke``),
  teacher-forced with the JAX tokens, with the argmax held too.

The CUDA kernel K7 is held against the plain version on the card by
``test_torch_cuda.py``.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.moe_gmm import gmm as jax_gmm
from repro.kernels.moe_gmm import gmm_ref as jax_gmm_ref
from repro.models import ExecConfig as JaxExecConfig
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.moe_gmm import gmm, gmm_ref
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.launch import serve
from repro_torch.models import ExecConfig, build_model
from repro_torch.models import moe
from repro_torch.models.weights import (from_jax_params, init_params,
                                         jax_leaf, numpy_to_torch)

ARCH = "deepseek-moe-16b"
B, S, STEPS = 2, 16, 4
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
MOE_TOL = 1e-5

# the cases of tests/test_kernels.py (T, d, f, E), then an empty-group and
# a tail case: group sizes from cut points, from a list, or with a tail
GMM_CASES = {
    "64x32x48e4": (64, 32, 48, 4, None),
    "100x16x16e5": (100, 16, 16, 5, None),
    "40x8x24e3": (40, 8, 24, 3, None),
    "empty_groups": (32, 8, 8, 4, [0, 32, 0, 0]),
    "tail": (48, 16, 24, 4, [5, 0, 20, 3]),
}


def _gmm_inputs(case, seed=0):
    T, d, f, E, sizes = GMM_CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, d)).astype(np.float32)
    w = rng.normal(size=(E, d, f)).astype(np.float32)
    if sizes is None:
        cuts = np.sort(rng.integers(0, T + 1, size=E - 1))
        sizes = np.diff(np.concatenate([[0], cuts, [T]]))
    return x, w, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("against", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("case", list(GMM_CASES))
def test_gmm_matches_jax(case, against):
    x, w, gs = _gmm_inputs(case)
    if against == "ref":
        want = jax_gmm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    else:
        want = jax_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                       backend="pallas_interpret", block_m=8, block_n=8)
    got = gmm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(gs))
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], w.shape[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    tail = int(gs.sum())
    assert not got[tail:].any()                    # rows past the groups


def test_gmm_bf16_accumulates_in_f32():
    x, w, gs = _gmm_inputs("64x32x48e4")
    xt, wt = (torch.from_numpy(a).bfloat16() for a in (x, w))
    want = jax_gmm_ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                       jnp.asarray(gs))
    got = gmm(xt, wt, torch.from_numpy(gs))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


def test_gmm_backend_torch_is_the_plain_version():
    x, w, gs = (torch.from_numpy(a) for a in _gmm_inputs("tail"))
    assert torch.equal(gmm(x, w, gs, backend="torch"), gmm_ref(x, w, gs))


def _bad_gmm_args():
    x, w = torch.zeros(24, 64), torch.zeros(4, 64, 32)
    gs = torch.zeros(4, dtype=torch.int32)
    return {    # case: (expected message, operands)
        "dtype": ("dtypes", (x.half(), w.half(), gs)),
        "mixed": ("dtypes", (x, w.bfloat16(), gs)),
        "ragged_f": ("multiples of 8", (x, torch.zeros(4, 64, 30), gs)),
        "ragged_d": ("multiples of 8", (torch.zeros(24, 60),
                                        torch.zeros(4, 60, 32), gs)),
        "inner": (r"w \(4, 32, 32\)", (x, torch.zeros(4, 32, 32), gs)),
        "sizes_dtype": ("group_sizes", (x, w, gs.long())),
        "sizes_shape": ("group_sizes", (x, w, torch.zeros(5, dtype=torch.int32))),
        "strides": ("contiguous", (torch.zeros(64, 24).T, w, gs)),
    }


@pytest.mark.parametrize("case", list(_bad_gmm_args()))
def test_gmm_wrapper_refuses_before_launch(case):
    """The CUDA path checks its operands before anything is built or
    launched (called here directly on CPU tensors)."""
    message, args = _bad_gmm_args()[case]
    n = gmm_ops.LAUNCHES.value
    with pytest.raises(ValueError, match=message):
        gmm_ops._gmm_cuda(*args)
    assert gmm_ops.LAUNCHES.value == n


# -- the MoE layer ------------------------------------------------------------

def _moe_setup(capacity_factor=8.0, seed=0, tokens=(2, 16)):
    """The smoke MoE layer's JAX params and the port's MoE module holding
    the same values, and an input from a numpy seed."""
    kw = dict(capacity_factor=capacity_factor, dtype="float32",
              param_dtype="float32")
    jcfg = jax_smoke_config(ARCH).with_overrides(**kw)
    tcfg = smoke_config(ARCH).with_overrides(**kw)
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), jcfg)
    tp = moe.MoE(tcfg, device="cpu")
    with torch.no_grad():
        for name, p in tp.named_parameters():
            p.copy_(numpy_to_torch(jax_leaf(jp, name)))
    x = np.random.default_rng(seed).normal(
        size=(*tokens, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def test_router_topk_matches_jax():
    jcfg, tcfg, jp, tp, x = _moe_setup()
    x2d = x.reshape(-1, tcfg.d_model)
    jg, ji, ja = jax_moe.router_topk(jp, jcfg, jnp.asarray(x2d))
    tg, ti, ta = moe.router_topk(tp, tcfg, torch.from_numpy(x2d))
    assert ti.dtype == torch.int32 and tg.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=MOE_TOL,
                               rtol=MOE_TOL)
    np.testing.assert_allclose(float(ta), float(ja), atol=MOE_TOL,
                               rtol=MOE_TOL)


def test_router_topk_breaks_ties_by_lower_index():
    """Equal probabilities: the lower expert index first, as
    ``jax.lax.top_k``."""
    _, tcfg, _, tp, _ = _moe_setup()
    with torch.no_grad():
        tp.router.zero_()                        # every expert scores alike
    _, idx, _ = moe.router_topk(tp, tcfg, torch.ones(3, tcfg.d_model))
    assert idx.tolist() == [list(range(tcfg.experts_per_token))] * 3


MOE_CASES = {
    # name: (capacity factor, ExecConfig overrides, tokens (B, S))
    "einsum": (8.0, dict(moe_impl="einsum", moe_group_size=32), (2, 16)),
    "einsum_padded_groups": (8.0, dict(moe_impl="einsum", moe_group_size=12),
                             (2, 16)),
    "einsum_drops_tokens": (0.25, dict(moe_impl="einsum", moe_group_size=32),
                            (2, 16)),
    "einsum_capacity_override": (8.0, dict(moe_impl="einsum",
                                           moe_group_size=32,
                                           moe_capacity_override=0.5),
                                 (2, 16)),
    "sorted": (8.0, dict(moe_impl="sorted"), (2, 16)),
    "decode_sorted": (8.0, dict(), (4, 1)),
    "decode_einsum": (0.25, dict(moe_decode_impl="einsum",
                                 moe_group_size=32), (4, 1)),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_jax(case):
    cf, over, tokens = MOE_CASES[case]
    jcfg, tcfg, jp, tp, x = _moe_setup(capacity_factor=cf, tokens=tokens)
    jy, jaux = jax_moe.moe_apply(jp, jcfg, JaxExecConfig(backend="xla",
                                                         **over),
                                 jnp.asarray(x))
    ty, taux = moe.moe_apply(tp, tcfg, ExecConfig(**over), torch.from_numpy(x))
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=MOE_TOL,
                               rtol=MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=MOE_TOL,
                               rtol=MOE_TOL)


def test_low_capacity_drops_tokens_to_the_shared_experts():
    """A token dropped from every routed expert keeps only the shared
    experts' output, in both packages."""
    cf, over, tokens = MOE_CASES["einsum_drops_tokens"]
    _, tcfg, _, tp, x = _moe_setup(capacity_factor=cf, tokens=tokens)
    xt = torch.from_numpy(x)
    y, _ = moe.moe_apply(tp, tcfg, ExecConfig(**over), xt)
    shared = moe.shared_expert_apply(tp, xt.reshape(-1, tcfg.d_model))
    dropped = torch.isclose(y.reshape(-1, tcfg.d_model), shared,
                            atol=1e-6).all(-1)
    assert 0 < int(dropped.sum()) < dropped.numel()


def test_einsum_and_sorted_agree_without_drops():
    _, tcfg, _, tp, x = _moe_setup(capacity_factor=8.0)
    xt = torch.from_numpy(x)
    ye, ae = moe.moe_apply(tp, tcfg, ExecConfig(moe_group_size=32), xt)
    ys, as_ = moe.moe_apply(tp, tcfg, ExecConfig(moe_impl="sorted"), xt)
    torch.testing.assert_close(ye, ys, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(ae, as_)


# -- the whole smoke model ----------------------------------------------------

def _cfgs(dtype, **kw):
    kw.update(dtype=dtype, param_dtype=dtype)
    return (jax_smoke_config(ARCH).with_overrides(**kw),
            smoke_config(ARCH).with_overrides(**kw))


def _run_jax(cfg, params, tokens, teacher=None):
    model = jax_build_model(cfg, JaxExecConfig(backend="xla"))
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
    assert set(cache) == {"k", "v", "first_k", "first_v"}
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


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_config_is_a_copy():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))
    assert dataclasses.asdict(smoke_config(ARCH)) == \
        dataclasses.asdict(jax_smoke_config(ARCH))


def test_full_width_parameter_count():
    """16.4 B parameters at full width, counted on the meta device."""
    from repro_torch.models.transformer import Transformer
    cfg = get_config(ARCH)
    n = sum(p.numel() for p in Transformer(cfg, device="meta").parameters())
    assert n == cfg.param_count()
    assert abs(n / 16.4e9 - 1) < 0.03, n


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


def _record_routing(monkeypatch):
    """Every router_topk call's expert sets, per package, in call order."""
    rec = {"jax": [], "torch": []}
    j_fn, t_fn = jax_moe.router_topk, moe.router_topk

    def j_wrap(p, cfg, x2d):
        out = j_fn(p, cfg, x2d)
        rec["jax"].append(np.sort(np.asarray(out[1]), -1))
        return out

    def t_wrap(p, cfg, x2d):
        out = t_fn(p, cfg, x2d)
        rec["torch"].append(np.sort(out[1].numpy(), -1))
        return out

    monkeypatch.setattr(jax_moe, "router_topk", j_wrap)
    monkeypatch.setattr(moe, "router_topk", t_wrap)
    return rec


def _clean_rows(rec, n_moe):
    """Which logits rows no routing flip can have reached.  A flip (a
    (token, layer) whose expert set differs between the packages) moves
    that token's hidden state by about a gate times an expert difference,
    and attention carries it to every later position of its sequence; so
    a row is clean when no token at or before it, in its sequence, flipped
    in any layer.  Calls come as: the full forward, the prefill, then one
    per decode step, each n_moe layers deep."""
    flips = [(a != b).any(-1) for a, b in zip(rec["jax"], rec["torch"])]
    assert len(flips) == n_moe * (2 + STEPS)
    per_call = [np.any(flips[i:i + n_moe], axis=0)
                for i in range(0, len(flips), n_moe)]
    fwd = np.logical_or.accumulate(per_call[0].reshape(B, S), axis=1)
    prompt = per_call[1].reshape(B, S).any(1)
    steps = np.logical_or.accumulate(np.stack(per_call[2:]), axis=0)
    share = float(np.mean(np.concatenate([f.ravel() for f in flips])))
    return ~fwd, [~prompt] + [~(prompt | s) for s in steps], share


def test_bf16_checkpoint_matches_jax(monkeypatch):
    """A bf16 parameter tree of the JAX model (loaded bit-exactly),
    teacher-forced with the JAX tokens.  bf16 rounds apart in the two
    frameworks, so a near-tie between the k-th and (k+1)-th expert can pick
    another expert (a routing flip); rows a flip can reach are excused from
    the 5e-2 logit tolerance, and the argmax must still agree on 90% of all
    rows."""
    jcfg, tcfg = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray,
                        jax_build_model(jcfg).init(jax.random.PRNGKey(1)))
    jparams = jax.tree.map(jnp.asarray, tree)
    params = from_jax_params(tree, tcfg, "cpu")
    w = params.layers[0].moe.w_gate
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.view(torch.uint16).numpy(),
        np.asarray(tree["layers"]["moe"]["w_gate"][0]).view(np.uint16))
    assert params.layers[0].moe.router.dtype == torch.float32
    tokens = _tokens(tcfg, seed=1)
    j_ids = _run_jax(jcfg, jparams, jnp.asarray(tokens))[2]
    rec = _record_routing(monkeypatch)
    with jax.disable_jit():                    # _run_jax's decode as well
        j_logits, j_steps, _ = _run_jax(jcfg, jparams, jnp.asarray(tokens),
                                        teacher=j_ids)
    t_logits, t_steps, t_ids = _run_port(tcfg, params, tokens, teacher=j_ids)
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


def test_init_params_std_per_module():
    """Each leaf is drawn with its own module's std: the first dense
    layer's, the experts' and the shared experts' down projections differ
    (n_shared 2 here, so the shared width is twice the experts'), and the
    router is f32 in a bf16 model."""
    jcfg, tcfg = _cfgs("bfloat16", n_shared_experts=2)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    got = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    stds = {}
    for name, p in got.named_parameters():
        ref, x = np.asarray(jax_leaf(want, name)), p.float().numpy()
        if ref.std() == 0:
            np.testing.assert_array_equal(x, ref)        # zeros and ones
            continue
        assert abs(x.std() / ref.std() - 1) < 0.08, name
        assert np.abs(x).max() <= np.abs(ref).max() * 1.05, name
        stds[name] = x.std()
    # a truncated (at 2) normal has 0.8796 of its scale as std
    d, f, fd = tcfg.d_model, tcfg.moe_d_ff, tcfg.dense_d_ff
    expected = {"first_layers.0.mlp.w_down": fd ** -0.5,
                "layers.0.moe.w_down": f ** -0.5,
                "layers.0.moe.shared.w_down": (2 * f) ** -0.5,
                "layers.0.moe.router": d ** -0.5}
    for name, std in expected.items():
        assert abs(stds[name] / (0.8796 * std) - 1) < 0.08, name
    assert got.layers[0].moe.router.dtype == torch.float32
    assert got.layers[0].moe.w_down.dtype == torch.bfloat16


def test_serve_smoke_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--new-tokens", "4", "--batch", "3"], keep_logits=True)
    out = capsys.readouterr().out
    assert re.search(r"deepseek-moe-16b-smoke: prefill 16 toks in [\d.]+ms; "
                     r"3 decode steps in [\d.]+ms \([\d.]+ tok/s\)", out), out
    gen = res["gen"]
    assert gen.shape == (3, 4) and gen.dtype == torch.int32
    for i, lg in enumerate(res["logits"]):
        assert lg.shape == (3, res["cfg"].vocab_size)
        assert torch.equal(lg.argmax(-1).to(torch.int32), gen[:, i])
    assert len(res["params"].first_layers) == 1


@pytest.mark.parametrize("method", ["init", "init_cache"])
def test_model_runs_on_the_card_unless_told(method, monkeypatch):
    """Without a card, building with no device named raises instead of
    returning CPU tensors; naming the CPU works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(smoke_config(ARCH))
    call = {"init": lambda **kw: model.init(torch.Generator(), **kw),
            "init_cache": lambda **kw: model.init_cache(2, 8, **kw)}[method]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    out = call(device="cpu")
    tensors = (list(out.parameters()) if method == "init"
               else list(out.values()))
    assert tensors and all(t.device.type == "cpu" for t in tensors)
