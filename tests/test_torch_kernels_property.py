"""The hypothesis properties of ``tests/test_kernels_property.py`` through
the port's plain versions on the CPU, under the same names, strategies,
settings and tolerances: on each drawn input the JAX package's function
and the port's give the same result, and the port's meets the
reference's property (flash attention of any shape against the reference
attention; the int8 push's error within absmax/127 a 128-lane row, its
scales within one ULP of JAX's and its codes one step at most; the
grouped matmul over any grouping).  The kernels themselves (K5, K1 then
K2, K7) are held against these plain versions over the same strategies
on the card, in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.moe_gmm import gmm as jax_gmm
from repro.kernels.moe_gmm import gmm_ref as jax_gmm_ref
from repro.kernels.state_push import apply_delta as jax_apply_delta
from repro.kernels.state_push import quantize_delta as jax_quantize_delta
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.moe_gmm import gmm, gmm_ref
from repro_torch.kernels.state_push import apply_delta, quantize_delta

SETTINGS = dict(max_examples=20, deadline=None)


@settings(**SETTINGS)
@given(
    B=st.integers(1, 2),
    Sq=st.integers(1, 12),
    Sk=st.integers(1, 12),
    G=st.integers(1, 3),
    K=st.integers(1, 2),
    causal=st.booleans(),
    seed=st.integers(0, 2**16),
)
def test_flash_any_shape_matches_ref(B, Sq, Sk, G, K, causal, seed):
    rng = np.random.default_rng(seed)
    D = 8
    H = K * G
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, K, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, K, D)).astype(np.float32)
    off = max(0, Sk - Sq) if causal else 0
    ref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, q_offset=off)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, q_offset=off, backend="xla", block_k=4)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal, q_offset=off)
    port_ref = attention_ref(tq, tk, tv, causal=causal, q_offset=off)
    np.testing.assert_allclose(ref, got.numpy(), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(want, got.numpy(), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(ref, port_ref.numpy(), atol=3e-5, rtol=3e-5)


@settings(**SETTINGS)
@given(n=st.integers(1, 500), seed=st.integers(0, 2**16),
       scale=st.floats(1e-3, 1e3))
def test_push_delta_bounded_error(n, seed, scale):
    """|dequant(quant(delta)) - delta| <= absmax/127 per 128-lane row."""
    rng = np.random.default_rng(seed)
    local = (rng.normal(size=(n,)) * scale).astype(np.float32)
    base = (rng.normal(size=(n,)) * scale).astype(np.float32)
    gv = np.zeros((n,), np.float32)
    jq, js, _ = jax_quantize_delta(jnp.asarray(local), jnp.asarray(base),
                                   backend="xla")
    jgot = jax_apply_delta(jnp.asarray(gv), jq, js, backend="xla")
    q, s, _ = quantize_delta(torch.from_numpy(local), torch.from_numpy(base),
                             device="cpu")
    got = apply_delta(torch.from_numpy(gv), q, s, device="cpu")
    # the scales within one f32 ULP of JAX's (XLA may divide by 127 as a
    # product), the codes equal where the scales are, else one step apart
    # (``tests/test_torch_state_push.py`` holds the same)
    sp, sj = s.numpy(), np.asarray(js)
    ulps = np.abs(sp.view(np.int32).astype(np.int64)
                  - sj.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    qp, qj = q.numpy().astype(np.int32), np.asarray(jq, np.int32)
    same = (sp == sj)[:, 0]
    np.testing.assert_array_equal(qp[same], qj[same])
    assert np.abs(qp - qj).max() <= 1
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=0,
                               atol=float(sp.max()) * 1.01)
    delta = local - base
    err = np.abs(got.numpy() - delta)
    bound = np.abs(delta).max() / 127.0 * 1.01 + 1e-9
    assert err.max() <= bound


@settings(**SETTINGS)
@given(T=st.integers(1, 40), E=st.integers(1, 6), seed=st.integers(0, 2**16))
def test_gmm_any_grouping(T, E, seed):
    rng = np.random.default_rng(seed)
    d, f = 8, 8
    x = rng.normal(size=(T, d)).astype(np.float32)
    w = rng.normal(size=(E, d, f)).astype(np.float32)
    cuts = np.sort(rng.integers(0, T + 1, size=E - 1)) if E > 1 else np.array([], int)
    gs = np.diff(np.concatenate([[0], cuts, [T]])).astype(np.int32)
    ref = jax_gmm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    want = jax_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                   backend="xla")
    tx, tw, tgs = (torch.from_numpy(a) for a in (x, w, gs))
    got = gmm(tx, tw, tgs)
    np.testing.assert_allclose(ref, got.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(want, got.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ref, gmm_ref(tx, tw, tgs).numpy(), atol=1e-4,
                               rtol=1e-4)
