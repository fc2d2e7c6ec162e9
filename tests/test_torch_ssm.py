"""The port's SSM family (mamba2-130m, zamba2-1.2b) against the JAX package's.

Inputs come from a numpy seed and go through both packages on the CPU:
JAX on ``backend="xla"`` (the SSD scan also through its sequential oracle
and in Pallas interpret mode), the port on its plain PyTorch versions.
Tolerances:

* the SSD scan (``ssd``, ``ssd_ref``, ``ssd_step``): 1e-4 in f32, the
  reference's own (``tests/test_kernels.py``), on the reference's cases
  plus a ragged S;
* one Mamba2 layer (``mamba_apply_full`` with its returned state, then
  ``mamba_step``): 1e-4 in f32;
* the smoke models through ``from_jax_params``: 1e-4 in f32 with identical
  token ids; 5e-2 in bf16 (the tolerance of ``test_arch_smoke``),
  teacher-forced with the JAX tokens, with the argmax held too.

The SSD scan's gradients (autograd through the plain chunked scan, the
backward of ``SSDScanFn`` on the card) against ``jax.vjp`` of the
reference's xla path at 1e-4 in f32; ``SSDScanFn`` itself on CPU tensors
with the kernel call replaced by the plain version, its gradients equal
to autograd's through the plain version.  The CUDA kernel K8 is held
against the plain version on the card by ``test_torch_cuda.py``.
"""
import dataclasses
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.ssd_scan import ssd as jax_ssd
from repro.kernels.ssd_scan import ssd_ref as jax_ssd_ref
from repro.kernels.ssd_scan import ssd_step as jax_ssd_step
from repro.models import ExecConfig as JaxExecConfig
from repro.models import build_model as jax_build_model
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.ssd_scan import (SSDScanFn, ssd, ssd_chunked,
                                          ssd_ref, ssd_step)
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import serve
from repro_torch.models import ExecConfig, build_model
from repro_torch.models import ssm
from repro_torch.models.encdec import EncDec
from repro_torch.models.ssm_stack import SSMStack
from repro_torch.models.transformer import Transformer
from repro_torch.models.weights import (from_jax_params, init_params,
                                         jax_leaf, numpy_to_torch,
                                         params_class)

ARCHS = ("mamba2-130m", "zamba2-1.2b")
B, S, STEPS = 2, 16, 4
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
SSD_TOL = 1e-4

SSD_CASES = {
    # name: (Bt, S, H, P, G, N, chunk) -- tests/test_kernels.py's cases,
    # then an S that is no multiple of the chunk
    "2x32_h4_g2_c8": (2, 32, 4, 16, 2, 16, 8),
    "1x24_h6_g3_c8": (1, 24, 6, 8, 3, 8, 8),
    "2x16_h4_g1_c16": (2, 16, 4, 16, 1, 32, 16),
    "ragged_2x37_c16": (2, 37, 4, 16, 2, 16, 16),
}


def _ssd_inputs(case, seed=0):
    """The reference's distributions: x, B, C, D, init ~ N(0, 1);
    dt ~ U(0.01, 0.2); A ~ -U(0.5, 2)."""
    Bt, S_, H, P, G, N, chunk = SSD_CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Bt, S_, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(Bt, S_, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    Bm = rng.normal(size=(Bt, S_, G, N)).astype(np.float32)
    C = rng.normal(size=(Bt, S_, G, N)).astype(np.float32)
    D = rng.normal(size=(H,)).astype(np.float32)
    init = rng.normal(size=(Bt, H, P, N)).astype(np.float32)
    return (x, dt, A, Bm, C, D, init), chunk


@pytest.mark.parametrize("against", ["ref", "xla", "pallas_interpret"])
@pytest.mark.parametrize("port", ["ssd", "ssd_ref"])
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_matches_jax(case, port, against):
    args, chunk = _ssd_inputs(case)
    *ja, jinit = (jnp.asarray(a) for a in args)
    if against == "ref":
        want = jax_ssd_ref(*ja, initial_state=jinit)
    else:
        want = jax_ssd(*ja, chunk=chunk, initial_state=jinit, backend=against)
    *ta, tinit = (torch.from_numpy(a) for a in args)
    if port == "ssd":
        got = ssd(*ta, chunk=chunk, initial_state=tinit)
    else:
        got = ssd_ref(*ta, initial_state=tinit)
    assert got[0].dtype == torch.float32 and got[0].shape == args[0].shape
    assert got[1].dtype == torch.float32 and got[1].shape == args[-1].shape
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=SSD_TOL,
                                   rtol=SSD_TOL)


COTANGENTS = ("y", "final", "both")


def _cotangents(args, which, seed=1):
    """Upstream gradients of y and of the final state, None where absent."""
    rng = np.random.default_rng(seed)
    gy = rng.normal(size=args[0].shape).astype(np.float32)
    gf = rng.normal(size=args[-1].shape).astype(np.float32)
    return (gy if which != "final" else None,
            gf if which != "y" else None)


def _torch_grads(fn, args, cots):
    """Gradients of every operand of ``fn(x, dt, A, B, C, D, init)`` under
    the given cotangents, by autograd (zeros for an operand the used
    outputs do not depend on: C and D of the final state)."""
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    outs = fn(*ts)
    pairs = [(o, torch.from_numpy(g)) for o, g in zip(outs, cots)
             if g is not None]
    got = torch.autograd.grad([o for o, _ in pairs], ts,
                              [g for _, g in pairs], allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for g, t in zip(got, ts)]


@pytest.mark.parametrize("cotangent", COTANGENTS)
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_gradients_match_jax_vjp(case, cotangent):
    """The plain ``ssd`` under autograd (what ``SSDScanFn``'s backward
    recomputes) against ``jax.vjp`` of the reference's xla path, for every
    operand: G < H, a ragged S, a non-zero initial state, and a cotangent
    on y, on the final state or on both."""
    args, chunk = _ssd_inputs(case)
    cots = _cotangents(args, cotangent)
    jfn = lambda *a: jax_ssd(*a[:-1], chunk=chunk, initial_state=a[-1],
                             backend="xla")
    (jy, jf), vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    want = vjp(tuple(jnp.asarray(g) if g is not None else jnp.zeros_like(o)
                     for g, o in zip(cots, (jy, jf))))
    got = _torch_grads(lambda *t: ssd(*t[:-1], chunk=chunk,
                                      initial_state=t[-1]), args, cots)
    for name, g, w in zip("x dt A B C D initial_state".split(), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=SSD_TOL,
                                   rtol=SSD_TOL, err_msg=name)


def _plain_kernel(monkeypatch):
    """Stand K8's call in for the plain version on CPU tensors, counting
    calls, so that ``SSDScanFn`` runs here."""
    calls = []

    def fake(x, dt, A, B, C, D, init, chunk):
        calls.append(chunk)
        return ssd_chunked(x, dt, A, B, C, D, init, chunk)

    monkeypatch.setattr(ssd_ops, "_ssd_cuda", fake)
    return calls


@pytest.mark.parametrize("cotangent", COTANGENTS)
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_scan_fn_gradients_equal_the_plain_versions(monkeypatch, case,
                                                        cotangent):
    """``SSDScanFn``: one forward call of the kernel, which it does not
    differentiate, and a backward that recomputes the plain scan from the
    saved inputs: its gradients are autograd's through ``ssd_chunked``,
    bitwise, B's and C's summed over each group's heads."""
    args, chunk = _ssd_inputs(case)
    cots = _cotangents(args, cotangent)
    calls = _plain_kernel(monkeypatch)
    got = _torch_grads(lambda *t: SSDScanFn.apply(*t, chunk), args, cots)
    assert calls == [chunk]
    want = _torch_grads(lambda *t: ssd_chunked(*t, chunk), args, cots)
    for name, g, w in zip("x dt A B C D initial_state".split(), got, want):
        assert torch.equal(g, w), name


def test_ssd_scan_fn_returns_only_the_gradients_asked_for(monkeypatch):
    """x and C require grad, the final state is not used: their gradients
    are autograd's through the plain scan and no other operand gets one."""
    args, chunk = _ssd_inputs("2x32_h4_g2_c8")
    _plain_kernel(monkeypatch)
    asked = (0, 4)
    ts = [torch.from_numpy(a).requires_grad_(i in asked)
          for i, a in enumerate(args)]
    y, _ = SSDScanFn.apply(*ts, chunk)
    y.sum().backward()
    assert all((t.grad is not None) == (i in asked) for i, t in enumerate(ts))
    us = [torch.from_numpy(a).requires_grad_(i in asked)
          for i, a in enumerate(args)]
    ssd_chunked(*us, chunk)[0].sum().backward()
    for i in asked:
        assert torch.equal(ts[i].grad, us[i].grad)


def test_ssd_failure_in_training_raises_with_no_fallback(monkeypatch):
    """A kernel call that fails under autograd raises; nothing runs the
    plain version in its place."""
    args, chunk = _ssd_inputs("ragged_2x37_c16")
    plain = []

    def broken(*a):
        raise RuntimeError("ssd_scan: CUDA error 700 at launch")

    monkeypatch.setattr(ssd_ops, "_ssd_cuda", broken)
    monkeypatch.setattr(ssd_ops, "dispatch", lambda backend, x: "cuda")
    monkeypatch.setattr(ssd_ops, "ssd_chunked",
                        lambda *a: plain.append(1) or ssd_chunked(*a))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ssd(*ts[:-1], chunk=chunk, initial_state=ts[-1])
    assert plain == []


def test_ssd_bf16_output_dtype_and_f32_state():
    args, chunk = _ssd_inputs("ragged_2x37_c16")
    x, dt, A, Bm, C, D, init = (torch.from_numpy(a) for a in args)
    xb, Bb, Cb = x.bfloat16(), Bm.bfloat16(), C.bfloat16()
    y, f = ssd(xb, dt, A, Bb, Cb, D, chunk=chunk, initial_state=init)
    yr, fr = ssd_ref(xb, dt, A, Bb, Cb, D, initial_state=init)
    assert y.dtype == torch.bfloat16 and f.dtype == torch.float32
    torch.testing.assert_close(y.float(), yr.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(f, fr, atol=SSD_TOL, rtol=SSD_TOL)


def test_ssd_large_decay_no_nan():
    """The reference's regression case (A -12 and -16, dt up to 3): the
    upper triangle is masked before the exp."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 32, 2, 8)).astype(np.float32)
    dt = rng.uniform(0.5, 3.0, size=(1, 32, 2)).astype(np.float32)
    A = np.asarray([-12.0, -16.0], np.float32)
    Bm, C = (rng.normal(size=(1, 32, 1, 8)).astype(np.float32)
             for _ in range(2))
    D = rng.normal(size=(2,)).astype(np.float32)
    args = (x, dt, A, Bm, C, D)
    y, f = ssd(*(torch.from_numpy(a) for a in args), chunk=8)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(f).all())
    jy, jf = jax_ssd(*(jnp.asarray(a) for a in args), chunk=8, backend="xla")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=SSD_TOL,
                               rtol=SSD_TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=SSD_TOL,
                               rtol=SSD_TOL)


def test_ssd_step_matches_scan():
    rng = np.random.default_rng(4)
    Bt, S_, H, P, G, N = 2, 6, 4, 8, 2, 8
    x = rng.normal(size=(Bt, S_, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, size=(Bt, S_, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    Bm, C = (rng.normal(size=(Bt, S_, G, N)).astype(np.float32)
             for _ in range(2))
    D = rng.normal(size=(H,)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, C, D)]
    y_ref, f_ref = ssd_ref(*t)
    state = torch.zeros(Bt, H, P, N)
    jstate = jnp.zeros((Bt, H, P, N), jnp.float32)
    for s in range(S_):
        y_t, state = ssd_step(state, t[0][:, s], t[1][:, s], t[2],
                              t[3][:, s], t[4][:, s], t[5])
        jy_t, jstate = jax_ssd_step(jstate, x[:, s], dt[:, s], A, Bm[:, s],
                                    C[:, s], D)
        torch.testing.assert_close(y_t, y_ref[:, s], atol=SSD_TOL, rtol=SSD_TOL)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(jy_t),
                                   atol=SSD_TOL, rtol=SSD_TOL)
    torch.testing.assert_close(state, f_ref, atol=SSD_TOL, rtol=SSD_TOL)


@pytest.mark.parametrize("S_,chunk,want", [(20, 256, 32), (1, 256, 16),
                                           (512, 256, 256), (1000, 256, 256),
                                           (40, 16, 16)])
def test_ssd_chunk_rule(monkeypatch, S_, chunk, want):
    """The reference's rule: a short sequence shrinks the chunk to the next
    power of two (at least 16); zeros stand in for a missing state."""
    seen = []

    def spy(x, dt, A, B, C, D, init, q):
        seen.append((q, init))
        return ssd_chunked(x, dt, A, B, C, D, init, q)

    monkeypatch.setattr(ssd_ops, "ssd_chunked", spy)
    y, f = ssd(torch.zeros(1, S_, 2, 8), torch.zeros(1, S_, 2),
               -torch.ones(2), torch.zeros(1, S_, 1, 8),
               torch.zeros(1, S_, 1, 8), torch.ones(2), chunk=chunk)
    assert seen[0][0] == want and y.shape == (1, S_, 2, 8)
    assert torch.equal(seen[0][1], torch.zeros(1, 2, 8, 8))


def test_ssd_backend_torch_is_the_plain_version():
    args, chunk = _ssd_inputs("2x32_h4_g2_c8")
    t = [torch.from_numpy(a) for a in args]
    got = ssd(*t[:-1], chunk=chunk, initial_state=t[-1], backend="torch")
    want = ssd_chunked(*t[:-1], t[-1], chunk)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


SSD_PLAN_SHAPES = [   # (Bt, S, H, P, G, N, chunk)
    (4, 512, 24, 64, 1, 128, 256),     # mamba2-130m's prefill
    (4, 512, 64, 64, 1, 64, 256),      # zamba2-1.2b's
    (2, 700, 8, 64, 1, 128, 256),      # a ragged last chunk
    (2, 300, 8, 32, 2, 32, 256),       # G 2
    (2, 20, 8, 64, 1, 64, 32),         # one short chunk
]


@pytest.mark.parametrize("shape,want", list(zip(SSD_PLAN_SHAPES, [
    # (chunks, scratch bytes)
    (2, 8_781_824),     # 0.4 MB sums, 2.1 MB C·Bᵀ, 6.3 MB states
    (2, 11_534_336),
    (3, 3_244_032),
    (2, 2_293_760),
    (1, 274_432),
])))
def test_ssd_plan_from_the_shapes(shape, want):
    """The CUDA scan's scratch follows from the shapes alone: cumulative
    sums and chunk states per head, C·Bᵀ once per (batch, group, chunk)."""
    Bt, S_, H, P, G, N, Q = shape
    p = ssd_ops.plan(*shape)
    nc, nbytes = want
    assert p.cs_shape == (Bt, H, nc, Q)
    assert p.cb_shape == (Bt, G, nc, Q, Q)
    assert p.states_shape == (Bt, H, nc, P, N)
    n = lambda shape: int(np.prod(shape))
    assert 8 * n(p.cs_shape) + 4 * (n(p.cb_shape) + n(p.states_shape)) == nbytes


@pytest.mark.parametrize("shape", SSD_PLAN_SHAPES)
def test_ssd_card_wrapper_allocates_the_plans_scratch(monkeypatch, shape):
    """The card wrapper takes its scratch from ``torch.empty`` (written
    before it is read, so nothing is zeroed) at the plan's shapes, and
    hands the C entry point those tensors and the chunk it was given."""
    Bt, S_, H, P, G, N, Q = shape
    made, seen = [], []
    empty = torch.empty

    def spy_empty(*args, **kw):
        t = empty(*args, **kw)
        made.append((tuple(t.shape), t.dtype, t.data_ptr()))
        return t

    def fake_fn(*args):
        seen.append(args)
        return 0

    monkeypatch.setattr(torch, "empty", spy_empty)
    monkeypatch.setattr(ssd_ops._build, "function", lambda *a: fake_fn)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    x = torch.zeros(Bt, S_, H, P)
    Bm = torch.zeros(Bt, S_, G, N)
    ssd_ops._ssd_cuda(x, torch.zeros(Bt, S_, H), -torch.ones(H), Bm, Bm,
                      torch.ones(H), torch.zeros(Bt, H, P, N), Q)
    p = ssd_ops.plan(*shape)
    scratch = [(p.cs_shape, torch.float64), (p.cb_shape, torch.float32),
               (p.states_shape, torch.float32)]
    assert [m[:2] for m in made[-3:]] == scratch
    (args,) = seen
    assert list(args[9:12]) == [m[2] for m in made[-3:]]
    assert list(args[12:19]) == [Bt, S_, H, P, G, N, Q]


def _bad_ssd_args():
    x, dt = torch.zeros(2, 32, 4, 16), torch.zeros(2, 32, 4)
    A, D = torch.zeros(4), torch.zeros(4)
    Bm = torch.zeros(2, 32, 2, 16)
    init = torch.zeros(2, 4, 16, 16)

    def args(**kw):
        a = dict(x=x, dt=dt, A=A, B=Bm, C=Bm, D_skip=D, initial_state=init,
                 chunk=16)
        a.update(kw)
        return a

    return {    # case: (expected message, operands)
        "dtype": ("dtypes", args(x=x.half(), B=Bm.half(), C=Bm.half())),
        "mixed": ("dtypes", args(B=Bm.bfloat16())),
        "dt_dtype": ("float32", args(dt=dt.double())),
        "state_dtype": ("float32", args(initial_state=init.bfloat16())),
        "ragged_P": ("multiples of 8", args(x=torch.zeros(2, 32, 4, 12),
                                            initial_state=torch.zeros(2, 4, 12, 16))),
        "wide_N": ("at most 128", args(B=torch.zeros(2, 32, 2, 136),
                                       C=torch.zeros(2, 32, 2, 136),
                                       initial_state=torch.zeros(2, 4, 16, 136))),
        "groups": ("H % G", args(B=torch.zeros(2, 32, 3, 16),
                                 C=torch.zeros(2, 32, 3, 16))),
        "B_and_C": (r"C \(2, 32, 1, 16\)", args(C=torch.zeros(2, 32, 1, 16))),
        "dt_shape": ("do not fit", args(dt=torch.zeros(2, 32, 3))),
        "state_shape": ("do not fit", args(initial_state=torch.zeros(2, 4, 16, 8))),
        "chunk": ("chunk", args(chunk=512)),
        "strides": ("contiguous", args(x=torch.zeros(2, 32, 16, 4).transpose(2, 3))),
    }


@pytest.mark.parametrize("case", list(_bad_ssd_args()))
def test_ssd_wrapper_refuses_before_launch(case):
    """The CUDA path checks its operands before anything is built or
    launched (called here directly on CPU tensors)."""
    message, args = _bad_ssd_args()[case]
    n = ssd_ops.LAUNCHES.value
    with pytest.raises(ValueError, match=message):
        ssd_ops._ssd_cuda(**args)
    assert ssd_ops.LAUNCHES.value == n


# -- one Mamba2 layer ------------------------------------------------------------

def _mamba_setup(seed=0):
    kw = dict(dtype="float32", param_dtype="float32")
    jcfg = jax_smoke_config("mamba2-130m").with_overrides(**kw)
    tcfg = smoke_config("mamba2-130m").with_overrides(**kw)
    jp = jax_ssm.mamba_init(jax.random.PRNGKey(seed), jcfg)
    tp = ssm.Mamba2(tcfg, device="cpu")
    with torch.no_grad():
        for name, p in tp.named_parameters():
            p.copy_(numpy_to_torch(jax_leaf(jp, name)))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("S_", [16, 37, 2], ids=["chunk", "ragged", "short"])
def test_mamba_layer_matches_jax(S_):
    """``mamba_apply_full`` with its returned state (the conv tail, left
    padded when S < W - 1, and the SSD state), then three ``mamba_step``s
    from that state."""
    jcfg, tcfg, jp, tp = _mamba_setup()
    rng = np.random.default_rng(S_)
    x = rng.normal(size=(2, S_, tcfg.d_model)).astype(np.float32)
    jec, tec = JaxExecConfig(backend="xla"), ExecConfig()
    jy, (jconv, jssm) = jax_ssm.mamba_apply_full(jp, jcfg, jec, jnp.asarray(x),
                                                 return_state=True)
    with torch.no_grad():
        ty, (tconv, tssm) = ssm.mamba_apply_full(tp, tcfg, tec,
                                                 torch.from_numpy(x),
                                                 return_state=True)
    assert tconv.shape == (2, tcfg.ssm_conv - 1, tcfg.d_inner + 2 * 16)
    for g, w in ((ty, jy), (tconv, jconv), (tssm, jssm)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=SSD_TOL,
                                   rtol=SSD_TOL)
    jstate, tstate = (jconv, jssm), (tconv, tssm)
    for t in range(3):
        xt = rng.normal(size=(2, tcfg.d_model)).astype(np.float32)
        jo, jstate = jax_ssm.mamba_step(jp, jcfg, jstate, jnp.asarray(xt))
        with torch.no_grad():
            to, tstate = ssm.mamba_step(tp, tcfg, tstate, torch.from_numpy(xt))
        for g, w in ((to, jo), (tstate[0], jstate[0]), (tstate[1], jstate[1])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=SSD_TOL, rtol=SSD_TOL)


# -- the whole smoke models ------------------------------------------------------

def _cfgs(arch, dtype):
    kw = dict(dtype=dtype, param_dtype=dtype)
    return (jax_smoke_config(arch).with_overrides(**kw),
            smoke_config(arch).with_overrides(**kw))


def _run_jax(cfg, params, tokens, teacher=None):
    model = jax_build_model(cfg, JaxExecConfig(backend="xla"))
    logits = jax.jit(model.logits)(params, tokens)
    cache = model.init_cache(B, S + STEPS)
    step_logits, cache, n = jax.jit(model.prefill)(params, tokens, cache)
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
    want_keys = {"conv", "ssm"} | ({"k", "v"} if cfg.family == "hybrid"
                                   else set())
    assert set(cache) == want_keys
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    step_logits, cache2, n = model.prefill(params, t, cache)
    assert cache2 is cache and n == S
    out = [step_logits.numpy()]
    toks = [step_logits.argmax(-1).to(torch.int32)]
    for i in range(STEPS):
        tok = toks[-1] if teacher is None else torch.from_numpy(teacher[:, i])
        step_logits, cache = model.decode_step(
            params, tok, cache, torch.full((B,), n + i, dtype=torch.int32))
        out.append(step_logits.numpy())
        toks.append(step_logits.argmax(-1).to(torch.int32))
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs   # in place
    return logits.float().numpy(), out, torch.stack(toks, 1).numpy()


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_a_copy(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == \
        dataclasses.asdict(jax_smoke_config(arch))


@pytest.mark.parametrize("arch,approx", [("mamba2-130m", 129e6),
                                         ("zamba2-1.2b", 1.09e9)])
def test_full_width_parameter_count(arch, approx):
    """Counted on the meta device: ``param_count`` leaves out each Mamba
    layer's ``dt_bias`` (H) and ``conv_b`` (conv_ch); the rest agrees."""
    cfg = get_config(arch)
    n = sum(p.numel() for p in SSMStack(cfg, device="meta").parameters())
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    assert n == cfg.param_count() + cfg.n_layers * (conv_ch + cfg.ssm_nheads)
    assert abs(n / approx - 1) < 0.01, n


@pytest.mark.parametrize("arch,want", [
    ("qwen1.5-0.5b", Transformer), ("deepseek-moe-16b", Transformer),
    ("mamba2-130m", SSMStack), ("zamba2-1.2b", SSMStack),
    ("whisper-tiny", EncDec), ("internvl2-2b", Transformer)])
def test_params_class_follows_the_family_map(arch, want):
    """``params_class`` (the fan-out's ``bind_params``, ``from_jax_params``,
    ``init_params``) reads the family map ``build_model`` reads: the
    enc-dec family gets its own module, not a Transformer; the map covers
    every family a config may name."""
    from repro_torch.configs.base import FAMILIES, ModelConfig
    from repro_torch.models.model import _FAMILY_MODULES
    cfg = ModelConfig(**dataclasses.asdict(jax_get_config(arch)))
    assert params_class(cfg) is want
    assert sorted(_FAMILY_MODULES) == sorted(FAMILIES)


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_model_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch, "float32")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    params = from_jax_params(tree, tcfg, "cpu")
    assert isinstance(params, SSMStack)
    assert sum(p.numel() for p in params.parameters()) == \
        sum(a.size for a in jax.tree.leaves(tree))     # every leaf loaded
    tokens = _tokens(tcfg)
    j_logits, j_steps, j_ids = _run_jax(jcfg, jparams, jnp.asarray(tokens))
    t_logits, t_steps, t_ids = _run_port(tcfg, params, tokens)
    tol = TOL["float32"]
    np.testing.assert_allclose(t_logits, j_logits, atol=tol, rtol=tol)
    for j, t in zip(j_steps, t_steps):
        np.testing.assert_allclose(t, j, atol=tol, rtol=tol)
    np.testing.assert_array_equal(t_ids, j_ids)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_matches_jax(arch):
    """A bf16 parameter tree of the JAX model (loaded bit-exactly; A_log,
    dt_bias and D stay f32), teacher-forced with the JAX tokens so that a
    near-tie cannot fork the sequences."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    tree = jax.tree.map(np.asarray,
                        jax_build_model(jcfg).init(jax.random.PRNGKey(1)))
    jparams = jax.tree.map(jnp.asarray, tree)
    params = from_jax_params(tree, tcfg, "cpu")
    m = params.layers[0].mamba
    assert m.w_in.dtype == torch.bfloat16 and m.A_log.dtype == torch.float32
    np.testing.assert_array_equal(
        m.w_in.view(torch.uint16).numpy(),
        np.asarray(tree["layers"]["mamba"]["w_in"][0]).view(np.uint16))
    tokens = _tokens(tcfg, seed=1)
    j_logits, j_steps, j_ids = _run_jax(jcfg, jparams, jnp.asarray(tokens))
    t_logits, t_steps, _ = _run_port(tcfg, params, tokens, teacher=j_ids)
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(t_logits, j_logits, atol=tol, rtol=tol)
    for j, t in zip(j_steps, t_steps):
        np.testing.assert_allclose(t, j, atol=tol, rtol=tol)
    agree = np.mean([(t.argmax(-1) == j.argmax(-1)).mean()
                     for t, j in zip([t_logits, *t_steps],
                                     [j_logits, *j_steps])])
    assert agree >= 0.9, agree


def test_init_params_follow_mamba_init():
    """``init_params`` draws each Mamba2 leaf as ``mamba_init`` does, not by
    the transformer's rule (which would zero ``norm_scale`` and ``D`` and
    draw the conv taps at W^-0.5): w_in at d^-0.5, w_out at d_inner^-0.5,
    conv_w at 0.1, A_log = log U(1, 16), dt_bias 0, D 1, norm_scale 1;
    A_log, dt_bias and D in f32 in a bf16 model."""
    jcfg, tcfg = _cfgs("zamba2-1.2b", "bfloat16")
    want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    got = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert isinstance(got, SSMStack)
    for name, p in got.named_parameters():
        ref, x = np.asarray(jax_leaf(want, name)), p.float().numpy()
        if name.endswith("A_log"):
            continue
        if ref.std() == 0:
            np.testing.assert_array_equal(x, ref)        # zeros and ones
            continue
        assert abs(x.std() / ref.std() - 1) < 0.1, name
        assert np.abs(x).max() <= np.abs(ref).max() * 1.1, name
    m = got.layers[0].mamba
    # a truncated (at 2) normal has 0.8796 of its scale as std
    d, d_in = tcfg.d_model, tcfg.d_inner
    for w, std in ((m.w_in, d ** -0.5), (m.w_out, d_in ** -0.5),
                   (m.conv_w, 0.1)):
        assert abs(w.float().std() / (0.8796 * std) - 1) < 0.1
    a = torch.stack([lp.mamba.A_log for lp in got.layers])
    assert a.dtype == torch.float32 and len(a.unique()) == a.numel()
    assert float(a.min()) >= 0.0 and float(a.max()) <= float(np.log(16.0))
    for leaf, value in (("dt_bias", 0.0), ("D", 1.0)):
        t = getattr(m, leaf)
        assert t.dtype == torch.float32 and bool((t == value).all()), leaf
    assert bool((m.norm_scale == 1).all()) and not m.conv_b.any()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_smoke_on_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--new-tokens", "4", "--batch", "3"], keep_logits=True)
    out = capsys.readouterr().out
    assert re.search(rf"{re.escape(arch)}-smoke: prefill 16 toks in [\d.]+ms; "
                     r"3 decode steps in [\d.]+ms \([\d.]+ tok/s\)", out), out
    gen = res["gen"]
    assert gen.shape == (3, 4) and gen.dtype == torch.int32
    for i, lg in enumerate(res["logits"]):
        assert lg.shape == (3, res["cfg"].vocab_size)
        assert torch.equal(lg.argmax(-1).to(torch.int32), gen[:, i])
    assert isinstance(res["params"], SSMStack)


@pytest.mark.parametrize("method", ["init", "init_cache"])
def test_ssm_model_runs_on_the_card_unless_told(method, monkeypatch):
    """Without a card, building with no device named raises instead of
    returning CPU tensors; naming the CPU works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(smoke_config("zamba2-1.2b"))
    call = {"init": lambda **kw: model.init(torch.Generator(), **kw),
            "init_cache": lambda **kw: model.init_cache(2, 8, **kw)}[method]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    out = call(device="cpu")
    tensors = (list(out.parameters()) if method == "init"
               else list(out.values()))
    assert tensors and all(t.device.type == "cpu" for t in tensors)
