"""The optimizer, data-pipeline, checkpoint and compression tests of
``tests/test_optim_data_ckpt.py`` through the port on the CPU, under the
same names and with the reference's assertions: ``SGD(momentum=0.9)`` on
the quadratic, AdamW's dtypes, the warm-up-cosine schedule, gradient
accumulation, int8 error feedback and top-k, the pipeline's determinism
and sharding, the planted sparse dataset, the checkpointer's round trip,
GC, async and atomic writes and bf16 leaves, and the global tier's
checkpoint.  No JAX: the port's values are held against JAX's in
``tests/test_torch_train.py``, which each twin cites where it holds the
same case.

Then the update's grouping (``optim/sgd.py::GROUP_BYTES``): SGD (with and
without momentum and weight decay) and AdamW over a smoke model's leaves,
f32 and bf16, bitwise the one-group update of the port before grouping
(``_update_in_one_group`` below, kept verbatim) whatever the bound, and
the f32 temporaries it holds at once within the bound; and the gradient
accumulator, which adds bf16 microbatch gradients into f32 without a
cast copy of the model.
"""
import os
import weakref

import numpy as np
import pytest
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.checkpoint import (Checkpointer, restore_global_tier,
                                    save_global_tier)
from repro_torch.configs import smoke_config, smoke_shape
from repro_torch.data import (PipelineConfig, accuracy, hinge_loss,
                              make_batch, make_sparse_dataset)
from repro_torch.models import build_model
from repro_torch.optim import (SGD, AdamW, accumulate_grads, compression,
                               warmup_cosine)
from repro_torch.optim import sgd as sgd_mod
from repro_torch.state.kv import GlobalTier
from torch_twin_planes import port_planes_disarmed, port_sanitize  # noqa: F401


class _Tree(nn.Module):
    """A parameter module over named leaves, as the optimizers take one
    (``zeros_like_params`` rebuilds it from ``cfg`` on the meta device)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        for name, value in cfg.items():
            self.register_parameter(name, nn.Parameter(
                torch.as_tensor(value).to(device)))


def _quad_problem():
    params = _Tree({"w": torch.tensor([1.0, -2.0, 3.0]),
                    "b": torch.tensor(0.5)})

    def loss_fn(p, batch=None):
        return (torch.sum(p.w ** 2) + p.b ** 2), {}
    return params, loss_fn


def _grad(loss_fn, params) -> dict:
    gs = torch.autograd.grad(loss_fn(params)[0], list(params.parameters()))
    return dict(zip([n for n, _ in params.named_parameters()], gs))


def test_sgd_converges_on_quadratic():
    params, loss_fn = _quad_problem()
    opt = SGD(lr=0.1, momentum=0.9)
    state = opt.init(params)
    for _ in range(100):
        grads = _grad(loss_fn, params)
        params, state = opt.update(grads, state, params)
    assert float(loss_fn(params)[0]) < 1e-3
    assert int(state.step) == 100


def test_adamw_steps_and_dtypes():
    """The JAX comparison of AdamW's update and moments, three steps in f32
    and bf16: ``tests/test_torch_train.py::test_optimizer_matches_jax``."""
    params = _Tree({"w": torch.ones((4, 4), dtype=torch.bfloat16)})
    opt = AdamW(lr=1e-2)
    state = opt.init(params)
    grads = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    new, state = opt.update(grads, state, params)
    assert new.w.dtype == torch.bfloat16
    assert state.mu.w.dtype == torch.float32
    assert float(torch.abs(new.w.float()).mean()) < 1.0


def test_warmup_cosine_schedule():
    """Each step's value against the reference's schedule:
    ``tests/test_torch_train.py::test_warmup_cosine_matches_jax``."""
    sched = warmup_cosine(1.0, warmup=10, total=110, floor=0.1)
    assert float(sched(torch.tensor(0))) < 0.2
    assert abs(float(sched(torch.tensor(10))) - 1.0) < 0.15
    assert float(sched(torch.tensor(109))) < 0.2


def test_grad_accumulation_matches_full_batch():
    """A model's microbatched gradients against the reference's:
    ``tests/test_torch_train.py::test_accumulate_grads_matches_jax``."""
    g = torch.Generator().manual_seed(0)
    W = torch.randn((8, 4), generator=g)
    params = _Tree({"w": W})
    x = torch.randn((16, 8), generator=g)
    y = torch.randn((16, 4), generator=g)
    batch = {"x": x, "y": y}

    def loss_fn(p, b):
        pred = b["x"] @ p.w
        return torch.mean((pred - b["y"]) ** 2), {}

    g1, l1, _ = accumulate_grads(loss_fn, params, batch, 1)
    g4, l4, _ = accumulate_grads(loss_fn, params, batch, 4)
    np.testing.assert_allclose(l1, l4, rtol=1e-5)
    np.testing.assert_allclose(g1["w"], g4["w"], atol=1e-5, rtol=1e-5)


def test_compression_error_feedback_unbiased():
    """With error feedback, the *sum* of decoded pushes converges to the sum
    of the true gradients (residual stays bounded).  Two pushes' wire,
    decoded values and residual against the reference's:
    ``tests/test_torch_train.py::test_compression_round_trip_matches_jax``."""
    rng = np.random.default_rng(0)
    g_true = [torch.as_tensor(rng.normal(size=(32, 128)), dtype=torch.float32)
              for _ in range(20)]
    state = compression.init_state({"g": g_true[0]})
    decoded_sum = np.zeros((32, 128), np.float32)
    for g in g_true:
        wire, dec, state = compression.compress_int8({"g": g}, state)
        decoded_sum += dec["g"].numpy()
    true_sum = sum(g_true).numpy()
    resid = state.residual["g"].numpy()
    np.testing.assert_allclose(decoded_sum + resid, true_sum, atol=1e-3)
    # wire format is ~4x smaller than f32
    nbytes = compression.wire_bytes_int8(wire)
    assert nbytes < 32 * 128 * 4 / 3


def test_topk_compression():
    """The top-k wire against the reference's:
    ``tests/test_torch_train.py::test_compression_round_trip_matches_jax``."""
    g = {"g": torch.as_tensor(np.random.default_rng(1).normal(size=(64,)),
                              dtype=torch.float32)}
    state = compression.init_state(g)
    wire, dec, state = compression.compress_topk(g, state, frac=0.1)
    idx, vals = wire["g"]
    assert idx.shape[0] == 6                       # 10% of 64
    assert float(torch.count_nonzero(dec["g"])) <= 6


def test_data_pipeline_determinism_and_sharding():
    """Batches bitwise the reference's:
    ``tests/test_torch_train.py::test_make_batch_is_bitwise_the_reference``."""
    cfg = smoke_config("qwen1.5-0.5b")
    shape = smoke_shape("train")
    a = make_batch(cfg, shape, PipelineConfig(seed=1, n_shards=2, shard=0), 5)
    b = make_batch(cfg, shape, PipelineConfig(seed=1, n_shards=2, shard=0), 5)
    c = make_batch(cfg, shape, PipelineConfig(seed=1, n_shards=2, shard=1), 5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape[0] == shape.global_batch // 2
    # targets are next-token shifted
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["targets"][:, :-1])


def test_sparse_dataset_planted_model():
    """The dataset bitwise the reference's:
    ``tests/test_torch_train.py::test_sparse_dataset_is_bitwise_the_reference``."""
    X, y, w_true = make_sparse_dataset(64, 256, density=0.2, seed=3)
    assert accuracy(w_true, X, y) == 1.0
    assert hinge_loss(np.zeros(64, np.float32), X, y) == 1.0


def test_checkpointer_roundtrip_and_gc(tmp_path):
    """Checkpoints of a model and its optimizer state moving between the
    packages: ``tests/test_torch_train.py::
    test_checkpoints_move_between_the_packages``."""
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "nested": {"b": np.ones(4, np.int32)}}
    for step in (1, 2, 3):
        ck.save(step, tree, blocking=True, extra={"step": step})
    assert ck.steps() == [2, 3]                     # GC kept last 2
    restored, step, extra = ck.restore(tree)
    assert step == 3 and extra["step"] == 3
    np.testing.assert_array_equal(restored["a"], tree["a"])
    np.testing.assert_array_equal(restored["nested"]["b"], tree["nested"]["b"])


def test_checkpointer_async_and_atomic(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"w": np.zeros((128, 128), np.float32)}
    ck.save(10, tree, blocking=False)
    ck.wait()
    assert ck.latest_step() == 10
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_checkpoint_jax_arrays(tmp_path):
    """The reference's device arrays are the port's tensors: a bf16 tensor
    leaf comes back in its dtype."""
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    ck.save(1, tree, blocking=True)
    restored, _, _ = ck.restore(tree)
    assert restored["w"].dtype == tree["w"].dtype


def test_global_tier_checkpoint(tmp_path):
    """Files either package wrote restore in the other:
    ``tests/test_torch_train.py::test_global_tier_round_trip``."""
    gt = GlobalTier(device="cpu")
    gt.set("a", b"alpha", host="x")
    gt.set("nested/key", bytes(100), host="x")
    path = save_global_tier(gt, str(tmp_path))
    gt2 = GlobalTier(device="cpu")
    n = restore_global_tier(gt2, str(tmp_path))
    assert n == 2
    assert gt2.get("a", host="y") == b"alpha"
    assert gt2.size("nested/key") == 100


# -- the update's grouping ----------------------------------------------------------

@torch.no_grad()
def _update_in_one_group(opt, grads, state, params):
    """The port's update before grouping, verbatim: every leaf's f32 copy
    at once (``optim/sgd.py`` before ``GROUP_BYTES``)."""
    ps = list(params.parameters())
    names = [n for n, _ in params.named_parameters()]
    lr = opt._lr(state.step)

    def apply(upd):
        p32 = [p.float() for p in ps]
        if opt.weight_decay:
            upd = torch._foreach_add(upd, p32, alpha=opt.weight_decay)
        upd = torch._foreach_mul(upd, lr)
        torch._foreach_sub_(p32, upd)
        torch._foreach_copy_(ps, p32)

    if isinstance(opt, SGD):
        gs = [grads[n] for n in names]
        if opt.momentum:
            ms = list(state.momentum.parameters())
            torch._foreach_mul_(ms, opt.momentum)
            torch._foreach_add_(ms, [g.to(m.dtype) for g, m in zip(gs, ms)])
            gs = ms
        apply([g.float() for g in gs])
        return params, state._replace(step=state.step + 1)
    step = state.step + 1
    bc1 = 1.0 - opt.b1 ** step.float()
    bc2 = 1.0 - opt.b2 ** step.float()
    g32 = [grads[n].float() for n in names]
    mu, nu = list(state.mu.parameters()), list(state.nu.parameters())
    torch._foreach_mul_(mu, opt.b1)
    torch._foreach_add_(mu, g32, alpha=1 - opt.b1)
    torch._foreach_mul_(nu, opt.b2)
    torch._foreach_addcmul_(nu, g32, g32, value=1 - opt.b2)
    upd = torch._foreach_div(mu, bc1)
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, opt.eps)
    torch._foreach_div_(upd, den)
    apply(upd)
    return params, state._replace(step=step)


UPDATES = {
    "sgd": lambda lr: SGD(lr=lr),
    "sgd_momentum": lambda lr: SGD(lr=lr, momentum=0.9),
    "sgd_decay": lambda lr: SGD(lr=lr, weight_decay=0.01),
    "sgd_momentum_decay": lambda lr: SGD(lr=lr, momentum=0.9,
                                         weight_decay=0.01),
    "adamw": lambda lr: AdamW(lr=lr),
}
# the bound in f32 elements a group (``GROUP_BYTES / (4 * 3)``), given
# the leaves: every leaf split into slices of 64; the largest leaf's size
# (each leaf whole, groups of one or more); the default (the smoke model
# in one group)
BOUNDS = {"slices": lambda ps: 64,
          "leaves": lambda ps: max(p.numel() for p in ps),
          "default": lambda ps: sgd_mod.GROUP_BYTES // 12}


def _smoke_params(dtype, seed=0):
    cfg = smoke_config("qwen1.5-0.5b").with_overrides(dtype=dtype,
                                                      param_dtype=dtype)
    return build_model(cfg).init(torch.Generator().manual_seed(seed), "cpu")


def _random_grads(params, seed) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {n: torch.randn(p.shape, generator=g).to(p.dtype)
            for n, p in params.named_parameters()}


def _tensors(params, state) -> list:
    out = list(params.parameters())
    for f in state:
        out += list(f.parameters()) if isinstance(f, nn.Module) else \
            [f] if isinstance(f, torch.Tensor) else []
    return out


@pytest.mark.parametrize("bound", list(BOUNDS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", list(UPDATES))
def test_grouped_update_is_bitwise_the_one_group_update(monkeypatch, opt,
                                                        dtype, bound):
    """Three updates (the schedule read at the step counter, the gradients
    drawn anew each time, a slice of a leaf written through its flat view)
    leave every parameter and every optimizer-state tensor bitwise as the
    one-group update leaves them; the caller's gradients stay unwritten."""
    ps = list(_smoke_params(dtype).parameters())
    monkeypatch.setattr(sgd_mod, "GROUP_BYTES", BOUNDS[bound](ps) * 12)
    groups = sgd_mod._groups(ps)
    if bound == "slices":
        assert sum(len(g) for g in groups) > len(ps)
    elif bound == "leaves":
        assert 1 < len(groups) and all(
            lo == 0 and hi == ps[i].numel() for g in groups
            for i, lo, hi in g)
    else:
        assert len(groups) == 1
    lr = warmup_cosine(0.05, 2, 10)
    got, want = _smoke_params(dtype), _smoke_params(dtype)
    optimizer = UPDATES[opt](lr)
    gstate, wstate = optimizer.init(got), optimizer.init(want)
    for seed in range(3):
        grads = _random_grads(got, seed)
        kept = {n: g.clone() for n, g in grads.items()}
        got, gstate = optimizer.update(grads, gstate, got)
        want, wstate = _update_in_one_group(optimizer, _random_grads(want, seed),
                                            wstate, want)
        assert all(torch.equal(grads[n], kept[n]) for n in grads)
    a, b = _tensors(got, gstate), _tensors(want, wstate)
    assert len(a) == len(b) > len(ps)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


class _LiveF32(TorchDispatchMode):
    """The bytes of f32 tensors that ops make (not views of their inputs)
    and that are alive at once, at most, while the mode is on."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0

    def _gone(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {t.untyped_storage().data_ptr()
                for t in tree_flatten((args, kwargs))[0]
                if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32 \
                    and t.untyped_storage().data_ptr() not in seen:
                n = t.untyped_storage().nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._gone, n)
        return out


@pytest.mark.parametrize("opt", ["sgd", "sgd_momentum_decay", "adamw"])
def test_update_holds_f32_temporaries_within_the_bound(monkeypatch, opt):
    """A bf16 model's update holds at most ``GROUP_BYTES`` of f32
    temporaries at once, with the schedule's 0-d tensors (the old one-group update held three f32 copies of
    the model, 12 bytes a parameter, at once)."""
    monkeypatch.setattr(sgd_mod, "GROUP_BYTES", 64 << 10)
    params = _smoke_params("bfloat16")
    model_f32 = 4 * sum(p.numel() for p in params.parameters())
    assert model_f32 > 8 * sgd_mod.GROUP_BYTES
    optimizer = UPDATES[opt](0.05)
    state = optimizer.init(params)
    grads = _random_grads(params, 0)
    with _LiveF32() as mode:
        optimizer.update(grads, state, params)
    # beside the groups, AdamW's 0-d bias corrections (a few bytes)
    assert 0 < mode.peak <= sgd_mod.GROUP_BYTES + 64, (mode.peak, model_f32)
    with _LiveF32() as mode:
        _update_in_one_group(optimizer, grads, state, params)
    assert mode.peak >= 2 * model_f32        # what the bound removed


def test_accumulation_adds_bf16_gradients_without_a_cast_copy():
    """Over microbatches, bf16 gradients go into the f32 accumulator
    without an f32 copy of every leaf (the accumulator itself is the only
    f32 set held), bitwise the sum of their f32 casts."""
    n = 1 << 16
    params = _Tree({"w": torch.linspace(-1, 1, n).bfloat16()})
    x = torch.randn((4, n), generator=torch.Generator().manual_seed(0)
                    ).bfloat16()

    def loss_fn(p, b):
        loss = (p.w * b["x"]).sum()
        return loss, {"loss": loss}

    with _LiveF32() as mode:
        grads, _, _ = accumulate_grads(loss_fn, params, {"x": x}, 4)
    assert grads["w"].dtype == torch.float32
    assert mode.peak < 2 * 4 * n, mode.peak
    want = x[0].float()
    for i in range(1, 4):
        want = want + x[i].float()
    assert torch.equal(grads["w"], want / 4)
