"""The plain references against the port on the CPU at smoke sizes: the
parameter layout, the loss and every gradient of both families in
float32, the SGD update, and greedy decoding through the port's cache
against the reference's full forward.  The seeded weights draw each leaf
alike when drawn again alone."""
import math

import pytest
import torch

from bench.reference import model as ref
from bench.reference import weights as W
from bench.tests.shapes import smoke, source

SMOKE = {
    "granite-3-8b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=257),
    "zamba2-1.2b": dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                        head_dim=16, d_ff=128, vocab_size=257, ssm_state=16,
                        ssm_headdim=16, ssm_chunk=16, attn_every=2),
}


def config(name: str, dtype: str = "float32") -> dict:
    return smoke(name, SMOKE[name], dtype)


def port(c: dict):
    from repro_torch.configs import get_config
    from repro_torch.models import ExecConfig, build_model
    m = dict(c["model"])
    m.pop("family")
    cfg = get_config(c["registry_id"]).with_overrides(**m)
    return cfg, build_model(cfg, ExecConfig(loss_chunk=16))


def port_params(cfg, weights, train=True):
    from repro_torch.models.weights import params_class, trainable
    p = params_class(cfg)(cfg, device="meta")
    p.load_state_dict({k: v.clone() for k, v in weights.items()},
                      strict=True, assign=True)
    return trainable(p) if train else p


def batch(V: int, B: int = 2, S: int = 40, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, V, (B, S + 1), generator=g, dtype=torch.int32)
    return {"tokens": rows[:, :-1], "targets": rows[:, 1:],
            "mask": torch.ones(B, S)}


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_parameters_match_the_port_at_full_size(name):
    from repro_torch.configs import get_config
    from repro_torch.models.weights import params_class
    c = source(name)
    cfg = get_config(c["registry_id"])
    got = {n: (tuple(p.shape), p.dtype) for n, p in
           params_class(cfg)(cfg, device="meta").named_parameters()}
    want = {s.name: (s.shape, s.dtype) for s in ref.param_specs(c["model"])}
    assert got == want


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_loss_and_gradients_match_the_port(name):
    c = config(name)
    m = c["model"]
    cfg, model = port(c)
    w = W.make_weights(ref.param_specs(m), 7, "cpu")
    b = batch(m["vocab_size"])
    params = port_params(cfg, w)
    loss, _ = model.loss(params, b)
    names = [n for n, _ in params.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(loss,
                                              list(params.parameters()))))
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    want_loss = ref.loss(p, m, b)
    want = dict(zip(p, torch.autograd.grad(want_loss, list(p.values()))))
    assert abs(float(loss.detach()) - float(want_loss.detach())) < 1e-5
    for n in names:
        err = (got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-12)
        assert err < 1e-3, n


def test_sgd_update_matches_the_port():
    from repro_torch.optim import SGD
    c = config("granite-3-8b", "bfloat16")
    m = c["model"]
    cfg, _ = port(c)
    w = W.make_weights(ref.param_specs(m), 3, "cpu")
    g = {k: torch.randn_like(v.float()).to(v.dtype) for k, v in w.items()}
    params = port_params(cfg, w, train=False)
    opt = SGD(lr=0.05)
    opt.update(g, opt.init(params), params)
    p = {k: v.clone() for k, v in w.items()}
    ref.sgd_update(p, g, 0.05)
    for n, x in params.named_parameters():
        assert torch.equal(x, p[n]), n


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_greedy_decoding_through_the_cache_matches_the_full_forward(name):
    from repro_torch.launch.step_graphs import eager_generate
    c = config(name)
    m = c["model"]
    cfg, model = port(c)
    w = W.make_weights(ref.param_specs(m), 11, "cpu")
    params = port_params(cfg, w, train=False)
    prompt = batch(m["vocab_size"], B=3, S=20)["tokens"]
    gen = eager_generate(model, params, prompt, 8, keep_logits=True)
    seqs = torch.cat([prompt, gen.ids[:, :-1]], dim=1)
    want = ref.last_logits(w, m, seqs, torch.arange(19, 27))
    got = torch.stack(gen.logits, dim=1)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


def test_weights_drawn_again_are_the_same():
    m = config("zamba2-1.2b")["model"]
    specs = ref.param_specs(m)
    w = W.make_weights(specs, 2 ** 31 + 9, "cpu")
    for name, again in W.iter_weights(specs, 2 ** 31 + 9, "cpu"):
        assert torch.equal(again, w[name]), name
    other = W.make_weights(specs, 2 ** 31 + 10, "cpu")
    assert not torch.equal(other["embed"], w["embed"])


def test_weights_follow_the_stated_distributions():
    m = config("granite-3-8b")["model"]
    w = W.make_weights(ref.param_specs(m), 1, "cpu")
    assert abs(float(w["embed"].std()) - 0.02 * 0.96) < 1e-3
    std = float(w["layers.0.mlp.w_down"].std()) * math.sqrt(128)
    assert abs(std - 0.96) < 0.05        # a normal clamped at 2 sigma
    assert torch.all(w["final_norm.scale"] == 1)
