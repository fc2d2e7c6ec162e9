"""Plain PyTorch references of the benchmark's models.

Written from the models' equations, not from the program: nothing here
imports the program, its kernels or its test helpers.  Two families:

* ``dense``: a decoder of pre-norm blocks, RMSNorm, grouped-query
  attention with rotary positions (rotate-half), a gated SiLU MLP, the
  unembedding tied to the embedding;
* ``hybrid`` (Zamba2): Mamba2 layers, with one shared attention block
  (GELU MLP, weights tied across its applications) applied before every
  ``attn_every`` of them.

Parameters are a dict of tensors under the program's parameter names, so
that the benchmark can hand one set of weights to both.  ``prec`` is the
precision of the products: ``"bf16"`` runs them on bf16 operands (what the
configurations state), ``"fp8"`` rounds every product's operands to
float8 e4m3 (per-tensor scale) first: the lower precision that a
benchmark's control runs in.  Norms, rotary positions, softmax, the
loss and the SSD scan's state arithmetic are taken in float32.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.weights import Leaf

F32 = torch.float32
LOSS_ROWS = 1024                     # positions per chunk of the loss


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _dt(m: dict) -> torch.dtype:
    """The parameters' dtype (the Mamba2 decay, step bias and skip stay
    float32 whatever it is)."""
    return getattr(torch, m.get("param_dtype", "bfloat16"))


def _attn_specs(m: dict, pre: str) -> List[Leaf]:
    pd = _dt(m)
    d, qd = m["d_model"], m["n_heads"] * m["head_dim"]
    kvd = m["n_kv_heads"] * m["head_dim"]
    return [Leaf(f"{pre}.wq", (d, qd), pd, "normal", d ** -0.5),
            Leaf(f"{pre}.wk", (d, kvd), pd, "normal", d ** -0.5),
            Leaf(f"{pre}.wv", (d, kvd), pd, "normal", d ** -0.5),
            Leaf(f"{pre}.wo", (qd, d), pd, "normal", qd ** -0.5)]


def _block_specs(m: dict, pre: str) -> List[Leaf]:
    pd = _dt(m)
    d, f = m["d_model"], m["d_ff"]
    mlp = []
    if m["mlp_act"] == "silu":
        mlp.append(Leaf(f"{pre}.mlp.w_gate", (d, f), pd, "normal", d ** -0.5))
    mlp += [Leaf(f"{pre}.mlp.w_up", (d, f), pd, "normal", d ** -0.5),
            Leaf(f"{pre}.mlp.w_down", (f, d), pd, "normal", f ** -0.5)]
    return ([Leaf(f"{pre}.ln1.scale", (d,), pd, "ones")]
            + _attn_specs(m, f"{pre}.attn")
            + [Leaf(f"{pre}.ln2.scale", (d,), pd, "ones")] + mlp)


def ssm_dims(m: dict) -> dict:
    d_in = m["ssm_expand"] * m["d_model"]
    G, N, P = m["ssm_ngroups"], m["ssm_state"], m["ssm_headdim"]
    H = d_in // P
    conv = d_in + 2 * G * N
    return dict(d_in=d_in, G=G, N=N, P=P, H=H, conv=conv,
                proj=2 * d_in + 2 * G * N + H)


def _mamba_specs(m: dict, pre: str) -> List[Leaf]:
    pd = _dt(m)
    d, s = m["d_model"], ssm_dims(m)
    return [Leaf(f"{pre}.ln.scale", (d,), pd, "ones"),
            Leaf(f"{pre}.mamba.w_in", (d, s["proj"]), pd, "normal", d ** -0.5),
            Leaf(f"{pre}.mamba.conv_w", (m["ssm_conv"], s["conv"]), pd,
                 "conv", 0.1),
            Leaf(f"{pre}.mamba.conv_b", (s["conv"],), pd, "zeros"),
            Leaf(f"{pre}.mamba.A_log", (s["H"],), F32, "a_log"),
            Leaf(f"{pre}.mamba.dt_bias", (s["H"],), F32, "zeros"),
            Leaf(f"{pre}.mamba.D", (s["H"],), F32, "ones"),
            Leaf(f"{pre}.mamba.norm_scale", (s["d_in"],), pd, "ones"),
            Leaf(f"{pre}.mamba.w_out", (s["d_in"], d), pd, "normal",
                 s["d_in"] ** -0.5)]


def param_specs(m: dict) -> List[Leaf]:
    """Every parameter of configuration ``m`` (its ``model`` section):
    name, shape, dtype and how it is drawn."""
    if not m.get("tie_embeddings", False):
        raise ValueError("the references tie the unembedding to the embedding")
    out = [Leaf("embed", (m["vocab_size"], m["d_model"]), _dt(m), "normal",
                0.02)]
    if m["family"] == "dense":
        for i in range(m["n_layers"]):
            out += _block_specs(m, f"layers.{i}")
    elif m["family"] == "hybrid":
        for i in range(m["n_layers"]):
            out += _mamba_specs(m, f"layers.{i}")
        out += _block_specs(m, "shared_block")
    else:
        raise ValueError(f"no reference for family {m['family']!r}")
    return out + [Leaf("final_norm.scale", (m["d_model"],), _dt(m), "ones")]


# ---------------------------------------------------------------------------
# Products in the stated precision, or in float8 for the control
# ---------------------------------------------------------------------------

def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude at 448) and back, its gradient passed straight through."""
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    scale = 448.0 / amax
    q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x).detach()


def mm(x, w, prec: str):
    if prec == "fp8":
        x, w = fp8(x), fp8(w)
    return x @ w


def rms_norm(x, scale, eps: float):
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary positions, rotate-half: x (B, S, H, D), positions (S,)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = positions.float()[:, None] * inv[None, :]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def attention(q, k, v, prec: str):
    """Causal softmax attention, q (B, S, H, D), k and v (B, S, K, D); each
    key head serves H / K query heads."""
    H, K = q.shape[2], k.shape[2]
    if prec == "fp8":
        q, k, v = fp8(q), fp8(k), fp8(v)
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    y = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), is_causal=True)
    return y.transpose(1, 2)


def attn_block(p: Dict[str, torch.Tensor], m: dict, pre: str, h, prec: str):
    B, S, _ = h.shape
    H, K, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    pos = torch.arange(S, device=h.device)
    x = rms_norm(h, p[f"{pre}.ln1.scale"], m["norm_eps"])
    q = mm(x, p[f"{pre}.attn.wq"], prec).reshape(B, S, H, D)
    k = mm(x, p[f"{pre}.attn.wk"], prec).reshape(B, S, K, D)
    v = mm(x, p[f"{pre}.attn.wv"], prec).reshape(B, S, K, D)
    q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    y = attention(q, k, v, prec).reshape(B, S, H * D)
    h = h + mm(y, p[f"{pre}.attn.wo"], prec)
    x = rms_norm(h, p[f"{pre}.ln2.scale"], m["norm_eps"])
    if m["mlp_act"] == "silu":
        a = F.silu(mm(x, p[f"{pre}.mlp.w_gate"], prec)) \
            * mm(x, p[f"{pre}.mlp.w_up"], prec)
    else:
        a = F.gelu(mm(x, p[f"{pre}.mlp.w_up"], prec), approximate="tanh")
    return h + mm(a, p[f"{pre}.mlp.w_down"], prec)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

def ssd_scan(x, dt, A, Bm, Cm, chunk: int):
    """The state-space recurrence state_t = exp(dt_t A) state_{t-1} +
    dt_t x_t B_t^T, y_t = state_t C_t, computed chunk by chunk in float32
    (the quadratic form inside a chunk, the state carried between).
    x (B, S, H, P); dt (B, S, H); A (H,); Bm, Cm (B, S, H, N)."""
    Bt, S, H, P = x.shape
    N = Bm.shape[-1]
    state = x.new_zeros((Bt, H, P, N), dtype=F32)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=x.device))
    ys = []
    for c0 in range(0, S, chunk):
        xs, d = x[:, c0:c0 + chunk].float(), dt[:, c0:c0 + chunk]
        b, c = Bm[:, c0:c0 + chunk].float(), Cm[:, c0:c0 + chunk].float()
        Q = xs.shape[1]
        a = torch.cumsum(d * A, dim=1)                         # (B, Q, H)
        seg = a[:, :, None, :] - a[:, None, :, :]              # (B, Q, Q, H)
        decay = torch.exp(seg.masked_fill(~tri[:Q, :Q, None], float("-inf")))
        w = torch.einsum("bihn,bjhn->bijh", c, b) * decay
        u = xs * d[..., None]
        y = torch.einsum("bijh,bjhp->bihp", w, u)
        y = y + torch.exp(a)[..., None] * torch.einsum("bihn,bhpn->bihp",
                                                       c, state)
        tail = torch.exp(a[:, -1:, :] - a)                     # (B, Q, H)
        state = torch.exp(a[:, -1])[..., None, None] * state + \
            torch.einsum("bjhp,bjhn->bhpn", u * tail[..., None], b)
        ys.append(y)
    return torch.cat(ys, dim=1)


def mamba_block(p: Dict[str, torch.Tensor], m: dict, pre: str, h, prec: str):
    B, S, _ = h.shape
    s = ssm_dims(m)
    d_in, G, N, P, H = s["d_in"], s["G"], s["N"], s["P"], s["H"]
    x = rms_norm(h, p[f"{pre}.ln.scale"], m["norm_eps"])
    zxbcdt = mm(x, p[f"{pre}.mamba.w_in"], prec)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + s["conv"]]
    dt_raw = zxbcdt[..., d_in + s["conv"]:]
    W = m["ssm_conv"]
    w = p[f"{pre}.mamba.conv_w"].to(xbc.dtype).T[:, None, :]   # (C, 1, W)
    xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (W - 1, 0)), w,
                   groups=s["conv"]).transpose(1, 2)
    xbc = F.silu(xbc + p[f"{pre}.mamba.conv_b"].to(xbc.dtype))
    xs = xbc[..., :d_in].reshape(B, S, H, P)
    rep = H // G
    Bm = xbc[..., d_in:d_in + G * N].reshape(B, S, G, N)
    Cm = xbc[..., d_in + G * N:].reshape(B, S, G, N)
    Bm, Cm = Bm.repeat_interleave(rep, 2), Cm.repeat_interleave(rep, 2)
    dt = F.softplus(dt_raw.float() + p[f"{pre}.mamba.dt_bias"])
    A = -torch.exp(p[f"{pre}.mamba.A_log"])
    y = ssd_scan(xs, dt, A, Bm, Cm, m["ssm_chunk"])
    y = y + p[f"{pre}.mamba.D"][None, None, :, None] * xs.float()
    y = y.to(h.dtype).reshape(B, S, d_in)
    g = (y * F.silu(z)).float()
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + m["norm_eps"])
    g = (g * p[f"{pre}.mamba.norm_scale"].float()).to(h.dtype)
    return h + mm(g, p[f"{pre}.mamba.w_out"], prec)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def _blocks(m: dict):
    """(kind, parameter prefix) of each block in order."""
    if m["family"] == "dense":
        return [("attn", f"layers.{i}") for i in range(m["n_layers"])]
    out = []
    for i in range(m["n_layers"]):
        if i % m["attn_every"] == 0:
            out.append(("attn", "shared_block"))
        out.append(("mamba", f"layers.{i}"))
    return out


def hidden(p, m: dict, tokens, prec: str = "bf16", remat: bool = False):
    """The final-normed hidden states (B, S, d) of ``tokens`` (B, S)."""
    h = F.embedding(tokens.long(), p["embed"])
    for kind, pre in _blocks(m):
        fn = attn_block if kind == "attn" else mamba_block
        if remat:
            h = checkpoint(fn, p, m, pre, h, prec, use_reentrant=False)
        else:
            h = fn(p, m, pre, h, prec)
    return rms_norm(h, p["final_norm.scale"], m["norm_eps"])


def logits(p, m: dict, h, prec: str = "bf16"):
    """f32 logits of hidden states ``h`` (the tied unembedding)."""
    return mm(h, p["embed"].T, prec).float()


def loss(p, m: dict, batch, prec: str = "bf16", remat: bool = True):
    """The mean next-token cross-entropy of a batch (tokens, targets,
    mask), its logits taken a chunk of positions at a time."""
    h = hidden(p, m, batch["tokens"], prec, remat)
    B, S, d = h.shape
    h, t = h.reshape(B * S, d), batch["targets"].reshape(-1).long()
    mask = batch["mask"].reshape(-1).float()

    def part(hc, tc, mc):
        lg = logits(p, m, hc, prec)
        return ((torch.logsumexp(lg, -1)
                 - lg.gather(-1, tc[:, None])[:, 0]) * mc).sum()

    total = h.new_zeros((), dtype=F32)
    for i in range(0, B * S, LOSS_ROWS):
        args = (h[i:i + LOSS_ROWS], t[i:i + LOSS_ROWS], mask[i:i + LOSS_ROWS])
        total = total + (checkpoint(part, *args, use_reentrant=False)
                         if remat else part(*args))
    return total / mask.sum().clamp_min(1.0)


@torch.no_grad()
def sgd_update(p: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               lr: float) -> None:
    """p <- p - lr g, taken in float32 and rounded to each parameter's
    dtype."""
    for n, w in p.items():
        w.copy_((w.float() - lr * grads[n].float()).to(w.dtype))


def train_step(p, m: dict, batch, lr: float, prec: str = "bf16"):
    """One SGD step in place; returns (loss, gradients by name)."""
    leaves = list(p.values())
    for w in leaves:
        w.requires_grad_(True)
    value = loss(p, m, batch, prec)
    grads = dict(zip(p, torch.autograd.grad(value, leaves)))
    for w in leaves:
        w.requires_grad_(False)
    sgd_update(p, grads, lr)
    return value.detach(), grads


@torch.no_grad()
def last_logits(p, m: dict, tokens, positions, prec: str = "bf16"):
    """f32 logits at ``positions`` of each row of ``tokens`` (B, S): the
    full forward over the whole sequence, no cache."""
    h = hidden(p, m, tokens, prec)
    return logits(p, m, h[:, positions], prec)

