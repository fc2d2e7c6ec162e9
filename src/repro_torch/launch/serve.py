"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [--smoke]``.

Port of the request loop in ``main()`` of ``repro.launch.serve``: build the
model, prefill a batch of prompts, then decode greedily, reporting the
prefill and decode times from the metrics registry.  It runs on the CUDA
card (``--device cuda``, the default) and raises when there is none; the
CPU runs only when asked for (``--device cpu``).  The Faasm fan-out
(``--faasm-requests``, ``--state-wire``) comes with the runtime slice.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import ExecConfig, build_model
from repro_torch.telemetry import clock as tclock
from repro_torch.telemetry import metrics as tmetrics


def resolve_device(name: str) -> torch.device:
    """The device the launcher was asked for; a CUDA device must exist."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the launcher runs on the card; pass --device "
            "cpu to run the plain PyTorch path on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name!r}: use cuda or cpu")
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the random weights and the prompts")
    return ap


@torch.no_grad()
def main(argv: Optional[List[str]] = None, keep_logits: bool = False) -> dict:
    """Run the serving loop; returns what it produced.

    The result holds the config, model, parameters, prompt ``tokens``
    (B, S), the generated ids ``gen`` (B, new_tokens) and the prefill and
    decode wall times.  With ``keep_logits`` it also holds ``logits``, the
    (B, V) f32 logits that chose each generated token, in order."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    reg = tmetrics.registry()
    h_prefill = reg.histogram("faasm_serve_prefill_ms")
    h_decode = reg.histogram("faasm_serve_decode_ms")
    sum0 = (h_prefill.sum, h_decode.sum)     # the registry outlives a call

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, ExecConfig(backend="auto"))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device)

    B, S = args.batch, args.prompt_len
    max_len = S + args.new_tokens
    rng = np.random.default_rng(args.seed)      # the JAX launcher's prompts
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             dtype=torch.int32, device=device)

    cache = model.init_cache(B, max_len, device)
    _sync(device)
    t0 = tclock.now()
    logits, cache, n_total = model.prefill(params, tokens, cache)
    tok = torch.argmax(logits, -1).to(torch.int32)
    _sync(device)
    t1 = tclock.now()
    h_prefill.observe((t1 - t0) * 1e3)

    out = [tok]
    kept = [logits] if keep_logits else []
    t0 = tclock.now()
    for i in range(args.new_tokens - 1):
        idx = torch.full((B,), n_total + i, dtype=torch.int32, device=device)
        logits, cache = model.decode_step(params, tok, cache, idx)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out.append(tok)
        if keep_logits:
            kept.append(logits)
    _sync(device)
    t1 = tclock.now()
    h_decode.observe((t1 - t0) * 1e3)
    gen_ids = torch.stack(out, dim=1)
    # the printed line reads the registry — the timers above are its only
    # writers, so the log and a scrape can never disagree
    prefill_s = (h_prefill.sum - sum0[0]) / 1e3
    decode_s = (h_decode.sum - sum0[1]) / 1e3
    print(f"{cfg.name}: prefill {S} toks in {prefill_s * 1e3:.1f}ms; "
          f"{args.new_tokens - 1} decode steps in {decode_s * 1e3:.1f}ms "
          f"({(args.new_tokens - 1) * B / max(decode_s, 1e-9):.1f} tok/s)")
    print("generated ids[0]:", gen_ids[0][:12].cpu().numpy(), "...")
    result = {"cfg": cfg, "model": model, "params": params, "tokens": tokens,
              "gen": gen_ids, "prefill_s": prefill_s, "decode_s": decode_s}
    if keep_logits:
        result["logits"] = kept
    return result


if __name__ == "__main__":
    main()
