"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [--smoke]``.

Port of ``repro.launch.serve``: build the model, prefill a batch of
prompts, then decode greedily, reporting the prefill and decode times from
the metrics registry.  ``--faasm-requests N`` then pushes an N-request wave
through the port's Faasm runtime (``invoke_many`` + ``wait_all`` on a shared
completion latch) and reports p50/p99 latency and batch throughput; with
``--state-wire`` each request also adds its token to the shared
``serve/stats`` vector and pushes the delta over that wire.

Everything runs on the CUDA card (``--device cuda``, the default) and raises
when there is none; the CPU runs only when asked for (``--device cpu``).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.common import resolve_device
from repro_torch.models import ExecConfig, build_model
from repro_torch.models.transformer import Transformer
from repro_torch.models.weights import numpy_to_torch
from repro_torch.overload import DEADLINE_RC, SHED_RC
from repro_torch.telemetry import clock as tclock
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import spans as tspans


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_leaves(params: Transformer) -> Dict[str, torch.Tensor]:
    """The parameters as picklable host leaves (CPU tensors, by name): what
    travels in the Proto-Faaslet snapshot."""
    return {n: p.detach().cpu() for n, p in params.named_parameters()}


def bind_params(cfg, leaves, device: torch.device) -> Transformer:
    """A :class:`Transformer` on ``device`` over copies of ``leaves`` (CPU
    tensors or numpy arrays, by name) — every parameter crosses to the
    device, as the reference's per-call ``tree_unflatten`` of
    ``jnp.asarray`` leaves does."""
    p = Transformer(cfg, device="meta")
    state = {n: (x if isinstance(x, torch.Tensor) else numpy_to_torch(x)
                 ).to(device) for n, x in leaves.items()}
    p.load_state_dict(state, strict=True, assign=True)
    return p


def fanout_payloads(vocab_size: int, n_requests: int,
                    prompt_len: int) -> List[bytes]:
    """The fan-out's request prompts, as the reference draws them."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab_size, prompt_len, dtype=np.int32).tobytes()
            for _ in range(n_requests)]


def make_infer_function(model, leaves, prompt_len: int = 16,
                        cache_key=("serve", "fwd"), state_wire: str = None,
                        device="cuda"):
    """Build the FAASM ``infer`` FunctionDef for a single-shot forward pass.

    The forward callable, warmed once on ``device``, lands in the runtime's
    ExecutableCache under ``cache_key``; the (picklable) host ``leaves``
    travel in the Proto-Faaslet snapshot, and each call binds them to the
    device afresh (its time lands in ``faasm_serve_param_h2d_ms``).

    With ``state_wire`` set, each request additionally accumulates the
    predicted token into the shared ``serve/stats`` histogram and pushes the
    delta with that wire format (``"int8"`` = the quantised
    ``kernels/state_push`` path; ``"auto"`` = the per-key adaptive
    ``WirePolicy``).  The warm-replica refresh before each push rides the
    wire fabric too: only the retained delta is pulled."""
    from repro_torch.core import FunctionDef

    device = torch.device(device)

    @torch.no_grad()
    def fwd(p, tokens):
        return model.logits(p, tokens)

    def _build_fwd():
        p = bind_params(model.cfg, leaves, device)
        fwd(p, torch.zeros((1, prompt_len), dtype=torch.int32, device=device))
        _sync(device)
        return fwd

    def init(api):
        api.runtime.exec_cache.get_or_build(cache_key, _build_fwd)
        return {"params": leaves}

    def infer(api):
        t_call = tclock.now()
        state = api.host.user_state(api.faaslet)
        fwd_, _, _ = api.runtime.exec_cache.get_or_build(cache_key, _build_fwd)
        t0 = tclock.now()
        p = bind_params(model.cfg, state["params"], device)
        _sync(device)
        api.runtime.metrics.histogram(
            "faasm_serve_param_h2d_ms",
            "per-call parameter copy to the device").observe(
                (tclock.now() - t0) * 1e3)
        tokens = torch.from_numpy(np.frombuffer(
            api.read_call_input(), np.int32).reshape(1, -1).copy())
        logits = fwd_(p, tokens.to(device))
        tok = int(torch.argmax(logits[0, -1]))
        if state_wire is not None:
            from repro_torch.state.ddo import VectorAsync
            stats = VectorAsync(api, "serve/stats")
            stats.pull(track_delta=True)
            stats.add([tok], 1.0)
            stats.push_delta(wire=state_wire)
        api.write_call_output(np.int32(tok).tobytes())
        api.runtime.metrics.histogram(
            "faasm_serve_infer_ms", "infer call body, queueing excluded"
        ).observe((tclock.now() - t_call) * 1e3)
        return 0

    return FunctionDef("infer", infer, init_fn=init)


_SHED_CHUNK = 32      # degradation re-check granularity within one wave


def submit_degradable(rt, fn: str, payloads, *, min_alive_hosts: int = 1,
                      state_hint=None, timeout: float = 600.0) -> dict:
    """Submit a request wave with fail-fast shedding (graceful degradation).

    A healthy cluster takes the whole wave through the batched
    ``invoke_many`` path.  Once the alive-host count drops below
    ``min_alive_hosts`` the cluster is **degraded**: requests from that
    point on are shed immediately (code :data:`SHED_RC`, never queued)
    instead of piling onto the survivors — a bounded brown-out in place of
    a collapse.  The wave is submitted in :data:`_SHED_CHUNK`-sized slices
    so a host dying mid-wave starts shedding within one slice, not after
    the whole wave queued.

    Returns ``{"codes": [...], "call_ids": [...], "shed": n,
    "degraded": bool}`` — ``call_ids[i]`` is ``None`` for shed requests.
    Shed requests are the caller's to retry (e.g.
    ``repro_torch.core.chain.scatter_gather``) once capacity returns.
    """
    n = len(payloads)
    codes: list = [SHED_RC] * n
    call_ids: list = [None] * n
    degraded = False
    submitted: list = []                 # (index, call_id)
    for lo in range(0, n, _SHED_CHUNK):
        chunk = payloads[lo:lo + _SHED_CHUNK]
        if len(rt.alive_hosts()) < min_alive_hosts:
            degraded = True              # fail fast: shed the rest of the slice
            continue
        cids = rt.invoke_many(fn, chunk, state_hint=state_hint)
        submitted.extend(zip(range(lo, lo + len(chunk)), cids))
    if submitted:
        rcs = rt.wait_all([c for _, c in submitted], timeout=timeout)
        for (i, cid), rc in zip(submitted, rcs):
            codes[i], call_ids[i] = rc, cid
    shed = sum(1 for c in call_ids if c is None)
    return {"codes": codes, "call_ids": call_ids, "shed": shed,
            "degraded": degraded or shed > 0}


def _token(rt, call_id) -> int:
    return int(np.frombuffer(rt.output(call_id), np.int32)[0])


def run_faasm_fanout(model, params, vocab_size: int, n_requests: int,
                     prompt_len: int = 16, n_hosts: int = 1,
                     capacity: int = 8, state_wire: str = None,
                     min_alive_hosts: int = 1,
                     max_queue_depth: int = None,
                     default_deadline_ms: float = None,
                     device="cuda") -> dict:
    """Serve ``n_requests`` single-shot requests through the FAASM runtime.

    Each request is one Faaslet call running the forward pass on
    ``device``; the whole wave is submitted with ``invoke_many`` and awaited
    on one shared latch (``wait_all``), the thousand-call fan-out path.
    ``state_wire`` turns on the shared serving-stats state (see
    :func:`make_infer_function`) and picks its push wire format; the batch
    then also carries a ``state_hint`` so placement prefers hosts already
    holding the stats replica.

    ``max_queue_depth`` / ``default_deadline_ms`` arm the overload control
    plane (``repro_torch.overload``): bounded per-host admission queues with
    spill-to-peer, and an end-to-end deadline stamped on every request.
    Requests refused everywhere settle with ``SHED_RC``; requests whose
    deadline expires settle with ``overload.DEADLINE_RC``.  Both are
    reported in the returned dict instead of inflating the latency tail.

    Beside the reference's keys the dict holds ``tokens`` (each request's
    token, ``None`` where not served), ``warm_tokens`` (the warm-up wave's),
    ``param_h2d_ms`` and ``infer_ms`` (mean per-call parameter copy and
    call body, queueing excluded) and, with ``state_wire``, ``stats``: the
    global ``serve/stats`` value at the end."""
    from repro_torch import overload as oload
    from repro_torch.core import FaasmRuntime
    from repro_torch.state.ddo import VectorAsync

    policy = None
    if max_queue_depth is not None or default_deadline_ms is not None:
        policy = oload.OverloadPolicy(
            max_queue_depth=max_queue_depth,
            default_deadline_s=(default_deadline_ms / 1e3
                                if default_deadline_ms else None))
    rt = FaasmRuntime(n_hosts=n_hosts, capacity=capacity, overload=policy,
                      device=device)
    hint = ["serve/stats"] if state_wire is not None else None
    try:
        if state_wire is not None:
            VectorAsync.create(rt.global_tier, "serve/stats",
                               np.zeros(vocab_size, np.float32))
        rt.upload(make_infer_function(model, host_leaves(params),
                                      prompt_len=prompt_len,
                                      state_wire=state_wire,
                                      device=rt.device))
        payloads = fanout_payloads(vocab_size, n_requests, prompt_len)
        # warm every executor before timing the wave
        warm = rt.invoke_many("infer", payloads[:capacity], state_hint=hint)
        rt.wait_all(warm, timeout=300)
        rt.global_tier.reset_metrics()
        h2d = rt.metrics.histogram("faasm_serve_param_h2d_ms")
        body = rt.metrics.histogram("faasm_serve_infer_ms")
        h2d0, body0 = (h2d.count, h2d.sum), body.sum
        t0 = tclock.now()
        wave = submit_degradable(rt, "infer", payloads,
                                 min_alive_hosts=min_alive_hosts,
                                 state_hint=hint, timeout=600)
        wall = tclock.now() - t0
        ok_codes = (0, SHED_RC, DEADLINE_RC)
        if not all(r in ok_codes for r in wave["codes"]):
            raise RuntimeError(f"fan-out return codes {wave['codes']}")
        served = [c for c, r in zip(wave["call_ids"], wave["codes"])
                  if c is not None and r == 0]
        n_deadline = sum(1 for r in wave["codes"] if r == DEADLINE_RC)
        n_shed = (wave["shed"]
                  + sum(1 for r in wave["codes"] if r == SHED_RC))
        # one source of truth: per-request latency lands in the runtime's
        # registry (mirrored to the process registry for --metrics-port)
        hist = rt.metrics.histogram("faasm_serve_request_ms",
                                    "end-to-end request latency")
        mirror = tmetrics.registry().histogram("faasm_serve_request_ms",
                                               "end-to-end request latency")
        for c in served:
            ms = rt.call(c).latency * 1e3
            hist.observe(ms)
            mirror.observe(ms)
        n_calls = max(h2d.count - h2d0[0], 1)
        out = {"requests": n_requests, "wall_s": wall,
               "throughput_rps": len(served) / wall,
               "p50_ms": hist.percentile(0.50) if served else 0.0,
               "p99_ms": hist.percentile(0.99) if served else 0.0,
               "degraded": wave["degraded"], "shed": n_shed,
               "deadline_expired": n_deadline,
               "tokens": [_token(rt, c) if c is not None and r == 0 else None
                          for c, r in zip(wave["call_ids"], wave["codes"])],
               "warm_tokens": [_token(rt, c) for c in warm],
               "param_h2d_ms": (h2d.sum - h2d0[1]) / n_calls,
               "infer_ms": (body.sum - body0) / n_calls}
        if state_wire is not None:
            out["state_wire"] = state_wire
            out["state_push_mb"] = sum(
                rt.global_tier.bytes_pushed.values()) / 1e6
            out["stats"] = np.frombuffer(
                rt.global_tier.get("serve/stats", host="main"),
                np.float32).copy()
        return out
    finally:
        rt.shutdown()


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
    ap.add_argument("--faasm-requests", type=int, default=0,
                    help="also fan out N requests through the FAASM runtime "
                         "(invoke_many/wait_all batch path)")
    ap.add_argument("--faasm-hosts", type=int, default=1)
    ap.add_argument("--min-alive-hosts", type=int, default=1,
                    help="graceful-degradation floor: shed requests (fail "
                         "fast) once fewer hosts than this are alive")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="bound each host's admission queue at this many "
                         "calls beyond its executor capacity; overflow "
                         "spills to a peer with room or is shed (SHED_RC)")
    ap.add_argument("--default-deadline-ms", type=float, default=None,
                    help="stamp this end-to-end deadline (ms) on every "
                         "request; expired work settles with DEADLINE_RC "
                         "at admission, dequeue, or the next checkpoint")
    ap.add_argument("--state-wire", choices=("auto", "exact", "int8"),
                    default=None,
                    help="track shared serving stats through the state tier "
                         "and move deltas with this wire format (auto = "
                         "per-key adaptive WirePolicy)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="expose the telemetry registry as Prometheus text "
                         "on this port (0 = off)")
    return ap


@torch.no_grad()
def main(argv: Optional[List[str]] = None, keep_logits: bool = False) -> dict:
    """Run the serving loop (and the fan-out); returns what it produced.

    The result holds the config, model, parameters, prompt ``tokens``
    (B, S), the generated ids ``gen`` (B, new_tokens) and the prefill and
    decode wall times; with ``--faasm-requests`` also ``faasm``, the
    fan-out's dict (:func:`run_faasm_fanout`).  With ``keep_logits`` it
    also holds ``logits``, the (B, V) f32 logits that chose each generated
    token, in order."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    reg = tmetrics.registry()
    if args.metrics_port:
        tmetrics.serve_http(reg, args.metrics_port)
        print(f"metrics: http://127.0.0.1:{args.metrics_port}/metrics")
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
    tel = tspans.tracer()
    _sync(device)
    t0 = tclock.now()
    logits, cache, n_total = model.prefill(params, tokens, cache)
    tok = torch.argmax(logits, -1).to(torch.int32)
    _sync(device)
    t1 = tclock.now()
    h_prefill.observe((t1 - t0) * 1e3)
    if tel is not None:
        tel.record("serve.prefill", "serve", t0, t1, arch=cfg.name, tokens=S)

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
    if tel is not None:
        tel.record("serve.decode", "serve", t0, t1, arch=cfg.name,
                   steps=args.new_tokens - 1)
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

    if args.faasm_requests > 0:
        r = run_faasm_fanout(model, params, cfg.vocab_size,
                             args.faasm_requests, prompt_len=S,
                             n_hosts=args.faasm_hosts,
                             state_wire=args.state_wire,
                             min_alive_hosts=args.min_alive_hosts,
                             max_queue_depth=args.max_queue_depth,
                             default_deadline_ms=args.default_deadline_ms,
                             device=device)
        print(f"faasm fan-out: {r['requests']} reqs in {r['wall_s']:.2f}s "
              f"({r['throughput_rps']:.1f} req/s) "
              f"p50={r['p50_ms']:.1f}ms p99={r['p99_ms']:.1f}ms")
        if r.get("degraded"):
            print(f"  DEGRADED: {r['shed']} requests shed (alive hosts "
                  f"below --min-alive-hosts={args.min_alive_hosts})")
        if r.get("deadline_expired"):
            print(f"  {r['deadline_expired']} requests expired their "
                  f"--default-deadline-ms={args.default_deadline_ms} budget")
        if "state_push_mb" in r:
            print(f"  serve/stats pushes ({r['state_wire']} wire): "
                  f"{r['state_push_mb']:.2f}MB to the global tier")
        result["faasm"] = r
    return result


if __name__ == "__main__":
    main()
