"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [--smoke]``.

Port of ``repro.launch.serve``: build the model, prefill a batch of
prompts, then decode greedily, reporting the prefill and decode times of
the loop's ``Generation`` (on the card its device spans) and observing them
in the metrics registry.  ``--faasm-requests N`` then pushes an N-request wave
through the port's Faasm runtime (``invoke_many`` + ``wait_all`` on a shared
completion latch) and reports p50/p99 latency and batch throughput; with
``--state-wire`` each request also adds its token to the shared
``serve/stats`` vector and pushes the delta over that wire.

On the card the serving loop replays CUDA graphs of its prefill and decode
step, captured once (``launch/step_graphs.py``), as the reference calls
its jitted steps; and each fan-out call replays a captured forward
(``launch/call_graphs.py``), as the reference's calls run the jitted
forward it keeps in the runtime's executable cache, after copying its
parameters from pinned host leaves.

Everything runs on the CUDA card (``--device cuda``, the default) and raises
when there is none; the CPU runs only when asked for (``--device cpu``).
"""
from __future__ import annotations

import argparse
from typing import Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.call_graphs import CallGraphs, flat_layout, flat_views
from repro_torch.launch.step_graphs import ServeGraphs, eager_generate
from repro_torch.models import ExecConfig, build_model
from repro_torch.models.weights import numpy_to_torch, params_class
from repro_torch.overload import DEADLINE_RC, SHED_RC
from repro_torch.telemetry import clock as tclock
from repro_torch.telemetry import metrics as tmetrics


def pinned_empty(numel: int, dtype: torch.dtype) -> torch.Tensor:
    """An uninitialised flat buffer in page-locked host memory (raises
    without a card)."""
    return torch.empty(numel, dtype=dtype, pin_memory=True)


class HostLeaves(Mapping):
    """The parameters' host leaves (CPU tensors) by name: what travels in
    the Proto-Faaslet snapshot.  The leaves are packed into one flat buffer
    per dtype (``call_graphs.flat_layout``; each leaf a view), so that a
    call on the card copies them with one transfer per dtype.

    With ``pin`` (a runtime on the card) the flat buffers are page-locked,
    so that the copy runs at the host link's rate with no staging copy;
    and since a pickled tensor comes back pageable, unpickling pins again.
    So the leaves are pinned once per decoded snapshot template
    (``ProtoFaaslet.user_state_template``), and a container's
    re-initialisation pays for its own pinning.  Without ``pin`` (the CPU)
    nothing is pinned."""

    def __init__(self, leaves: Mapping[str, torch.Tensor],
                 pin: bool = False) -> None:
        layout, sizes = flat_layout((n, t.dtype, t.shape)
                                    for n, t in leaves.items())
        self._set(layout, {dtype: self._buffer(n, dtype, pin)
                           for dtype, n in sizes.items()}, pin)
        for name, t in leaves.items():
            self._leaves[name].copy_(t)

    @staticmethod
    def _buffer(numel: int, dtype: torch.dtype, pin: bool) -> torch.Tensor:
        if pin:
            return pinned_empty(numel, dtype)
        return torch.empty(numel, dtype=dtype)

    def _set(self, layout, flats, pin) -> None:
        self.pin, self.layout, self.flats = bool(pin), layout, flats
        self._leaves = flat_views(layout, flats)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._leaves[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._leaves)

    def __len__(self) -> int:
        return len(self._leaves)

    def __getstate__(self) -> dict:
        return {"pin": self.pin, "layout": self.layout, "flats": self.flats}

    def __setstate__(self, state: dict) -> None:
        flats = state["flats"]
        if state["pin"]:             # a pickled tensor comes back pageable
            flats = {dtype: pinned_empty(f.numel(), dtype).copy_(f)
                     for dtype, f in flats.items()}
        self._set(state["layout"], flats, state["pin"])


def host_leaves(params: torch.nn.Module) -> HostLeaves:
    """The parameters as picklable host leaves (:class:`HostLeaves`, not
    pinned), copied from wherever they lie."""
    return HostLeaves({n: p.detach() for n, p in params.named_parameters()})


def bind_params(cfg, leaves, device: torch.device) -> torch.nn.Module:
    """The parameters of ``cfg``'s family (``weights.params_class``) on
    ``device`` over copies of ``leaves`` (CPU tensors or numpy arrays, by
    name) — every parameter crosses to the device, as the reference's
    per-call ``tree_unflatten`` of ``jnp.asarray`` leaves does."""
    p = params_class(cfg)(cfg, device="meta")
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


_CAPTURE_METRIC = ("faasm_serve_call_capture_ms",
                   "warm-up and capture of a slot's forward")


def make_infer_function(model, leaves, prompt_len: int = 16,
                        cache_key=("serve", "fwd"), state_wire: str = None,
                        device="cuda"):
    """Build the FAASM ``infer`` FunctionDef for a single-shot forward pass.

    The compiled forward lands in the runtime's ExecutableCache under
    ``cache_key``, built once and warmed at ``(1, prompt_len)`` as the
    reference's jitted forward is; the picklable host ``leaves`` travel in
    the Proto-Faaslet snapshot (:class:`HostLeaves`, which the init pins
    on the card), and each call copies them to the device afresh, as the
    reference's ``jnp.asarray`` of each leaf does.

    On the card (``device`` cuda) the cache entry is a
    :class:`~repro_torch.launch.call_graphs.CallGraphs` with one slot per
    executor of the runtime: a call copies its leaves into a slot's static
    buffers and replays that slot's captured forward; a failed capture or
    replay fails the call, and nothing runs the forward eagerly on the
    card.  On the CPU the entry is the eager forward over parameters bound
    by :func:`bind_params`.  Per call, ``faasm_serve_param_h2d_ms`` times
    the parameter copy and ``faasm_serve_call_forward_ms`` the forward and
    argmax (CUDA events on the slot's stream on the card; the host clock on
    the CPU), ``faasm_serve_call_capture_ms`` each warm-up and capture of
    a slot's forward (the build's included) and, with ``state_wire``,
    ``faasm_serve_call_stats_ms`` the serve/stats pull, add and push.

    With ``state_wire`` set, each request additionally accumulates the
    predicted token into the shared ``serve/stats`` histogram and pushes the
    delta with that wire format (``"int8"`` = the quantised
    ``kernels/state_push`` path; ``"auto"`` = the per-key adaptive
    ``WirePolicy``).  The warm-replica refresh before each push rides the
    wire fabric too: only the retained delta is pulled."""
    from repro_torch.core import FunctionDef

    device = torch.device(device)
    graphed = device.type == "cuda"

    @torch.no_grad()
    def fwd(p, tokens):
        return model.logits(p, tokens)

    def _observe(metrics, name: str, help_: str, ms: float) -> None:
        metrics.histogram(name, help_).observe(ms)

    def _build(rt, call_leaves):
        warm = np.zeros((1, prompt_len), np.int32)
        if not graphed:
            fwd(bind_params(model.cfg, call_leaves, device),
                torch.from_numpy(warm))
            return fwd
        # a slot for each executor thread of the runtime, all hosts
        graphs = CallGraphs(model, sum(h.capacity
                                       for h in rt.hosts.values()), device)
        r = graphs(call_leaves, warm)          # captures slot 0, replays
        _observe(rt.metrics, *_CAPTURE_METRIC, r.capture_ms)
        return graphs

    def init(api):
        pinned = HostLeaves(leaves, pin=graphed)
        api.runtime.exec_cache.get_or_build(
            cache_key, lambda: _build(api.runtime, pinned))
        return {"params": pinned}

    def infer(api):
        t_call = tclock.now()
        rt = api.runtime
        call_leaves = api.host.user_state(api.faaslet)["params"]
        fwd_, _, _ = rt.exec_cache.get_or_build(
            cache_key, lambda: _build(rt, call_leaves))
        tokens = np.frombuffer(api.read_call_input(),
                               np.int32).reshape(1, -1)
        if graphed:
            r = fwd_(call_leaves, tokens)
            tok, h2d_ms, fwd_ms = r.token, r.h2d_ms, r.forward_ms
            if r.capture_ms:
                _observe(rt.metrics, *_CAPTURE_METRIC, r.capture_ms)
        else:
            t0 = tclock.now()
            p = bind_params(model.cfg, call_leaves, device)
            t1 = tclock.now()
            tok = int(torch.argmax(fwd_(p, torch.from_numpy(tokens.copy()))
                                   [0, -1]))
            h2d_ms, fwd_ms = (t1 - t0) * 1e3, (tclock.now() - t1) * 1e3
        _observe(rt.metrics, "faasm_serve_param_h2d_ms",
                 "per-call parameter copy to the device", h2d_ms)
        _observe(rt.metrics, "faasm_serve_call_forward_ms",
                 "per-call forward and argmax", fwd_ms)
        if state_wire is not None:
            from repro_torch.state.ddo import VectorAsync
            t0 = tclock.now()
            stats = VectorAsync(api, "serve/stats")
            stats.pull(track_delta=True)
            stats.add([tok], 1.0)
            stats.push_delta(wire=state_wire)
            _observe(rt.metrics, "faasm_serve_call_stats_ms",
                     "per-call serve/stats pull, add and push",
                     (tclock.now() - t0) * 1e3)
        api.write_call_output(np.int32(tok).tobytes())
        _observe(rt.metrics, "faasm_serve_infer_ms",
                 "infer call body, queueing excluded",
                 (tclock.now() - t_call) * 1e3)
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
    ``param_h2d_ms``, ``forward_ms`` and ``infer_ms`` (the wave's mean
    per-call parameter copy, forward and call body, queueing excluded;
    with ``state_wire`` also ``stats_ms``, its serve/stats push),
    ``param_bytes`` (what each call copies), ``capture_ms`` and
    ``captures`` (every warm-up and capture of the run: the build's, the
    warm-up wave's and the wave's) and, on the card, what the
    :class:`~repro_torch.launch.call_graphs.CallGraphs` counted: ``slots``,
    ``replays`` (every call's, the build's included) and
    ``warmup_launches`` (the warm-ups' launches, a ``LaunchLog``, read
    apart from the replays'); with ``state_wire``, ``stats``:
    the global ``serve/stats`` value at the end.  The graphs are freed when
    the runtime shuts down.

    The call's forward is ``model.logits(params, tokens)``, as the
    reference's ``make_infer_function`` runs it, with no extra input: the
    VLM and encoder/decoder families, which need one, raise (ROADMAP
    "Enc-dec and VLM: the fan-out")."""
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
        if model.cfg.family in ("encdec", "vlm"):
            raise NotImplementedError(
                f"{model.cfg.name}: the Faasm fan-out's forward takes no "
                f"{model.cfg.family} input (ROADMAP 'Enc-dec and VLM: the "
                f"fan-out')")
        if state_wire is not None:
            VectorAsync.create(rt.global_tier, "serve/stats",
                               np.zeros(vocab_size, np.float32))
        leaves = host_leaves(params)
        rt.upload(make_infer_function(model, leaves, prompt_len=prompt_len,
                                      state_wire=state_wire,
                                      device=rt.device))
        payloads = fanout_payloads(vocab_size, n_requests, prompt_len)
        # warm every executor before timing the wave
        warm = rt.invoke_many("infer", payloads[:capacity], state_hint=hint)
        rt.wait_all(warm, timeout=300)
        rt.global_tier.reset_metrics()
        h2d = rt.metrics.histogram("faasm_serve_param_h2d_ms")
        fwd = rt.metrics.histogram("faasm_serve_call_forward_ms")
        body = rt.metrics.histogram("faasm_serve_infer_ms")
        capture = rt.metrics.histogram("faasm_serve_call_capture_ms")
        push = rt.metrics.histogram("faasm_serve_call_stats_ms")
        h2d0, fwd0, body0, push0 = ((h2d.count, h2d.sum), fwd.sum, body.sum,
                                    push.sum)
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
               "forward_ms": (fwd.sum - fwd0) / n_calls,
               "infer_ms": (body.sum - body0) / n_calls,
               "param_bytes": sum(x.numel() * x.element_size()
                                  for x in leaves.values()),
               "capture_ms": capture.sum, "captures": capture.count}
        if rt.device.type == "cuda":
            graphs = rt.exec_cache.get(("serve", "fwd"))
            out.update(slots=graphs.slots, replays=graphs.replays,
                       warmup_launches=graphs.warmup_launches)
        if state_wire is not None:
            out["state_wire"] = state_wire
            out["stats_ms"] = (push.sum - push0) / n_calls
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


def serve_extra(model, batch: int, rng: np.random.Generator, device):
    """The extra input the reference's launcher draws after the prompt,
    from the same ``rng``: unit normals of ``model.extra_shape(batch)`` (a
    VLM's stubbed patch embeddings, an encoder's stubbed frames), cast
    from f64 to bf16 in one step as the reference's ``jnp.asarray``; None
    for a family without one."""
    shape = model.extra_shape(batch)
    if shape is None:
        return None
    return torch.from_numpy(rng.normal(size=shape)).to(device=device,
                                                       dtype=torch.bfloat16)


@torch.no_grad()
def main(argv: Optional[List[str]] = None, keep_logits: bool = False) -> dict:
    """Run the serving loop (and the fan-out); returns what it produced.

    On the card the loop runs as the reference's does, each step compiled
    once: :class:`~repro_torch.launch.step_graphs.ServeGraphs` runs one
    prefill and one decode step eagerly, captures each as a CUDA graph,
    and then replays the prefill graph once and the decode graph once per
    new token.  The warm-up and capture come before the timers start and
    land in ``faasm_serve_graph_capture_ms``; the prefill and decode
    times are the replays' on the device's clock (the batch's device
    spans, ``ServeGraphs.generate``).  That is the one difference kept
    from the reference, whose first prefill includes its jit compile.  On
    the CPU (``--device cpu``), which has no graphs, the loop runs op by
    op (:func:`~repro_torch.launch.step_graphs.eager_generate`) and its
    times are the host's.

    The result holds the config, model, parameters, prompt ``tokens``
    (B, S), the family's ``extra`` input (:func:`serve_extra`), the
    generated ids ``gen`` (B, new_tokens), the prefill and
    decode wall times and ``graphs``, the ServeGraphs object (None on the
    CPU; its ``close`` frees the graphs), with ``capture_s``, its warm-up
    and capture time; with ``--faasm-requests`` also ``faasm``, the
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
    h_capture = reg.histogram("faasm_serve_graph_capture_ms",
                              "warm-up and capture of the step graphs")
    sum0 = h_capture.sum            # the registry outlives a call

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, ExecConfig(backend="auto"))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device)

    B, S = args.batch, args.prompt_len
    max_len = S + args.new_tokens + model.prefix_len
    rng = np.random.default_rng(args.seed)      # the JAX launcher's prompts
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             dtype=torch.int32, device=device)
    extra = serve_extra(model, B, rng, device)  # and its extra input

    graphs = None
    if device.type == "cuda":       # the compiled step, captured before t0
        t0 = tclock.now()
        graphs = ServeGraphs(model, params, B, S, max_len, device,
                             extra=extra)
        h_capture.observe((tclock.now() - t0) * 1e3)
        run = graphs.generate(tokens, args.new_tokens, keep_logits)
    else:
        run = eager_generate(model, params, tokens, args.new_tokens,
                             keep_logits, extra=extra)
    # on the card the loop's own serve.prefill device span observes
    # faasm_serve_prefill_ms (telemetry/device.py)
    prefill_s, decode_s = run.prefill_s, run.decode_s
    if graphs is None:
        h_prefill.observe(prefill_s * 1e3)
    h_decode.observe(decode_s * 1e3)
    gen_ids = run.ids
    capture_s = (h_capture.sum - sum0) / 1e3
    if graphs is not None:
        print(f"{cfg.name}: step graphs warmed up and captured in "
              f"{capture_s * 1e3:.1f}ms")
    print(f"{cfg.name}: prefill {S} toks in {prefill_s * 1e3:.1f}ms; "
          f"{args.new_tokens - 1} decode steps in {decode_s * 1e3:.1f}ms "
          f"({(args.new_tokens - 1) * B / max(decode_s, 1e-9):.1f} tok/s)")
    print("generated ids[0]:", gen_ids[0][:12].cpu().numpy(), "...")
    result = {"cfg": cfg, "model": model, "params": params, "tokens": tokens,
              "extra": extra, "gen": gen_ids, "prefill_s": prefill_s, "decode_s": decode_s,
              "graphs": graphs, "capture_s": capture_s}
    if keep_logits:
        result["logits"] = run.logits

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
        print(f"  per call: parameter copy {r['param_h2d_ms']:.2f}ms "
              f"({r['param_bytes'] / 1e9:.3f} GB), forward "
              f"{r['forward_ms']:.2f}ms; {r['captures']} captures in "
              f"{r['capture_ms']:.1f}ms")
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
