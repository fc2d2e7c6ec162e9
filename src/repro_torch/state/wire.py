"""Symmetric wire fabric for two-tier state movement (Faasm §4.2).

Every byte that crosses the tier boundary — delta **pushes** (replica →
global), delta **pulls** (global → warm replica refresh) and **peer
broadcast** (global → every subscribed replica) — travels as one
:class:`WireFrame`, encoded and decoded by a :class:`WireCodec`.  The codec
is direction-agnostic: the int8 encode is the fused ``kernels/state_push``
quantise kernel whichever side runs it, and the decode/apply is the same
``q·scale`` accumulate whether it lands in the global buffer (push), a host
replica (pull/broadcast) or a torch device replica (``ops.apply_pull``).

Wire tuple layout (the protocol, see ROADMAP "Wire protocol"):

  ``(wire, numel, payload, scales, prev_version → version)``

  * ``wire="exact"`` — ``payload`` is the flat f32 delta itself, ``scales``
    is ``None``; wire bytes = ``4·numel``.
  * ``wire="int8"``  — ``payload`` is the ``(rows, 128)`` int8 quantised
    delta, ``scales`` the per-row f32 absmax scales; wire bytes ≈ ``numel``.
  * ``wire="int4"``  — codes in ``[-7, 7]``, two per byte (lane 2k low
    nibble, lane 2k+1 high): ``payload`` is ``(rows, 64)`` uint8; wire
    bytes ≈ ``numel/2``.  Opt-in (``LocalTier.wire_tiers``).
  * ``wire="fp8"``   — ``payload`` is ``(rows, 128)`` float8_e4m3fn codes
    scaled to ±448; wire bytes ≈ ``numel``, but the format keeps ~2 decimal
    digits of per-element precision where int8 keeps a fixed absolute step.
    Opt-in; gated on ``ml_dtypes`` being importable.
  * ``prev_version``/``version`` stamp the key's global write version the
    frame moved between — a receiver applies a frame only when its replica
    sits exactly at ``prev_version`` (anything else is repaired by the next
    delta pull, which re-bases on the receiver's actual version).

Error-feedback **residual ownership**: quantisation debt always lives with
the party whose value is behind by it.  A push residual belongs to the
pushing replica (host- or device-side, as before); a pull residual belongs
to the pulling replica and is threaded through
:meth:`GlobalTier.pull_wire`, so repeated int8 refreshes converge instead of
random-walking.  Broadcast frames carry no residual: the broadcast payload
is byte-identical to the delta the global tier itself applied, so applying
it is exact replication.

:class:`WirePolicy` replaces the caller-chosen ``wire=`` knob (kept as an
override): per key, it picks int8 vs exact from the observed delta
magnitude/density and the error-feedback residual norm, with flip-flop
damping (a switch needs ``damping`` consecutive contrary observations).
When the :class:`WireCostModel` is armed (``enable_cost_model``), selection
upgrades from the magnitude heuristic to **measured wall-clock**: the model
learns per-(wire, size-bucket) encode and delivery cost online from the
``wire.push``/``wire.pull`` spans' ``encode_ns`` tags (seeded from
``BENCH_codec.json``), and ``select`` answers with the wire whose predicted
end-to-end push is cheapest among the residual-qualified candidates.
Disarmed — the default — every cost hook is one pointer compare
(``_COST is None``), same discipline as the sanitizer and tracer hooks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch import faults
# numpy-only host codec helpers: nibble pack/unpack + row decode
from repro_torch.kernels.state_push import hostcodec

WIRES = ("exact", "int8", "int4", "fp8")

# quantised tiers narrower than int8; opt-in via LocalTier.wire_tiers or an
# explicit wire= override, never chosen by a default WirePolicy
NARROW_TIERS = ("int4", "fp8")

# repro_torch.analysis.sanitizer installs its hook state here (enable()); None
# compiles every check in this module down to one pointer compare
_SAN = None

# Values smaller than this stay on the exact wire even when int8 is
# requested: the per-row scales + dispatch overhead eat the 4x payload
# saving on tiny values.  (Historic home: repro_torch.state.local, re-exported
# there for compatibility.)
INT8_WIRE_MIN_BYTES = 4096


def host_f32(x) -> np.ndarray:
    """``x`` (numpy, or a torch tensor on any device) as flat host f32."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy().reshape(-1)
    return np.asarray(x, np.float32).reshape(-1)


@dataclass
class WireFrame:
    """One unit of tier traffic: a flat f32 delta in encoded form."""

    wire: str                           # codec name, one of WIRES
    numel: int                          # flat f32 elements the delta covers
    payload: np.ndarray                 # exact: f32[numel]; int8: (R,128) i8
    scales: Optional[np.ndarray] = None  # int8: (R,1) f32 absmax scales
    dtype: np.dtype = np.dtype(np.float32)  # value dtype the delta applies to
    prev_version: int = -1              # key version the frame applies on top of
    version: int = -1                   # key version the frame produces
    origin: Optional[str] = None        # pushing host (stamped by apply_wire):
    # a replica pulling through the window must skip its own frames — its
    # buffer already holds those deltas in un-quantised form

    @property
    def nbytes(self) -> int:
        """Bytes this frame moves across a tier boundary."""
        n = int(self.payload.nbytes)
        if self.scales is not None:
            n += int(self.scales.nbytes)
        return n

    def decode(self) -> np.ndarray:
        """The flat f32 delta of length ``numel`` (pure numpy — safe to call
        under a stripe lock; kernel-side decode is ``ops.apply_pull``)."""
        if self.wire == "exact":
            return self.payload.reshape(-1)[:self.numel]
        payload = self.payload
        if self.wire == "int4":
            payload = hostcodec.unpack_int4(payload)
        return (payload.astype(np.float32)
                * self.scales).reshape(-1)[:self.numel]

    def codes(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The kernel-applyable ``(q, scales)`` row pair for quantised frames
        (int4 payloads are nibble-unpacked to int8), ``None`` for exact —
        the device fast path (``ops.apply_pull``) consumes this so a
        ``DeviceReplica`` value never round-trips through a host decode."""
        if self.wire == "exact":
            return None
        payload = self.payload
        if self.wire == "int4":
            payload = hostcodec.unpack_int4(payload)
        return payload, self.scales


class ExactCodec:
    """Identity wire: the frame payload is the f32 delta itself.

    ``encode`` still flushes any error-feedback residual handed to it (the
    exact wire pays quantisation debt in full), so a replica switching wires
    mid-stream never strands debt."""

    name = "exact"

    def encode(self, eff, base, *, backend: Optional[str] = None,
               device="cuda") -> Tuple[WireFrame, Any]:
        """Encode ``eff − base`` as an exact frame.  ``eff``/``base`` are
        flat f32 (numpy or torch; device tensors are copied to the host).
        Returns ``(frame, residual)`` with residual ``None`` — the exact
        wire drops nothing."""
        if hostcodec.usable(eff, base):
            # chunked host path: each completed chunk of the payload is
            # final wire bytes while later chunks are still encoding
            delta = hostcodec.encode_exact(eff, base)
        else:
            delta = np.ascontiguousarray(host_f32(eff) - host_f32(base))
        return WireFrame(wire=self.name, numel=delta.size,
                         payload=delta), None

    def encode_delta(self, delta: np.ndarray, *,
                     backend: Optional[str] = None,
                     device="cuda") -> WireFrame:
        """Encode an already-computed flat f32 delta (pull direction)."""
        delta = np.ascontiguousarray(np.asarray(delta, np.float32).reshape(-1))
        return WireFrame(wire=self.name, numel=delta.size, payload=delta)


class QuantCodec:
    """Quantised wire: the fused ``kernels/state_push`` codec family.

    The encode runs the fused quantise path on the tier's device — the
    numpy host codec on the CPU, one kernel launch on the card for host
    buffers and device tensors alike — and returns the error-feedback
    residual:
    what quantisation dropped, to be carried by the owning replica into its
    next encode.  Subclasses fix the tier: int8 (codes ±127), int4 (codes
    ±7, nibble-packed two per byte) and fp8 (float8_e4m3fn codes ±448)."""

    name = "int8"
    qmax = 127
    packed = False       # int4: payload is nibble-packed (R, 64) uint8

    def _encode_rows(self, eff, base, backend, device, with_residual):
        from repro_torch.kernels.state_push import ops

        return ops.encode_quant(eff, base, qmax=self.qmax, backend=backend,
                                device=device, with_residual=with_residual)

    def encode(self, eff, base, *, backend: Optional[str] = None,
               device="cuda") -> Tuple[WireFrame, Any]:
        """Returns ``(frame, residual)``; the residual is host numpy for
        numpy operands and stays on the operands' device for tensors."""
        from repro_torch.kernels.state_push import ops

        faults.point("codec-error")
        q, s, n, residual = self._encode_rows(eff, base, backend, device,
                                              True)
        if _SAN is not None:
            # recompute the dequantised carry from the codes themselves so
            # the conservation check is independent of the fused residual
            deq = ops.dequantize(np.asarray(q), np.asarray(s), int(n))
            true_delta = (host_f32(eff)[:int(n)] - host_f32(base)[:int(n)])
            _SAN.check_residual(true_delta, np.asarray(deq),
                                host_f32(residual))
        payload = np.asarray(q)
        if self.packed:
            payload = hostcodec.pack_int4(payload)
        return WireFrame(wire=self.name, numel=int(n), payload=payload,
                         scales=np.asarray(s, np.float32)), residual

    def encode_delta(self, delta: np.ndarray, *,
                     backend: Optional[str] = None,
                     device="cuda") -> WireFrame:
        """Encode an already-computed flat f32 delta (pull direction) —
        same fused quantise path, zero base (no zeros materialised)."""
        delta = np.asarray(delta, np.float32).reshape(-1)
        q, s, n, _ = self._encode_rows(delta, None, backend, device, False)
        payload = np.asarray(q)
        if self.packed:
            payload = hostcodec.pack_int4(payload)
        return WireFrame(wire=self.name, numel=int(n), payload=payload,
                         scales=np.asarray(s, np.float32))


class Int8Codec(QuantCodec):
    name = "int8"
    qmax = 127


class Int4Codec(QuantCodec):
    """Narrow tier: codes in [-7, 7], two per byte — ≈ numel/2 wire bytes.

    Coarse (absmax/7 step) — viable only under the error-feedback residual
    discipline, and only where ``WirePolicy.residual_cap`` admits it."""

    name = "int4"
    qmax = 7
    packed = True


class Fp8Codec(QuantCodec):
    """Narrow tier: float8_e4m3fn codes scaled to ±448 — ≈ numel wire bytes
    with relative (not absolute) per-element precision.  Gated on
    ``ml_dtypes`` importability (``hostcodec.fp8_available()``)."""

    name = "fp8"
    qmax = 0             # unused; fp8 scales to ±FP8_MAX

    def _encode_rows(self, eff, base, backend, device, with_residual):
        from repro_torch.kernels.state_push import ops

        return ops.encode_fp8(eff, base, backend=backend, device=device,
                              with_residual=with_residual)


def frame_from_quantized(q, scales, numel: int, *,
                         dtype=np.float32) -> WireFrame:
    """Wrap a raw ``kernels/state_push`` wire tuple ``(q, scales, numel)``
    as an int8 frame — the codec-layer constructor for compatibility
    fronts (e.g. ``GlobalTier.apply_quantized``) that receive the tuple
    instead of encoding it themselves.  Keeps ``WireFrame`` construction
    inside this module (the ``wire-construct`` lint rule), so frames can't
    skip version stamping or residual ownership."""
    return WireFrame(wire="int8", numel=int(numel), payload=np.asarray(q),
                     scales=np.asarray(scales, np.float32),
                     dtype=np.dtype(dtype))


_CODECS: Dict[str, Any] = {"exact": ExactCodec(), "int8": Int8Codec(),
                           "int4": Int4Codec()}
if hostcodec.fp8_available():
    _CODECS["fp8"] = Fp8Codec()


def get_codec(wire: str):
    try:
        return _CODECS[wire]
    except KeyError:
        if wire == "fp8":
            raise ValueError(
                "wire 'fp8' requires ml_dtypes (float8_e4m3fn)") from None
        raise ValueError(f"wire {wire!r} not in {WIRES}") from None


def available_wires() -> Tuple[str, ...]:
    """The wires this process can actually encode (fp8 needs ml_dtypes)."""
    return tuple(w for w in WIRES if w in _CODECS)


class WireCostModel:
    """Measured per-(wire, size-bucket) push cost, learned online.

    Every armed ``wire.push``/``wire.pull`` feeds one observation:
    ``encode_ns`` (the codec's own time, the span's ``encode_ns`` tag) and
    the remainder of the span wall (delivery: version stamping, apply,
    broadcast hand-off — the "transfer" of an in-process fabric).  Both are
    EWMA-smoothed per wire per power-of-two **value** size bucket, so
    ``predict`` answers "what will a push of this value cost end-to-end on
    this wire, here, now" from evidence rather than a magnitude heuristic.

    ``seed(BENCH_codec.json)`` pre-loads the curve from the span-derived
    benchmark so the first pushes after arming already rank wires sensibly;
    online observations then keep it honest.

    ``link_bytes_per_s`` models a real interconnect: when set, ``predict``
    adds ``frame_bytes/link`` so quantised tiers win exactly where the
    bytes saved outrun their encode cost — the crossover the benchmark
    summarises."""

    MIN_BUCKET, MAX_BUCKET = 10, 30      # 1 KB .. 1 GB value sizes

    def __init__(self, *, alpha: float = 0.25,
                 link_bytes_per_s: Optional[float] = None):
        self.alpha = alpha
        self.link_bytes_per_s = link_bytes_per_s
        self._enc: Dict[Tuple[str, int], float] = {}   # EWMA encode ns
        self._rest: Dict[Tuple[str, int], float] = {}  # EWMA non-encode ns
        self.samples = 0

    @classmethod
    def bucket(cls, value_bytes: int) -> int:
        b = max(1, int(value_bytes)).bit_length() - 1
        return min(max(b, cls.MIN_BUCKET), cls.MAX_BUCKET)

    @staticmethod
    def frame_bytes(wire: str, value_bytes: int) -> int:
        """Analytic wire bytes for a f32 value of ``value_bytes``."""
        numel = max(1, value_bytes // 4)
        rows = max(1, -(-numel // 128))
        scales = rows * 4
        if wire == "exact":
            return value_bytes
        if wire == "int4":
            return rows * 64 + scales
        return rows * 128 + scales       # int8 / fp8: one byte per element

    def observe(self, wire: str, value_bytes: int, encode_ns: float,
                wall_ns: Optional[float] = None) -> None:
        key = (wire, self.bucket(value_bytes))
        a = self.alpha
        prev = self._enc.get(key)
        self._enc[key] = encode_ns if prev is None else prev + a * (encode_ns - prev)
        if wall_ns is not None:
            rest = max(0.0, wall_ns - encode_ns)
            prev = self._rest.get(key)
            self._rest[key] = rest if prev is None else prev + a * (rest - prev)
        self.samples += 1

    def _lookup(self, table: Dict[Tuple[str, int], float], wire: str,
                bucket: int, value_bytes: int) -> Optional[float]:
        """Nearest observed bucket for ``wire``, linearly rescaled to
        ``value_bytes`` (encode and delivery are ~linear in size past the
        dispatch floor, so per-byte extrapolation is the right first-order
        model between buckets)."""
        got = table.get((wire, bucket))
        if got is not None:
            return got
        best = None
        for (w, b), ns in table.items():
            if w != wire:
                continue
            if best is None or abs(b - bucket) < abs(best[0] - bucket):
                best = (b, ns)
        if best is None:
            return None
        return best[1] * (value_bytes / float(1 << best[0]))

    def predict(self, wire: str, value_bytes: int) -> Optional[float]:
        """Predicted end-to-end push wall in ns, or ``None`` when this wire
        has never been observed at any size (the caller should probe it)."""
        bucket = self.bucket(value_bytes)
        enc = self._lookup(self._enc, wire, bucket, value_bytes)
        if enc is None:
            return None
        total = enc
        rest = self._lookup(self._rest, wire, bucket, value_bytes)
        if rest is not None:
            total += rest
        if self.link_bytes_per_s:
            total += self.frame_bytes(wire, value_bytes) \
                / self.link_bytes_per_s * 1e9
        return total

    def seed(self, bench: Any) -> int:
        """Seed from a ``BENCH_codec.json`` dict (or path).  Returns the
        number of (wire, size) rows loaded; unknown wires are skipped."""
        if isinstance(bench, (str, bytes)):
            import json
            with open(bench) as fh:
                bench = json.load(fh)
        loaded = 0
        for kb in bench.get("value_kb", ()):
            row = bench.get(f"{kb}kb", {})
            for w, stats in row.items():
                if w not in WIRES or not isinstance(stats, dict):
                    continue
                enc_ns = stats.get("encode_us_p50", 0.0) * 1e3
                wall_ns = stats.get("push_us_p50", 0.0) * 1e3
                self.observe(w, int(kb) << 10, enc_ns, wall_ns or None)
                loaded += 1
        return loaded

    def snapshot(self) -> Dict[str, Dict[int, Tuple[float, float]]]:
        """{wire: {bucket: (encode_ns, rest_ns)}} — the scrape-time
        collector publishes this as ``faasm_wire_cost_*`` gauges."""
        out: Dict[str, Dict[int, Tuple[float, float]]] = {}
        for (w, b), enc in self._enc.items():
            out.setdefault(w, {})[b] = (enc, self._rest.get((w, b), 0.0))
        return out


# the armed cost model, or None (the default): every consult site is one
# pointer compare, the same zero-overhead discipline as _SAN/_TEL hooks
_COST: Optional[WireCostModel] = None


def enable_cost_model(model: Optional[WireCostModel] = None,
                      **kwargs) -> WireCostModel:
    """Arm the measured-cost wire selection (and span-fed learning).
    Returns the installed model; ``kwargs`` construct one when not given."""
    global _COST
    _COST = model if model is not None else WireCostModel(**kwargs)
    return _COST


def disable_cost_model() -> None:
    global _COST
    _COST = None


def cost_model() -> Optional[WireCostModel]:
    return _COST


class WirePolicy:
    """Per-key adaptive wire selection with flip-flop damping.

    Two selection regimes share the structural fallbacks (non-float dtypes
    and sub-``min_bytes`` values are always exact):

    * **heuristic** (cost model disarmed, the default): the historic binary
      exact-vs-quantised choice driven by residual/density votes, below.
    * **measured-cost** (``enable_cost_model()`` armed): ``select`` asks the
      :class:`WireCostModel` for the predicted end-to-end push wall of
      ``exact`` and every *residual-qualified* tier in ``tiers``, and
      answers the cheapest; a never-observed wire is probed once so the
      model can learn it.  Residual discipline still rules: a tier whose
      last ``damping`` observations breached ``residual_cap`` is banned
      from candidacy until a re-probe (every ``probe_after`` pushes)
      re-qualifies it — cost never overrides correctness.

    ``tiers`` lists the quantised wires this key may ride (default
    ``("int8",)``; the narrow int4/fp8 tiers are opt-in via
    ``LocalTier.wire_tiers``).  ``observe`` feeds back what the last encode
    saw:

      * ``residual_ratio`` — mean |residual| over mean |carried delta|.
        Near zero for well-conditioned deltas; grows past ``residual_cap``
        when per-row outliers make the absmax scale coarse (quantisation is
        dropping real signal) → prefer exact.  ``None`` means the push rode
        the exact wire and produced **no quantisation evidence** — such
        observations never vote for int8 (that would guarantee a permanent
        exact↔int8 thrash on keys int8 genuinely mishandles); instead they
        count toward a periodic **re-probe**: after ``probe_after`` dense
        exact pushes, ``select`` routes a single push back onto int8 so its
        residual can re-qualify (or re-disqualify) the cheap wire.
      * ``density`` — nonzero fraction of the encoded delta.  Below
        ``min_density`` the delta is a handful of spot writes; per-row
        scales carry almost no information → prefer exact.

    A switch requires ``damping`` consecutive observations preferring the
    other wire; any confirming observation resets the streak, so an
    alternating workload doesn't thrash the wire (flip-flop damping)."""

    def __init__(self, *, min_bytes: int = INT8_WIRE_MIN_BYTES,
                 residual_cap: float = 0.25, min_density: float = 1.0 / 256,
                 damping: int = 3, probe_after: int = 8,
                 tiers: Iterable[str] = ("int8",)):
        self.min_bytes = min_bytes
        self.residual_cap = residual_cap
        self.min_density = min_density
        self.damping = max(1, damping)
        self.probe_after = max(1, probe_after)
        self.tiers = tuple(tiers)
        for t in self.tiers:
            if t == "exact" or t not in WIRES:
                raise ValueError(f"tier {t!r} not a quantised wire in {WIRES}")
        self._quant = self.tiers[0] if self.tiers else "int8"
        self._wire = self._quant
        self._streak = 0
        self._exact_obs = 0              # dense exact pushes since last probe
        self.flips = 0                   # damped wire switches (telemetry)
        self._over_cap = {t: 0 for t in self.tiers}  # consecutive breaches
        self._banned: set = set()        # residual-disqualified tiers
        self._since_ban: Dict[str, int] = {}

    @property
    def wire(self) -> str:
        """The adaptive choice for values past the structural fallbacks."""
        return self._wire

    def select(self, nbytes: int, dtype, *, probe: bool = True) -> str:
        """The wire to use now.  ``probe=False`` (pull-side selection) reads
        the current choice without consuming the quantised re-probe — a
        pull's encode produces no ``observe`` feedback, so spending the
        probe on it would starve the push wire's re-qualification."""
        if np.dtype(dtype).kind != "f" or nbytes < self.min_bytes:
            return "exact"
        cost = _COST
        if cost is not None:
            return self._select_cost(cost, nbytes, probe)
        if (probe and self._wire == "exact"
                and self._exact_obs >= self.probe_after):
            self._exact_obs = 0
            return self._quant           # one probe push; observe() decides
        return self._wire

    def _select_cost(self, cost: WireCostModel, nbytes: int,
                     probe: bool) -> str:
        """Measured-cost selection: cheapest predicted end-to-end push among
        exact and the residual-qualified tiers; never-observed wires are
        probed once so the model can rank them."""
        choice, best_ns = None, None
        for w in ("exact",) + self.tiers:
            if w in self._banned:
                if probe:
                    self._since_ban[w] = self._since_ban.get(w, 0) + 1
                    if self._since_ban[w] >= self.probe_after:
                        # one re-qualification push on the banned tier
                        self._since_ban[w] = 0
                        choice = w
                        break
                continue
            p = cost.predict(w, nbytes)
            if p is None:
                choice = w               # unknown cost: probe to learn
                break
            if best_ns is None or p < best_ns:
                choice, best_ns = w, p
        if choice != self._wire:
            self._wire = choice
            self.flips += 1
        return choice

    def observe(self, *, delta_absmax: float, density: float,
                residual_ratio: Optional[float] = None,
                wire: Optional[str] = None) -> None:
        if delta_absmax == 0.0:
            return                       # a no-op push teaches nothing
        if residual_ratio is not None and wire in self._over_cap:
            # per-tier residual discipline (both regimes): `damping`
            # consecutive cap breaches ban the tier; a clean observation
            # (e.g. the re-probe) re-qualifies it
            if residual_ratio > self.residual_cap:
                self._over_cap[wire] += 1
                if self._over_cap[wire] >= self.damping:
                    self._over_cap[wire] = 0
                    self._banned.add(wire)
                    self._since_ban[wire] = 0
            else:
                self._over_cap[wire] = 0
                self._banned.discard(wire)
        if _COST is not None:
            return                       # cost regime: selection is measured
        if residual_ratio is None:
            # exact-wire push: quantisation quality unknown.  Sparse deltas
            # still vote exact; dense ones only advance the re-probe clock.
            if density < self.min_density:
                self._vote("exact")
            elif self._wire == "exact":
                self._exact_obs += 1
            return
        prefer_exact = (residual_ratio > self.residual_cap
                        or density < self.min_density)
        self._vote("exact" if prefer_exact else self._quant)

    def _vote(self, want: str) -> None:
        if want == self._wire:
            self._streak = 0
            return
        self._streak += 1
        if self._streak >= self.damping:
            self._wire = want
            self._streak = 0
            self._exact_obs = 0
            self.flips += 1
