"""Local state tier: zero-copy shared replicas on one host (Faasm §4.2).

Replicas live in *shared memory regions* (§3.3): one numpy buffer per state
value, and every Faaslet on the host maps a **view** of the same buffer into
its address space — reads and writes are genuinely shared, no serialisation.
Chunk presence is tracked so a pull only transfers missing chunks.

Tier synchronisation is single-copy each way: pulls ``readinto`` the replica
buffer straight from global storage and pushes ``write_from`` it straight
back (no get→bytes→frombuffer→assign round trip), and ``push_delta`` applies
``global += local − base`` arithmetically in the global buffer — the
HOGWILD serialisation point holds the key's global write lock for one
in-place pass instead of four full-value copies.

Device-resident replica plane: a replica can additionally hold its value as
a **torch tensor on the tier's device** (:class:`DeviceReplica`) with
explicit ``to_device``/``from_device`` sync.  Device tensors are never
updated in place: frames apply into new tensors, and the delta base is a
copy of the value, not a second name for it (a JAX array is immutable, a
tensor is not — an in-place write through one name would move both).  Staleness is tracked against the
replica's write version — every host-side mutation (``mark_dirty``, pull)
bumps ``Replica.version``; the device copy records the version it was
synced at, so a stale device array is never silently pushed.

Lock order: the tier's ``"tier"`` mutex guards only its maps and is
never held across a replica lock.  A replica's ``RWLock`` (kind
``"replica"``) comes first; inside it the replica's buffer mutex
(``Replica.buf_lock``, kind ``"replica-buf"``); inside that, at most a
global-tier stripe lock.  Never the other way round: the runtime
sanitizer learns the kind order as it runs and reports a reverse
acquisition.  The buffer mutex is held for one numpy call on the shared
buffer and released before ``mark_dirty``; never across an encode, a
wire apply or a broadcast.  Every write of the shared buffer takes it:
a function's HOGWILD ``VectorAsync.add``/``__setitem__`` (which hold no
replica lock), ``set_state``, and on the tier's side a full or chunk
pull's overwrite, a frame's in-place apply, the window-miss catch-up's
move and ``from_device``.  A quantised push takes it for its one read of
the buffer, a push for its re-base, ``to_device`` for its copy (the
version read first).  A push re-bases from the content it shipped: the
one read it made or, from an f32 device replica, the content the copy
was synced from; never a second read of the live buffer.  A push from
the host buffer drops a stale device copy's delta base and takes back its
error-feedback debt, so the next device push does not ship it twice.  So
no two writes of the buffer interleave and no f32 count is lost: a push
either shipped an add or leaves it pending in ``buffer − base``.  Not
covered, as device-side writes by design: a device replica of another
dtype re-bases from the live buffer, ``from_device`` overwrites the
buffer, and ``to_device(track_delta=True)`` re-arms the device base at
its sync; a host add racing one of them can be lost.

Symmetric wire fabric (``repro_torch.state.wire``): every delta crossing the tier
boundary is a :class:`~repro_torch.state.wire.WireFrame` encoded by a
:class:`~repro_torch.state.wire.WireCodec` — identically in both directions.

  * **Push** — ``push_delta(wire="int8")`` runs the fused
    ``kernels/state_push`` quantise kernel on the pusher (device-native when
    a fresh :class:`DeviceReplica` is bound — the value never round-trips
    through host buffers) and the global tier lands the frame via
    :meth:`GlobalTier.apply_wire` (~¼ of the f32 bytes).  Exact f32 pushes
    travel as exact frames so they too are recorded/broadcast.  Per-replica
    **error feedback** carries the quantisation residual into the next push.
  * **Pull** — a warm replica that knows its base version refreshes through
    :meth:`GlobalTier.pull_wire`: only the retained delta ships (int8 ≈ ¼
    of a full f32 re-pull), with a full-pull fallback when the base
    predates the retained window; the pull-side residual is owned by the
    pulling replica.
  * **Broadcast** — a :meth:`subscribe`\\ d replica receives every frame a
    peer pushes and applies it in place (host buffer, delta base, fresh
    device arrays via ``ops.apply_pull``), converging with zero pull bytes.

``wire="auto"`` (or ``None``) delegates the choice to the key's
:class:`~repro_torch.state.wire.WirePolicy`: with the
:class:`~repro_torch.state.wire.WireCostModel` armed it argmins the measured
per-size end-to-end push cost over ``exact`` and the residual-qualified
tiers in ``wire_tiers`` (the opt-in menu — ``set_wire_tiers("int8",
"int4", "fp8")``); disarmed, the historic exact-vs-quantised vote from
observed delta magnitude/density and residual norm, with flip-flop
damping.  Explicit ``wire=`` strings remain as overrides.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Set

import numpy as np
import torch

from repro_torch import faults
from repro_torch.analysis.sanitizer import make_mutex, wrap_rwlock
from repro_torch.state import wire as _wire_mod
from repro_torch.state.kv import GlobalTier, RWLock
from repro_torch.state.wire import (INT8_WIRE_MIN_BYTES, WIRES, WireFrame,
                                    WirePolicy, get_codec, host_f32)
from repro_torch.telemetry import clock as _clock

__all__ = ["DeviceReplica", "INT8_WIRE_MIN_BYTES", "LocalTier", "Replica"]

# per-wire maximum |code|: absmax ≈ scale·QMAX reconstructs the delta absmax
# from the wire tuple without a second full-array pass
_WIRE_QMAX = {"int8": 127.0, "int4": 7.0, "fp8": 448.0}


class CodecFallback(Exception):
    """Internal: a quantised encode failed mid-push; ``push_delta`` retries
    the same delta (same fence token) on the exact wire so no state is
    lost."""

# repro_torch.analysis.sanitizer installs its hook state here (enable()); None
# compiles every check in this module down to one pointer compare
_SAN = None
# repro_torch.telemetry installs its tracer here (enable()); same discipline —
# disarmed is one pointer compare per wire event, zero ring writes.  Ring
# writes are lock-safe (single-writer per thread), so spans may be
# recorded under replica/key locks; only collector drains may not.
_TEL = None


def _mean_abs(x) -> float:
    """Mean |x| as a python float; works for numpy arrays and tensors (a
    device tensor syncs only the scalar, not the array)."""
    if x is None:
        return 0.0
    n = x.numel() if isinstance(x, torch.Tensor) else x.size
    return float(abs(x).mean()) if n else 0.0


def _add_prefix(x: torch.Tensor, delta: np.ndarray) -> torch.Tensor:
    """A new flat tensor: ``x`` with ``delta`` added to its first
    ``delta.size`` elements (in ``x``'s dtype; ``x`` is not modified)."""
    out = x.reshape(-1).clone()
    k = min(out.numel(), delta.size)
    out[:k] += torch.tensor(delta[:k], device=out.device).to(out.dtype)
    return out


@dataclass
class DeviceReplica:
    """Optional device residency for a replica (one value, one device).

    ``value`` is the flat typed tensor mirroring the replica buffer;
    ``base`` the device-side snapshot a delta push diffs against (a copy of
    the pushed value, never the same tensor: an in-place write to one must
    not move the other); ``residual`` the error-feedback carry for
    quantised wire pushes, owned by the device while the replica is fresh.
    ``synced_version`` is the :attr:`Replica.version` the device copy was
    taken at; ``device_dirty`` marks device-side writes (``update_device``)
    not yet propagated back to the shared host buffer."""

    dtype: np.dtype = np.dtype(np.float32)
    value: Any = None                    # torch.Tensor, flat
    base: Any = None                     # torch.Tensor snapshot for delta push
    residual: Any = None                 # torch.Tensor f32 error-feedback carry
    synced_version: int = -1
    device_dirty: bool = False

    def fresh(self, replica: "Replica") -> bool:
        """True when the device arrays are safe to push from: either in sync
        with the host buffer or strictly ahead of it (device-side writes)."""
        return self.value is not None and (
            self.device_dirty or self.synced_version == replica.version)


@dataclass
class Replica:
    buf: np.ndarray                      # uint8, the shared region backing
    lock: RWLock = field(
        default_factory=lambda: wrap_rwlock(RWLock(), "replica"))
    # held for one numpy write of ``buf`` (module docstring: lock order)
    buf_lock: Any = field(default_factory=lambda: make_mutex("replica-buf"))
    present_chunks: Set[int] = field(default_factory=set)
    dirty_chunks: Set[int] = field(default_factory=set)
    full: bool = False                   # whole value present
    base: Optional[np.ndarray] = None    # snapshot for delta-accumulating push
    version: int = 0                     # bumped on every host-side mutation
    residual: Optional[np.ndarray] = None  # f32 error-feedback carry (int8 wire)
    device: Optional[DeviceReplica] = None
    # wire-fabric state: the global write version this replica's content
    # incorporates (-1 = unknown, e.g. locally fabricated via set_state —
    # such replicas keep the legacy never-refresh semantics), and the
    # pull-direction error-feedback carry (owned by the pulling replica)
    global_version: int = -1
    pull_residual: Optional[np.ndarray] = None
    # element type of the value's delta pushes (None until the first one):
    # what a window-miss refresh needs to move the buffer arithmetically
    delta_dtype: Optional[np.dtype] = None


class LocalTier:
    """Per-host replica store.  All Faaslets of the host share these buffers."""

    def __init__(self, host_id: str, global_tier: GlobalTier):
        self.host_id = host_id
        self.global_tier = global_tier
        # where device replicas live and the wire codec runs
        self.device = global_tier.device
        # fabric identity: host_id may later be re-pointed at the physical
        # host for transfer metrics (container tiers charge the host), but
        # frames must be attributed to THIS tier — sibling container tiers
        # sharing a metrics id must not skip each other's frames on pull or
        # collide on one broadcast subscription slot
        self.origin_id = host_id
        self._replicas: Dict[str, Replica] = {}
        self._policies: Dict[str, WirePolicy] = {}
        self._subscribed: Set[str] = set()
        self._mutex = make_mutex("tier", f"tier:{host_id}")
        self.codec_fallbacks = 0     # quantised encodes rescued by exact wire
        # quantised tiers the per-key policies may choose from; the narrow
        # int4/fp8 tiers are opt-in (set_wire_tiers) — their coarser codes
        # ride the same residual_cap error-feedback discipline
        self.wire_tiers = ("int8",)

    # -- replica lifecycle ------------------------------------------------------

    def replica(self, key: str, size: Optional[int] = None) -> Replica:
        """Get or create the shared replica buffer for ``key`` (no transfer)."""
        with self._mutex:
            r = self._replicas.get(key)
            if r is None:
                if size is None:
                    size = self.global_tier.size(key)
                r = Replica(buf=np.zeros(size, np.uint8))
                self._replicas[key] = r
            elif size is not None and size > r.buf.size:
                grown = np.zeros(size, np.uint8)
                grown[:r.buf.size] = r.buf
                r.buf = grown
                r.version += 1
            return r

    def has(self, key: str) -> bool:
        with self._mutex:
            return key in self._replicas

    def drop(self, key: Optional[str] = None) -> None:
        """Evict replicas (host failure / memory pressure).  Any broadcast
        subscriptions and warm-puller registrations for the dropped keys
        are cancelled — a host that leaves mid-broadcast stops receiving
        frames, and pushers stop retaining window frames for it."""
        with self._mutex:
            if key is None:
                self._replicas.clear()
                self._subscribed.clear()
            else:
                self._replicas.pop(key, None)
                self._subscribed.discard(key)
        self.global_tier.unsubscribe(self.origin_id, key)
        self.global_tier.deregister_puller(self.origin_id, key)

    def memory_bytes(self) -> int:
        with self._mutex:
            return sum(r.buf.size for r in self._replicas.values())

    def keys(self):
        with self._mutex:
            return list(self._replicas.keys())

    # -- device residency (explicit sync, version-checked staleness) -----------

    def to_device(self, key: str, dtype=np.float32, *,
                  track_delta: bool = False):
        """Materialise (or refresh) the replica as a tensor on the tier's
        device.

        Returns the device value.  A no-op when the device copy is already
        at the replica's current write version.  With ``track_delta`` the
        device-side base snapshot is (re)taken at this sync point, arming a
        subsequent device-native ``push_delta``.  A host-side error-feedback
        residual moves to the device with the value (ownership transfer —
        the debt must not be applied twice).  While device-side writes are
        pending (``update_device`` without a push or ``from_device``),
        ``track_delta`` is a no-op: re-arming the base to the unsynced value
        would silently drop that delta from every future push.

        The returned tensor is the device replica itself: write results
        back with :meth:`update_device` (a new tensor), not in place."""
        r = self._replicas[key]
        dt = np.dtype(dtype)
        # write lock: this mutates r.device and the DeviceReplica fields, and
        # concurrent to_device calls must not race on creating/arming them
        r.lock.acquire_write()
        try:
            d = r.device
            if d is None or d.dtype != dt:
                d = DeviceReplica(dtype=dt)
                r.device = d
            if not d.device_dirty and (d.value is None
                                       or d.synced_version != r.version):
                # one coherent read under the buffer mutex, the version
                # taken before it: an add whose version bump comes after
                # the read leaves the copy stale, so the next push reads
                # the host buffer.  torch.tensor copies: on the CPU,
                # torch.from_numpy (and a .to() of it) would alias the
                # shared buffer, but the device replica must be a
                # *snapshot* at this version
                with r.buf_lock:
                    ver = r.version
                    d.value = torch.tensor(r.buf.view(dt), device=self.device)
                if r.residual is not None and \
                        r.residual.size == d.value.numel():
                    debt = torch.tensor(r.residual, device=self.device)
                    d.residual = debt if d.residual is None \
                        else d.residual + debt
                    r.residual = None            # device owns the debt now
                d.synced_version = ver
            if track_delta and not d.device_dirty:
                d.base = d.value.clone()
            return d.value
        finally:
            r.lock.release_write()

    def update_device(self, key: str, value) -> None:
        """Install a device-computed value as the replica's device copy.

        The device copy is now *ahead* of the shared host buffer; call
        :meth:`from_device` to propagate it (or ``push_delta`` to ship the
        delta straight to the global tier without a host round-trip)."""
        r = self._replicas[key]
        r.lock.acquire_write()
        try:
            d = r.device
            if d is None:
                raise RuntimeError(f"no device replica for {key!r}; "
                                   "call to_device first")
            if isinstance(value, torch.Tensor):
                value = value.to(self.device)
            else:                        # a copy, never a view of host memory
                value = torch.tensor(np.asarray(value), device=self.device)
            if value.numel() * d.dtype.itemsize > r.buf.size:
                raise ValueError(f"device value larger than replica {key!r}")
            d.value = value
            d.device_dirty = True
        finally:
            r.lock.release_write()

    def from_device(self, key: str) -> int:
        """Copy the device value back into the shared host buffer (one D2H
        memcpy), bump the write version, and mark the range dirty.  The
        device-side delta base and error-feedback residual come back with
        it, so a later *host-path* push diffs against the content the global
        tier last saw instead of re-pushing device-era deltas.  Returns
        bytes synced."""
        r = self._replicas[key]
        r.lock.acquire_write()
        try:
            d = r.device
            if d is None or d.value is None:
                raise RuntimeError(f"no device value for {key!r}")
            # snapshot d.value under the lock: a concurrent update_device
            # must not land between the read and the device_dirty clear
            host = d.value.detach().cpu().numpy().reshape(-1).view(np.uint8)
            n = min(host.size, r.buf.size)
            with r.buf_lock:
                r.buf[:n] = host[:n]
            if d.base is not None:
                hb = d.base.detach().cpu().numpy().reshape(-1).view(np.uint8)
                if r.base is None or r.base.size != r.buf.size:
                    r.base = np.zeros(r.buf.size, np.uint8)
                m = min(hb.size, r.base.size)
                r.base[:m] = hb[:m]
            if d.residual is not None:
                # np.array copies: a CPU tensor's .numpy() shares its memory
                r.residual = np.array(host_f32(d.residual), dtype=np.float32)
                d.residual = None                # host owns the debt again
            cs = self.global_tier.chunk_size
            if n:
                r.dirty_chunks.update(range(0, (n - 1) // cs + 1))
            r.version += 1
            d.synced_version = r.version
            d.device_dirty = False
        finally:
            r.lock.release_write()
        return n

    def device_replica(self, key: str) -> Optional[DeviceReplica]:
        r = self._replicas.get(key)
        return r.device if r is not None else None

    def device_stale(self, key: str) -> bool:
        """True when host-side writes postdate the last device sync (and the
        device holds no unsynced writes of its own)."""
        r = self._replicas[key]
        d = r.device
        if d is None or d.value is None:
            return True
        return not d.device_dirty and d.synced_version != r.version

    # -- wire policy / broadcast subscription -----------------------------------

    def wire_policy(self, key: str) -> WirePolicy:
        """The key's adaptive wire selector (shared by push and pull)."""
        with self._mutex:
            p = self._policies.get(key)
            if p is None:
                p = self._policies[key] = WirePolicy(tiers=self.wire_tiers)
            return p

    def set_wire_tiers(self, *tiers: str) -> None:
        """Opt this tier's keys into a different quantised-tier menu (e.g.
        ``set_wire_tiers("int8", "int4")``).  Existing per-key policies are
        rebuilt — learned selection state restarts from the defaults."""
        for t in tiers:
            get_codec(t)                 # unknown/unavailable wires fail loud
        self.wire_tiers = tuple(tiers)
        with self._mutex:
            self._policies.clear()

    def policy_flips(self) -> int:
        """Total damped wire switches across this tier's per-key policies
        (telemetry: published as ``faasm_wire_policy_flips_total``)."""
        with self._mutex:
            return sum(p.flips for p in self._policies.values())

    def subscribe(self, key: str) -> int:
        """Subscribe this tier's replica to the key's push fan-out: every
        wire frame another host applies to the global value is delivered and
        applied in place (host buffer, delta base, fresh device arrays), so
        the warm replica converges with **zero pull bytes**.  Returns the
        bytes the initial sync pulled.

        The callback registers *before* the initial pull: a frame pushed in
        between is either already inside the pulled content (the pull
        captures value+version atomically) or arrives with a version that
        chains onto it — registering after the pull would lose any frame
        landing in the gap and leave every later one skipped on the version
        check.  Early deliveries against the not-yet-pulled replica are
        version-mismatched no-ops."""
        self.replica(key, self.global_tier.size(key))
        with self._mutex:
            self._subscribed.add(key)
        self.global_tier.subscribe(key, self.origin_id, self._deliver)
        return self.pull(key)

    def unsubscribe(self, key: Optional[str] = None) -> None:
        with self._mutex:
            if key is None:
                self._subscribed.clear()
            else:
                self._subscribed.discard(key)
        self.global_tier.unsubscribe(self.origin_id, key)

    def _deliver(self, key: str, frame: WireFrame) -> None:
        """Broadcast delivery: apply when the frame extends exactly this
        replica's version; anything else (gap from a missed frame, an
        out-of-order race between two pushers, a duplicate) is skipped —
        the next pull repairs it through the delta window.  Raising (e.g.
        the replica was evicted) drops the subscription tier-side."""
        if faults.point("wire-frame-drop", key=key, host=self.host_id):
            return                       # frame lost on the wire to this peer
        faults.point("wire-frame-delay", key=key, host=self.host_id)
        faults.point("subscriber-raise", key=key, host=self.host_id)
        # a stalled subscriber: runs on the broadcast pump thread, so the
        # stall backpressures this host's bounded channel (coalescing, then
        # drop-to-pull-repair) — never the pusher (asserted in test_chaos)
        faults.point("subscriber-stall", key=key, host=self.host_id)
        with self._mutex:
            r = self._replicas.get(key)
        if r is None:
            raise KeyError(f"replica {key!r} evicted")
        tel = _TEL
        t0 = tel.now() if tel is not None else 0.0
        applied = False
        r.lock.acquire_write()
        try:
            if frame.prev_version == r.global_version:
                self._apply_frame_locked(r, frame)
                applied = True
        finally:
            r.lock.release_write()
        if tel is not None:
            tel.record("wire.bcast", "wire", t0, tel.now(), key=key,
                       wire=frame.wire, nbytes=frame.nbytes, applied=applied,
                       prev_version=frame.prev_version, version=frame.version,
                       subscriber=self.origin_id)

    def _apply_frame_locked(self, r: Replica, frame: WireFrame, *,
                            backend: Optional[str] = None,
                            set_version: Optional[int] = None) -> None:
        """Apply a wire frame to the replica (write lock held): the host
        buffer, the delta base (the global tier already holds this delta —
        without the base update the next ``push_delta`` would re-push it),
        and a fresh device replica's arrays, so a device-native push keeps
        diffing against content the global tier has seen."""
        if _SAN is not None:
            _SAN.assert_write_held(r.lock, "_apply_frame_locked")
        delta = frame.decode()
        dt = np.dtype(frame.dtype)
        # the frame names the value dtype it applies to: viewing the buffer
        # as anything else would scramble e.g. an f64 key's bytes
        fv = r.buf[:r.buf.size - r.buf.size % dt.itemsize].view(dt)
        n = min(fv.size, delta.size)
        if n:
            add = delta[:n].astype(dt, copy=False)
            with r.buf_lock:
                fv[:n] += add
        if r.base is not None and r.base.size >= dt.itemsize:
            bv = r.base[:r.base.size - r.base.size % dt.itemsize].view(dt)
            m = min(bv.size, delta.size)
            if m:
                bv[:m] += delta[:m].astype(dt, copy=False)
        d = r.device
        was_fresh = d is not None and d.value is not None and d.fresh(r)
        if was_fresh:
            if min(d.value.numel(), delta.size):
                codes = (frame.codes()
                         if d.value.numel() == frame.numel else None)
                if codes is not None:
                    # quantised frame onto a device value: the fused kernel
                    # applies q·scale on device into a new tensor — no host
                    # round-trip (int4 arrives nibble-unpacked, fp8 casts
                    # in-kernel)
                    from repro_torch.kernels.state_push import ops
                    d.value = ops.apply_pull(d.value, codes[0], codes[1],
                                             backend=backend)
                else:
                    d.value = _add_prefix(d.value, delta)
                if d.base is not None:
                    d.base = _add_prefix(d.base, delta)
        r.version += 1
        if was_fresh and not d.device_dirty:
            d.synced_version = r.version
        r.global_version = frame.version if set_version is None \
            else set_version

    # -- pull / push (tier synchronisation) ----------------------------------------

    def pull(self, key: str, *, wire: Optional[str] = None,
             backend: Optional[str] = None) -> int:
        """Ensure the replica holds the current global value.  Returns bytes
        moved (0 on an up-to-date replica) — symmetric with :meth:`push`.

        Cold replicas full-pull as before.  A replica that already holds
        the full value and knows its base version **refreshes through the
        wire fabric**: the global tier ships only the retained delta
        (``wire="int8"`` re-encodes it with the fused ``kernels/state_push``
        quantise kernel, ~¼ of the f32 re-pull bytes; ``wire=None``/"auto"
        lets the key's :class:`WirePolicy` decide; ``wire="exact"`` ships
        the f32 delta), falling back to a full pull when the base predates
        the retained delta window.  Pull-side quantisation error is carried
        per replica as an error-feedback residual into the next delta pull."""
        faults.point("tier-pull-stall", key=key, host=self.host_id)
        size = self.global_tier.size(key)
        r = self.replica(key, size)
        moved = 0
        r.lock.acquire_write()
        try:
            if not r.full:
                moved = self._full_pull_locked(key, r, size)
                r.full = True
                r.present_chunks = set(range(self.global_tier.n_chunks(key)))
            elif r.global_version >= 0:
                moved = self._refresh_locked(key, r, size, wire, backend)
        finally:
            r.lock.release_write()
        return moved

    def _full_pull_locked(self, key: str, r: Replica, size: int, *,
                          refresh_base: bool = False) -> int:
        """Whole-value pull (replica write lock held): one ``readinto``
        memcpy, base version captured atomically with the content.

        ``refresh_base`` (the warm-refresh fallback) re-stamps the delta
        base from the pulled buffer: the buffer now *is* the global value,
        so the base must say the global tier has seen it — otherwise the
        next ``push_delta`` would re-push every peer write since the old
        snapshot.  The cold path keeps the legacy leave-the-base semantics
        (callers re-arm with ``track_delta``/``snapshot_base``)."""
        tel = _TEL
        t0 = tel.now() if tel is not None else 0.0
        moved = 0
        if size:
            with r.buf_lock:
                moved, ver = self.global_tier.readinto(
                    key, 0, r.buf[:size], host=self.host_id, clamp=True,
                    return_version=True)
        else:
            ver = self.global_tier.version(key)
        if tel is not None and moved:
            tel.record("wire.full_pull", "wire", t0, tel.now(), key=key,
                       nbytes=moved, version=ver, puller=self.origin_id)
        # a warm full replica is a future delta-puller: declare interest so
        # pushers start feeding the key's retained window
        self.global_tier.register_puller(key, self.origin_id)
        r.global_version = ver
        r.pull_residual = None
        if moved:
            r.version += 1
            if refresh_base and r.base is not None:
                self._refresh_base(r)
        return moved

    def _refresh_locked(self, key: str, r: Replica, size: int,
                        wire: Optional[str],
                        backend: Optional[str]) -> int:
        """Warm-replica refresh (replica write lock held): delta pull
        through the wire fabric, full-pull fallback on a stale base."""
        w = wire
        if w in (None, "auto"):
            w = self.wire_policy(key).select(r.buf.size,
                                             np.dtype(np.float32),
                                             probe=False)
        res = self.global_tier.pull_wire(
            key, r.global_version, wire=w, residual=r.pull_residual,
            exclude_origin=self.origin_id, backend=backend,
            host=self.host_id)
        if res is None:
            # base older than the window floor (or non-delta writes landed):
            # the delta path can't express the catch-up.  A delta-tracked
            # replica catches up in place, keeping its un-pushed writes; an
            # untracked one with un-pushed local writes keeps the legacy
            # warm no-op (a full pull would clobber them), and a clean one
            # full-pulls and re-bases.
            if r.delta_dtype is not None and r.base is not None and \
                    r.base.size == r.buf.size == size:
                return self._catch_up_locked(key, r, size)
            if r.dirty_chunks:
                return 0
            return self._full_pull_locked(key, r, size, refresh_base=True)
        frame, ver, residual = res
        if frame is None:
            r.global_version = ver
            return 0
        self._apply_frame_locked(r, frame, backend=backend, set_version=ver)
        r.pull_residual = residual
        return frame.nbytes

    def _catch_up_locked(self, key: str, r: Replica, size: int) -> int:
        """Window-miss refresh of a delta-tracked replica (write lock held):
        pull the whole global value, then move the buffer by ``global −
        base`` in place and re-base on the global value.

        The overwrite of a full pull loses HOGWILD writes: a co-located
        faaslet's add lands in the shared buffer before it marks the range
        dirty, and a push that read the buffer earlier clears the dirty
        record, so the ``dirty_chunks`` guard cannot see every pending
        write.  The in-place move keeps ``buffer − base`` — every write not
        yet pushed — whatever the dirty record says.  The move is a
        read-modify-write of the buffer, so it holds the buffer mutex: an
        add lands before it (and is kept) or after it."""
        tel = _TEL
        t0 = tel.now() if tel is not None else 0.0
        fresh = np.empty(size, np.uint8)
        moved, ver = self.global_tier.readinto(
            key, 0, fresh, host=self.host_id, clamp=True,
            return_version=True)
        if tel is not None and moved:
            tel.record("wire.full_pull", "wire", t0, tel.now(), key=key,
                       nbytes=moved, version=ver, puller=self.origin_id)
        self.global_tier.register_puller(key, self.origin_id)
        dt = r.delta_dtype
        n = size // dt.itemsize * dt.itemsize
        gv = fresh[:n].view(dt)
        bv = r.base[:n].view(dt)
        fv = r.buf[:n].view(dt)
        move = gv - bv
        with r.buf_lock:
            fv += move
        bv[:] = gv
        r.global_version = ver
        r.pull_residual = None
        r.version += 1
        return moved

    def pull_chunk(self, key: str, chunk_idx: int) -> int:
        """Replicate a single state chunk (Fig. 4: partial values).
        Returns bytes moved (0 on a local hit)."""
        size = self.global_tier.size(key)
        r = self.replica(key, size)
        moved = 0
        r.lock.acquire_write()
        try:
            if chunk_idx not in r.present_chunks:
                start, length = self.global_tier.chunk_bounds(key, chunk_idx)
                if length > 0:
                    with r.buf_lock:
                        moved = self.global_tier.readinto(
                            key, start, r.buf[start:start + length],
                            host=self.host_id, clamp=True)
                r.present_chunks.add(chunk_idx)
                if len(r.present_chunks) == self.global_tier.n_chunks(key):
                    r.full = True
                if moved:
                    r.version += 1
        finally:
            r.lock.release_write()
        return moved

    def pull_range(self, key: str, offset: int, length: int) -> int:
        """Pull exactly the chunks covering [offset, offset+length).
        Returns bytes moved."""
        cs = self.global_tier.chunk_size
        moved = 0
        for idx in range(offset // cs, (offset + max(length, 1) - 1) // cs + 1):
            moved += self.pull_chunk(key, idx)
        return moved

    def push(self, key: str) -> int:
        """Write the full local replica to the global tier (single memcpy
        from the replica buffer).  Returns bytes."""
        with self._mutex:
            r = self._replicas[key]
        r.lock.acquire_read()
        try:
            moved = self.global_tier.write_from(key, 0, r.buf,
                                                host=self.host_id,
                                                truncate=True)
        finally:
            r.lock.release_read()
        r.dirty_chunks.clear()
        return moved

    def push_dirty(self, key: str) -> int:
        """Push only chunks marked dirty (partial push).  Returns bytes."""
        with self._mutex:
            r = self._replicas[key]
        moved = 0
        r.lock.acquire_read()
        try:
            dirty = sorted(r.dirty_chunks)
            cs = self.global_tier.chunk_size
            for idx in dirty:
                start = idx * cs
                end = min(start + cs, r.buf.size)
                if end > start:
                    moved += self.global_tier.write_from(
                        key, start, r.buf[start:end], host=self.host_id)
        finally:
            r.lock.release_read()
        r.dirty_chunks.clear()
        return moved

    def _resync_locked(self, key: str, r: Replica) -> None:
        """Throw away the replica's local divergence and re-pull the global
        truth (replica write lock held by the caller).

        Used when the replica's content can no longer be trusted to feed a
        delta push: a fenced-out push (the winning attempt's equivalent
        delta is — or will be — the global content; keeping ours would
        double-apply it on the next broadcast/pull) and a failed call's
        un-pushed dirty writes (:meth:`discard_unpushed`).  The full pull
        re-stamps the delta base, clears the dirty record and drops both
        error-feedback residuals; a bound device replica is marked stale so
        its next use re-syncs from the host buffer."""
        if _SAN is not None:
            _SAN.assert_write_held(r.lock, "_resync_locked")
        size = self.global_tier.size(key)
        self._full_pull_locked(key, r, size, refresh_base=r.base is not None)
        r.full = True
        r.present_chunks = set(range(self.global_tier.n_chunks(key)))
        r.dirty_chunks.clear()
        r.residual = None
        d = r.device
        if d is not None:
            d.synced_version = -1
            d.device_dirty = False
            d.residual = None
            d.base = None

    def discard_unpushed(self, key: str) -> bool:
        """Drop a replica's un-pushed local writes (failed/cancelled call).

        The container path already discards its whole private tier on a
        failed settle; warm faaslet-mode replicas are shared, so a failed
        call's half-written dirty chunks would otherwise survive and be
        served by the next pull.  Granularity is the replica: a concurrent
        call's not-yet-pushed writes to the *same* key are discarded too
        (both re-pull; pushed state is never touched).  Returns True when
        there was anything to discard."""
        with self._mutex:
            r = self._replicas.get(key)
        if r is None:
            return False
        r.lock.acquire_write()
        try:
            if not r.dirty_chunks:
                return False
            self._resync_locked(key, r)
            return True
        finally:
            r.lock.release_write()

    @staticmethod
    def _refresh_base(r: Replica) -> None:
        """Re-stamp the delta base from the buffer (replica write lock held
        by the caller)."""
        if r.base is None or r.base.size != r.buf.size:
            # faasmlint: disable=tier-copy -- replica-internal base snapshot
            r.base = r.buf.copy()
        else:
            r.base[:] = r.buf                # reuse the allocation

    @staticmethod
    def _rebase_pushed(r: Replica, pushed: np.ndarray) -> None:
        """Re-stamp the delta base from the f32 content a push actually read
        (replica write lock held).  Unlike :meth:`_refresh_base` this never
        re-reads the live buffer: co-located faaslets write it HOGWILD with
        no lock, so a base taken from a second read silently absorbs any add
        that landed between the push's read and the refresh — a lost update
        the delta stream can never repair.  Rebasing from the pushed
        snapshot keeps such an add pending for the next delta instead."""
        if r.base is None or r.base.size != r.buf.size:
            # faasmlint: disable=tier-copy -- replica-internal base snapshot
            r.base = r.buf.copy()
        bv = r.base.view(np.float32)
        n = min(bv.size, pushed.size)
        bv[:n] = pushed[:n]

    @staticmethod
    def _host_push_owns(r: Replica) -> None:
        """A push from the host buffer while a stale device copy is bound
        (replica write lock held).  The device's error-feedback debt comes
        back to the host, which pays it in this push, and the device's delta
        base is dropped: it is behind the content this push ships, so the
        next push from the device diffs against the host base instead of
        shipping this push's delta a second time.  Pending device-side
        writes keep both: they are not in a host push."""
        d = r.device
        if d is None or d.device_dirty:
            return
        if d.residual is not None:
            debt = np.array(host_f32(d.residual), dtype=np.float32)
            if r.residual is not None and r.residual.size == debt.size:
                debt += r.residual
            r.residual = debt
            d.residual = None
        d.base = None

    @staticmethod
    def _base_f32(r: Replica, dt: np.dtype, n: int) -> np.ndarray:
        """The delta base as f32 of exactly ``n`` elements (replica lock
        held).  A base snapshotted before the buffer grew is zero-extended —
        the new tail was never pushed, so its base *is* zero; silently using
        an all-zeros base instead would re-push the whole value.

        The common f32 full-size case returns a **view of r.base** (no
        value-sized alloc+copy per push): callers must force any kernel
        dispatched on it before mutating the base."""
        if (r.base is not None and dt == np.float32
                and r.base.size >= n * 4):
            return r.base.view(np.float32)[:n]
        out = np.zeros(n, np.float32)
        if r.base is not None:
            bv = r.base.view(dt)[:n]
            out[:bv.size] = bv.astype(np.float32, copy=False)
        return out

    def snapshot_base(self, key: str, *, force: bool = True) -> None:
        """Record the replica contents as the base for a future delta push.

        Takes the replica write lock: the base is mutated in place (reusing
        the allocation), and a concurrent ``push_delta`` holds the same lock
        — exclusion keeps it from observing a torn base.

        ``force=False`` arms tracking only when no current-sized base exists
        yet.  An existing base is already maintained by every push and pull
        (rebase-from-pushed-content, frame applies, full-pull re-stamps), so
        re-stamping it from the live buffer would silently absorb a
        co-located faaslet's not-yet-pushed HOGWILD writes into the base —
        a lost update.  ``pull_state(track_delta=True)`` on a warm shared
        replica uses this arm-only mode."""
        r = self._replicas[key]
        r.lock.acquire_write()
        try:
            if force or r.base is None or r.base.size != r.buf.size:
                self._refresh_base(r)
        finally:
            r.lock.release_write()

    def push_delta(self, key: str, dtype=np.float32, *, wire: str = "exact",
                   backend: Optional[str] = None,
                   fence: Optional[tuple] = None) -> int:
        """Accumulating push: global += (local − base), then refresh base.

        The cross-host-safe HOGWILD push: concurrent pushes from different
        hosts compose instead of overwriting.  Runs under the key's global
        write lock.  Returns bytes moved.

        ``wire`` selects the codec: ``"int8"`` runs the fused
        ``kernels/state_push`` quantise kernel on the pusher — from the
        device arrays when a fresh :class:`DeviceReplica` is bound, so
        device-resident values never round-trip through host buffers — and
        ships the int8+scales frame (~¼ of the f32 bytes) with per-replica
        error feedback; ``"exact"`` (default) ships the f32 delta frame (f32
        values) or accumulates in place (other dtypes).  ``"auto"``/``None``
        delegates to the key's :class:`WirePolicy`.  Float values smaller
        than ``INT8_WIRE_MIN_BYTES`` (and non-float dtypes) always take the
        exact path.

        Applied f32 frames are recorded in the key's retained delta window
        (feeding warm-replica delta pulls) and fanned out to subscribed
        peer replicas once the global lock is released.

        Locking: both wires take the replica write lock first (same-replica
        pushes are atomic — read, encode, base refresh) and the key's
        global write lock second.  The encode — the expensive kernel
        dispatch — runs *before* the global lock is taken, so concurrent
        pushers of the same key from different hosts pipeline their encodes
        and only the cheap wire apply serialises.  Broadcast fan-out runs
        with no locks held.

        ``fence`` is an attempt-fence token ``(call_id, epoch, seq)`` (see
        ``GlobalTier.fence_admit``): a push from a superseded or duplicate
        attempt performs no global effect, resynchronises the replica from
        the global truth, and returns 0."""
        faults.point("host-crash-pre-push", key=key, host=self.host_id)
        r = self._replicas[key]
        gt = self.global_tier
        dt = np.dtype(dtype)
        r.delta_dtype = dt
        auto = wire in (None, "auto")
        if auto:
            wire = self.wire_policy(key).select(r.buf.size, dt)
        if wire not in WIRES:
            raise ValueError(f"wire {wire!r} not in {WIRES + ('auto',)}")
        exact_framed = (dt == np.float32 and gt.delta_window > 0
                        and gt.wire_interest(key, exclude=self.origin_id))
        if (wire != "exact" and dt.kind == "f"
                and r.buf.size >= INT8_WIRE_MIN_BYTES):
            try:
                moved = self._push_delta_quant(key, r, dt, backend, wire=wire,
                                               auto=auto, fence=fence)
            except CodecFallback:
                # the quantised encode failed before any tier effect: the
                # delta must not be lost — re-push it on the exact wire with
                # the same fence token
                self.codec_fallbacks += 1
                if exact_framed:
                    moved = self._push_delta_exact_f32(key, r, backend,
                                                       fence=fence)
                else:
                    moved = self._push_delta_inplace(key, r, dt, fence=fence)
        elif exact_framed:
            moved = self._push_delta_exact_f32(key, r, backend, auto=auto,
                                               fence=fence)
        else:
            moved = self._push_delta_inplace(key, r, dt, fence=fence)
        faults.point("host-crash-post-push", key=key, host=self.host_id)
        return moved

    def _push_delta_inplace(self, key: str, r: Replica, dt: np.dtype, *,
                            fence: Optional[tuple] = None) -> int:
        """The zero-copy fast path: non-f32 dtypes — and f32 nobody else
        consumes frames of (no warm puller, no subscriber) or with the
        window disabled.  No frame is materialised, nothing retained; the
        tier invalidates the key's window.  The first consumer to appear
        full-pulls once and declares interest, flipping later pushes onto
        the frame path."""
        gt = self.global_tier
        tel = _TEL
        t0 = tel.now() if tel is not None else 0.0
        r.lock.acquire_write()
        try:
            self._host_push_owns(r)
            local = r.buf.view(dt)
            base = (r.base.view(dt)[:local.size]
                    if r.base is not None else None)
            rebased = base is not None and base.size == local.size
            if not rebased:
                # first tracked push: one read both pushes and becomes the
                # base, so an add after it stays pending
                with r.buf_lock:
                    # faasmlint: disable=tier-copy -- replica-internal base snapshot
                    local = local.copy()
            lock = gt.lock(key)
            lock.acquire_write()
            try:
                res = gt.add_inplace(
                    key, local, base, host=self.host_id,
                    return_version=True, rebase=rebased, fence=fence)
            finally:
                lock.release_write()
            if res is None:              # fenced out: superseded/duplicate
                self._resync_locked(key, r)
                if tel is not None:
                    tel.record("wire.push", "wire", t0, tel.now(), key=key,
                               wire="inplace", nbytes=0, fenced=True,
                               origin=self.origin_id)
                return 0
            moved, prev, new = res
            if not rebased:
                # first tracked push (no base yet): the base is the content
                # it read.  Later pushes rebase inside add_inplace from the
                # read itself.
                r.base = local.view(np.uint8)
            r.dirty_chunks.clear()
            # the pusher's buffer is the post-push content: keep its base
            # version current (same rule as _after_push) so its own warm
            # pulls stay 0-byte no-ops instead of full re-pulls
            if r.global_version == prev:
                r.global_version = new
            if tel is not None:
                tel.record("wire.push", "wire", t0, tel.now(), key=key,
                           wire="inplace", nbytes=moved, encode_ns=0,
                           prev_version=prev, version=new,
                           origin=self.origin_id)
            return moved
        finally:
            r.lock.release_write()

    def _push_delta_exact_f32(self, key: str, r: Replica,
                              backend: Optional[str], *,
                              auto: bool = False,
                              fence: Optional[tuple] = None) -> int:
        """Exact f32 push as a wire frame: the delta is materialised once,
        accumulated in place in the global buffer, retained in the key's
        delta window and broadcast to subscribed peers.  Any error-feedback
        residual is flushed into the frame — the exact wire pays
        quantisation debt in full.

        Like the int8 path, a fresh :class:`DeviceReplica` is pushed from
        its device arrays (device-side updates must not be silently dropped
        when the policy routes a device-resident key onto the exact wire);
        the exact wire ships f32 either way, so the D2H of the delta is the
        wire payload itself."""
        gt = self.global_tier
        codec = get_codec("exact")
        tel = _TEL
        cost = _wire_mod._COST
        timed = tel is not None or cost is not None
        t0 = tel.now() if tel is not None else 0.0
        enc0 = _clock.now_ns() if timed else 0
        r.lock.acquire_write()
        try:
            snap = None
            d = r.device
            if d is not None and d.fresh(r):
                local = host_f32(d.value)    # the D2H is the wire payload
                if d.base is not None:
                    base = host_f32(d.base)
                else:
                    base = self._base_f32(r, np.dtype(np.float32),
                                          local.size)
                eff = local
                if d.residual is not None:
                    eff = local + host_f32(d.residual)
                    d.residual = None        # exact wire pays the debt
                frame, _ = codec.encode(eff, base, backend=backend,
                                        device=self.device)
                d.base = d.value.clone()     # device snapshot
                host_synced = not d.device_dirty
                snap = local                 # the content it was synced from
            else:
                self._host_push_owns(r)
                local = r.buf.view(np.float32)
                base = self._base_f32(r, np.dtype(np.float32), local.size)
                eff = local
                flushed = None
                if r.residual is not None and r.residual.size == local.size:
                    flushed = r.residual
                    eff = local + r.residual
                    r.residual = None
                frame, _ = codec.encode(eff, base, backend=backend,
                                        device=self.device)
                # the buffer content the encode actually read, reconstructed
                # without a second read: base + payload == eff-as-read
                snap = base + frame.payload
                if flushed is not None:
                    snap -= flushed
                host_synced = True
            if host_synced:
                with r.buf_lock:
                    self._rebase_pushed(r, snap)
                r.dirty_chunks.clear()
        finally:
            r.lock.release_write()
        enc_ns = (_clock.now_ns() - enc0) if timed else 0
        lock = gt.lock(key)
        lock.acquire_write()
        try:
            moved = gt.apply_wire(key, frame, host=self.host_id,
                                  origin=self.origin_id, fence=fence)
        finally:
            lock.release_write()
        if moved is None:                # fenced out: superseded/duplicate
            r.lock.acquire_write()
            try:
                self._resync_locked(key, r)
            finally:
                r.lock.release_write()
            if tel is not None:
                tel.record("wire.push", "wire", t0, tel.now(), key=key,
                           wire=frame.wire, nbytes=0, fenced=True,
                           encode_ns=enc_ns, origin=self.origin_id)
            return 0
        self._after_push(key, r, frame)
        if cost is not None:
            cost.observe(frame.wire, frame.numel * 4, enc_ns,
                         wall_ns=_clock.now_ns() - enc0)
        if tel is not None:
            tel.record("wire.push", "wire", t0, tel.now(), key=key,
                       wire=frame.wire, nbytes=frame.nbytes,
                       numel=frame.numel, encode_ns=enc_ns,
                       prev_version=frame.prev_version,
                       version=frame.version, origin=self.origin_id)
        if auto:
            # adaptive feedback only when the policy made the choice: forced
            # pushes skip the two extra full-array metric passes
            delta = frame.payload
            self.wire_policy(key).observe(
                delta_absmax=float(np.abs(delta).max()) if delta.size else 0.0,
                density=float(np.count_nonzero(delta)) / max(delta.size, 1),
                wire=frame.wire)
        return moved

    def _push_delta_quant(self, key: str, r: Replica, dt: np.dtype,
                          backend: Optional[str], *, wire: str = "int8",
                          auto: bool = False,
                          fence: Optional[tuple] = None) -> int:
        """Quantised delta push (int8 / int4 / fp8): encode under the
        replica write lock, apply under the key's global write lock,
        broadcast with no locks held.

        Device-native when the replica has a fresh device copy: quantise
        runs on ``DeviceReplica.value``/``base``, only the wire frame comes
        back to the host and the residual stays on the device.  Otherwise
        the host replica buffer feeds the codec on the tier's device: the
        numpy host codec on the CPU, one kernel launch on the card."""
        gt = self.global_tier
        codec = get_codec(wire)
        tel = _TEL
        cost = _wire_mod._COST
        timed = tel is not None or cost is not None
        t0 = tel.now() if tel is not None else 0.0
        enc0 = _clock.now_ns() if timed else 0
        r.lock.acquire_write()
        try:
            snap = None
            d = r.device
            if d is not None and d.fresh(r):
                local = d.value
                if d.base is not None:
                    base = d.base.to(torch.float32)
                else:
                    # device copy synced without track_delta: diff against
                    # the host-side snapshot (what the exact wire would use),
                    # NOT against zeros — zeros would re-push the full value.
                    # torch.tensor copies: the kernel must not read a host
                    # base buffer this push later mutates
                    base = torch.tensor(
                        self._base_f32(r, dt, local.numel()),
                        device=local.device)
                eff = local.to(torch.float32)
                if d.residual is not None:
                    eff = eff + d.residual
                # codec.encode brings the frame to the host (a synchronising
                # copy), so nothing in flight still reads r.base when
                # _refresh_base mutates it below
                try:
                    frame, residual = codec.encode(eff, base, backend=backend,
                                                   device=self.device)
                except faults.FaultInjected as e:
                    # only the injected codec-error point is rescued: a
                    # kernel that fails to build or launch must fail the push
                    raise CodecFallback(e) from e
                d.residual = residual        # stays on the device
                d.base = local.clone()       # device snapshot
                # d.value mirrors the host buffer only when no device-side
                # writes are pending; then this push covered the host
                # content too — refresh the host base (or a later host push
                # re-applies this delta) and clear the dirty record.  With
                # pending device writes the host chunks stay dirty: their
                # content was NOT in this push.
                host_synced = not d.device_dirty
                if host_synced and dt == np.float32:
                    # the host base follows the content the device copy was
                    # synced from, never a second read of the live buffer
                    snap = host_f32(local)
            else:
                self._host_push_owns(r)
                local = r.buf.view(dt)
                base = self._base_f32(r, dt, local.size)
                if r.residual is None or r.residual.size != local.size:
                    r.residual = np.zeros(local.size, np.float32)
                with r.buf_lock:
                    snap = local.astype(np.float32)  # one coherent read
                eff = snap + r.residual
                try:
                    frame, residual = codec.encode(eff, base, backend=backend,
                                                   device=self.device)
                except faults.FaultInjected as e:
                    # only the injected codec-error point is rescued: a
                    # kernel that fails to build or launch must fail the push
                    raise CodecFallback(e) from e
                # owned writable copy (a host codec residual is a view of
                # its scratch buffer)
                r.residual = np.array(residual, dtype=np.float32)
                host_synced = True
            frame.dtype = dt
            if host_synced:
                with r.buf_lock:
                    if snap is not None and dt == np.float32:
                        self._rebase_pushed(r, snap)
                    else:
                        self._refresh_base(r)
                r.dirty_chunks.clear()
        finally:
            r.lock.release_write()
        enc_ns = (_clock.now_ns() - enc0) if timed else 0
        lock = gt.lock(key)
        lock.acquire_write()
        try:
            moved = gt.apply_wire(key, frame, host=self.host_id,
                                  origin=self.origin_id, fence=fence)
        finally:
            lock.release_write()
        if moved is None:                # fenced out: superseded/duplicate
            r.lock.acquire_write()
            try:
                self._resync_locked(key, r)
            finally:
                r.lock.release_write()
            if tel is not None:
                tel.record("wire.push", "wire", t0, tel.now(), key=key,
                           wire=frame.wire, nbytes=0, fenced=True,
                           encode_ns=enc_ns, origin=self.origin_id)
            return 0
        self._after_push(key, r, frame)
        if cost is not None:
            cost.observe(frame.wire, frame.numel * 4, enc_ns,
                         wall_ns=_clock.now_ns() - enc0)
        if tel is not None:
            tel.record("wire.push", "wire", t0, tel.now(), key=key,
                       wire=frame.wire, nbytes=frame.nbytes,
                       numel=frame.numel, encode_ns=enc_ns,
                       prev_version=frame.prev_version,
                       version=frame.version, origin=self.origin_id)
        if auto:
            # adaptive feedback (policy-chosen pushes only): what the
            # quantisation dropped vs what it carried.  Carried mass is
            # derived from the wire tuple itself (per-row mean|q|·scale),
            # not a second full f32 decode of the frame.
            q, sc = frame.codes()
            qf = np.abs(q.astype(np.float32))
            carried = float((qf.mean(axis=1) * sc[:, 0]).mean()) if q.size \
                else 0.0
            self.wire_policy(key).observe(
                delta_absmax=(float(sc.max()) * _WIRE_QMAX[frame.wire]
                              if sc is not None and sc.size else 0.0),
                density=float(np.count_nonzero(qf)) / max(q.size, 1),
                residual_ratio=_mean_abs(residual) / (carried + 1e-12),
                wire=frame.wire)
        return moved

    def _after_push(self, key: str, r: Replica, frame: WireFrame) -> None:
        """Post-apply bookkeeping: advance the replica's global base version
        when the push extended exactly the version it last synced at (any
        other transition means peer pushes landed that this replica hasn't
        seen — its version stays put and the next pull delta-refreshes),
        then fan the stamped frame out to subscribed peers."""
        r.lock.acquire_write()
        try:
            if r.global_version == frame.prev_version:
                r.global_version = frame.version
        finally:
            r.lock.release_write()
        self.global_tier.broadcast(key, frame, exclude=self.origin_id)

    def mark_dirty(self, key: str, offset: int, length: int) -> None:
        r = self._replicas[key]
        cs = self.global_tier.chunk_size
        for idx in range(offset // cs, (offset + max(length, 1) - 1) // cs + 1):
            r.dirty_chunks.add(idx)
        r.version += 1
