"""Global state tier: a chunked, thread-safe distributed key-value store.

The authoritative copy of every state value (Faasm §4.2).  Values are byte
arrays (the paper's language-agnostic representation); large values are split
into fixed-size **state chunks** that can be pulled/pushed independently, so a
Faaslet replicates only the subsets it touches (Fig. 4, value C).

Concurrency: the store is **lock-striped** — keys hash onto a fixed array of
stripes, each stripe owning its own mutex, sub-map and transfer counters, so
chunk transfers (``get_range``/``set_range``, the primitives behind
``LocalTier.pull_chunk``/``push_dirty``) on *different* keys never contend.
Per-key metadata (the global read/write lock implementing
``lock_state_global_read/write``, plus a write version) lives next to the
value in its stripe.

Data plane: values are **mutable numpy buffers**, and the zero-copy range
primitives ``readinto``/``write_from`` memcpy directly between global
storage and replica buffers under the stripe lock — no intermediate
``bytes`` materialisation.  ``add_inplace`` applies a HOGWILD delta
(``global += local − base``) arithmetically in the global buffer without
copying the value at all.

Wire fabric (``repro_torch.state.wire``): every delta that crosses the tier
boundary is a :class:`~repro_torch.state.wire.WireFrame`.  ``apply_wire`` lands a
push frame in the global buffer (int8 frames account only their **wire**
bytes, ≈ value/4 for f32) and records it in the key's **retained delta
window**; ``pull_wire`` serves a warm replica the composition of the
retained frames newer than its base version (re-encoded on the requested
wire by the fused ``kernels/state_push`` codec on the tier's device),
falling back to a full
pull when the base predates the window floor; ``broadcast`` fans an applied
frame out to subscribed local tiers so peer replicas converge without a
re-pull.  Any non-delta mutation (``set``/``set_range``/``write_from``/
``append``/``rewrite``) invalidates the window: the floor jumps to the new
version and older bases full-pull.

The tier counts every byte it actually memcpys
(``bytes_copied``/``total_copied``) next to the per-host transfer counters —
the experiments' "network transfer" metric (Fig. 6b) reads the latter, the
copy-accounting benchmark reads the former.
"""
from __future__ import annotations

import threading
import time
import zlib
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import overload as oload
from repro_torch.kernels.common import resolve_device
from repro_torch.analysis.annotations import holds_stripe
from repro_torch.analysis.sanitizer import make_mutex, wrap_rwlock
from repro_torch.state import wire as _wire_mod
from repro_torch.state.wire import WireFrame, frame_from_quantized, get_codec
from repro_torch.telemetry import clock as _clock

# repro_torch.analysis.sanitizer installs its hook state here (enable()); None
# compiles every check in this module down to one pointer compare
_SAN = None
# repro_torch.telemetry installs its tracer here (enable()); same discipline —
# disarmed is one pointer compare per wire event, zero ring writes
_TEL = None

DEFAULT_CHUNK = 1 << 20          # 1 MiB state chunks
DEFAULT_STRIPES = 64
DEFAULT_DELTA_WINDOW = 8         # retained wire frames per key (delta pulls)
DEFAULT_DELTA_WINDOW_BYTES = 32 << 20   # per-key byte cap on retained frames
FENCE_CAP = 4096                 # retained sealed fence records (see _Fence)


class RWLock:
    """Writer-preferring readers/writer lock."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()


@dataclass
class KeyMeta:
    """Per-key metadata co-located with the value in its stripe."""

    version: int = 0                 # stripe-monotonic; stamped on every write
    floor: int = 0                   # oldest base version the window serves
    frames: deque = field(default_factory=deque)   # retained WireFrames
    frames_bytes: int = 0
    pullers: set = field(default_factory=set)      # tiers holding warm replicas


class _Value:
    """A mutable value buffer: numpy storage with amortised append growth."""

    __slots__ = ("buf", "length")

    def __init__(self, length: int = 0, capacity: int = 0):
        self.buf = np.zeros(max(length, capacity), np.uint8)
        self.length = length

    def ensure(self, end: int) -> None:
        """Grow logical length to ``end`` (capacity doubles, gap zero-filled)."""
        if end > self.buf.size:
            grown = np.zeros(max(end, 2 * self.buf.size), np.uint8)
            grown[:self.length] = self.buf[:self.length]
            self.buf = grown
        if end > self.length:
            self.buf[self.length:end] = 0       # stale capacity must read as 0
            self.length = end


class _Stripe:
    """One lock stripe: a mutex guarding a sub-map of keys + its counters."""

    __slots__ = ("lock", "store", "meta", "locks", "subs", "vc", "pulled",
                 "pushed", "copied", "bcast")

    def __init__(self):
        self.lock = make_mutex("stripe")
        self.store: Dict[str, _Value] = {}
        self.meta: Dict[str, KeyMeta] = {}
        # RW locks live outside the meta map: a delete must not orphan a lock
        # some thread is holding, and version numbers draw from a monotonic
        # per-stripe counter so delete+recreate never aliases a cached version
        self.locks: Dict[str, RWLock] = {}
        self.subs: Dict[str, Dict[str, Callable]] = {}   # key -> host -> cb
        self.vc = 0
        self.pulled: Dict[str, int] = {}     # per-host transfer bytes
        self.pushed: Dict[str, int] = {}
        self.copied = 0                      # bytes actually memcpy'd by the tier
        self.bcast = 0                       # wire bytes fanned out to peers

    @holds_stripe
    def bump(self, key: str) -> None:
        self.vc += 1
        m = self.meta.setdefault(key, KeyMeta())
        if _SAN is not None:
            _SAN.version_bumped(self, key, m.version, self.vc)
        m.version = self.vc

    @holds_stripe
    def record(self, key: str, frame: WireFrame, window: int,
               window_bytes: int) -> None:
        """Retain an applied frame for delta pulls (stripe lock held).
        Trimming the oldest frame raises the window floor to its version:
        pulls from bases at or past the floor stay serviceable."""
        m = self.meta[key]
        if _SAN is not None:
            _SAN.frame_recorded(self, key, frame,
                                m.frames[-1].version if m.frames else None,
                                m.floor)
        m.frames.append(frame)
        m.frames_bytes += frame.nbytes
        while m.frames and (len(m.frames) > window
                            or m.frames_bytes > window_bytes):
            old = m.frames.popleft()
            m.frames_bytes -= old.nbytes
            m.floor = old.version

    @holds_stripe
    def invalidate(self, key: str) -> None:
        """A non-delta mutation: the retained window can no longer express
        the path from any older base — drop it and jump the floor to the
        current version (stripe lock held)."""
        m = self.meta.get(key)
        if m is None:
            return
        m.frames.clear()
        m.frames_bytes = 0
        m.floor = m.version


def _as_u8(a: np.ndarray) -> np.ndarray:
    """Flat uint8 view of a contiguous array (no copy)."""
    return a.reshape(-1).view(np.uint8)


@dataclass
class _Fence:
    """Attempt-fence record for one logical call (see docs/fault_model.md).

    Delta pushes are additive, so a re-executed attempt (requeue after host
    death, straggler speculation) would double-apply its deltas.  Each
    physical attempt carries a fence token ``(call_id, epoch, seq)``; the
    tier admits a push iff the epoch is not superseded (``dead_epoch``),
    the call is not sealed to a different epoch (first settle wins), and
    the per-key effect sequence is fresh (``seq`` > high-water).  Assumes
    deterministic functions: attempt N's i-th push to a key carries the
    same delta as attempt M's, so dropping duplicates converges."""

    dead_epoch: int = 0              # epochs <= this are superseded (requeue)
    sealed: Optional[int] = None     # post-settle: only this epoch may write
    hw: Dict[str, int] = field(default_factory=dict)   # key -> applied seq


class _BcastChannel:
    """One subscriber host's broadcast delivery channel: a bounded
    coalescing frame queue drained by a dedicated pump thread, so a slow or
    stalled subscriber backpressures onto *its own* channel — never onto
    the pusher's thread (see ``GlobalTier.broadcast``)."""

    __slots__ = ("host", "q", "cv", "busy", "stop", "thread")

    def __init__(self, host_id: str, depth: int):
        self.host = host_id
        self.q = oload.CoalescingQueue(depth=depth)
        self.cv = threading.Condition()
        self.busy = False                # a drain batch is being delivered
        self.stop = False
        self.thread: Optional[threading.Thread] = None


class GlobalTier:
    """In-memory stand-in for the distributed KVS backing the global tier.

    On a real deployment this is Redis/Anna sharded across hosts; here one
    process hosts the authoritative map, with the same chunk/locking/byte
    semantics, so every state-protocol decision (what is pulled, when, how
    many bytes, how many copies) is real and measurable.

    ``device`` is where the wire codec runs (``"cuda"``, the default, raises
    without a card; ``"cpu"`` takes the numpy host codec).  The local tiers
    built on this tier inherit it.
    """

    def __init__(self, chunk_size: int = DEFAULT_CHUNK,
                 n_stripes: int = DEFAULT_STRIPES,
                 delta_window: int = DEFAULT_DELTA_WINDOW,
                 delta_window_bytes: int = DEFAULT_DELTA_WINDOW_BYTES,
                 device="cuda"):
        self.device = resolve_device(device)
        self.chunk_size = chunk_size
        self.n_stripes = max(1, n_stripes)
        self.delta_window = max(0, delta_window)
        self.delta_window_bytes = delta_window_bytes
        self._stripes = [_Stripe() for _ in range(self.n_stripes)]
        # attempt fences: logical-call write admission (innermost lock kind;
        # taken under a key write lock on the push path, never the reverse)
        self._fence_mu = make_mutex("fence")
        self._fences: Dict[str, _Fence] = {}
        self._fence_sealed: deque = deque()    # FIFO of sealed ids to prune
        self.fence_rejections = 0              # pushes refused by the fence
        # backpressured broadcast plane: one bounded channel + pump thread
        # per subscriber host, created lazily on first fan-out.  Guarded by
        # its own mutex (never nested inside a stripe lock).
        self._bcast_mu = make_mutex("bcast")
        self._bcast_channels: Dict[str, _BcastChannel] = {}
        self._bcast_closed = False
        self.bcast_depth = oload.DEFAULT_BCAST_DEPTH
        self.bcast_coalesced = 0               # frames collapsed to a newer one
        self.bcast_dropped = 0                 # subscribers dropped on overflow

    def _stripe(self, key: str) -> _Stripe:
        return self._stripes[zlib.crc32(key.encode()) % self.n_stripes]

    # -- attempt fences -----------------------------------------------------

    def fence_admit(self, key: str, fence: Tuple[str, int, int]) -> bool:
        """Admission check for a fenced delta push.

        ``fence`` is ``(call_id, epoch, seq)``: the logical call (a twin
        uses its primary's id), the physical attempt's epoch, and the
        attempt-local 1-based sequence of this push on this key.  Rejected
        pushes (superseded epoch, sealed to another epoch, or duplicate
        ``seq``) must perform no tier effect.  Competing pushes to the same
        key already serialise on the key's global write lock, so the check
        is atomic with the apply that follows it."""
        call_id, epoch, seq = fence
        with self._fence_mu:
            f = self._fences.get(call_id)
            if f is None:
                f = self._fences[call_id] = _Fence()
            admitted = not (epoch <= f.dead_epoch
                            or (f.sealed is not None and epoch != f.sealed)
                            or seq <= f.hw.get(key, 0))
            if admitted:
                f.hw[key] = seq
            else:
                self.fence_rejections += 1
        tel = _TEL
        if tel is not None and not admitted:
            tel.instant("fence.reject", "wire", key=key, fence=call_id,
                        epoch=epoch, seq=seq)
        if _SAN is not None:
            _SAN.fence_write(call_id, epoch, key, seq, admitted)
        return admitted

    def fence_supersede(self, call_id: str, epoch: int) -> None:
        """Every epoch of ``call_id`` up to and including ``epoch`` is dead:
        the runtime requeued or retried past it, so late writes from those
        attempts must be rejected (the host they ran on is gone)."""
        with self._fence_mu:
            f = self._fences.setdefault(call_id, _Fence())
            f.dead_epoch = max(f.dead_epoch, epoch)
        if _SAN is not None:
            _SAN.fence_superseded(call_id, epoch)

    def fence_is_dead(self, call_id: str, epoch: int) -> bool:
        """True when ``epoch`` of ``call_id`` has been superseded: the
        runtime requeued the call past it, so any push this attempt made
        after the supersede was rejected.  An attempt that finds its epoch
        dead must not settle the call — its \"success\" may name state
        effects that never landed."""
        with self._fence_mu:
            f = self._fences.get(call_id)
            return f is not None and epoch <= f.dead_epoch

    def fence_seal(self, call_id: str, epoch: int) -> None:
        """The call settled with ``epoch``'s result: no other attempt may
        write its state again (a racing speculation loser pushes into a
        sealed fence and is dropped).  Sealed records are pruned FIFO past
        ``FENCE_CAP`` — a straggler older than that is long cancelled."""
        with self._fence_mu:
            f = self._fences.setdefault(call_id, _Fence())
            if f.sealed is None:
                f.sealed = epoch
                self._fence_sealed.append(call_id)
                while len(self._fence_sealed) > FENCE_CAP:
                    self._fences.pop(self._fence_sealed.popleft(), None)

    # -- basic KV -----------------------------------------------------------

    def exists(self, key: str) -> bool:
        s = self._stripe(key)
        with s.lock:
            return key in s.store

    def keys(self) -> List[str]:
        out: List[str] = []
        for s in self._stripes:
            with s.lock:
                out.extend(s.store.keys())
        return out

    def size(self, key: str) -> int:
        s = self._stripe(key)
        with s.lock:
            v = s.store.get(key)
            return v.length if v is not None else 0

    def delete(self, key: str) -> None:
        s = self._stripe(key)
        with s.lock:
            s.store.pop(key, None)
            s.meta.pop(key, None)
            s.subs.pop(key, None)

    def get(self, key: str, *, host: str = "?") -> bytes:
        s = self._stripe(key)
        with s.lock:
            if _SAN is not None:
                _SAN.stripe_touch(s.lock, key)
            v = s.store[key]
            val = v.buf[:v.length].tobytes()
            s.pulled[host] = s.pulled.get(host, 0) + v.length
            s.copied += v.length
        return val

    def set(self, key: str, value: bytes, *, host: str = "?") -> None:
        s = self._stripe(key)
        n = len(value)
        with s.lock:
            if _SAN is not None:
                _SAN.stripe_touch(s.lock, key)
                _SAN.gen_bump(self, key)
            v = s.store.get(key)
            if v is None or v.buf.size < n:
                v = _Value(capacity=n)
                s.store[key] = v
            v.length = n
            if n:
                v.buf[:n] = np.frombuffer(value, np.uint8)
            s.bump(key)
            s.invalidate(key)
            s.pushed[host] = s.pushed.get(host, 0) + n
            s.copied += n

    def append(self, key: str, value: bytes, *, host: str = "?") -> None:
        """Append ``value`` to the key (amortised O(len(value)): capacity
        doubles, so delta-record logs don't rewrite the whole value)."""
        s = self._stripe(key)
        n = len(value)
        with s.lock:
            if _SAN is not None:
                _SAN.stripe_touch(s.lock, key)
                _SAN.gen_bump(self, key)
            v = s.store.setdefault(key, _Value())
            off = v.length
            v.ensure(off + n)
            if n:
                v.buf[off:off + n] = np.frombuffer(value, np.uint8)
            s.bump(key)
            s.invalidate(key)
            s.pushed[host] = s.pushed.get(host, 0) + n
            s.copied += n

    def rewrite(self, key: str, transform: Callable[[bytes], bytes], *,
                host: str = "?") -> Tuple[bytes, int]:
        """Atomically replace the value with ``transform(current)`` under the
        stripe lock (e.g. compacting a delta-record log).  ``transform`` must
        be pure — it runs with the stripe lock held.  Returns the new value
        and its write version (captured atomically, so callers can cache
        against exactly the state they produced)."""
        s = self._stripe(key)
        with s.lock:
            if _SAN is not None:
                _SAN.stripe_touch(s.lock, key)
                _SAN.gen_bump(self, key)
            v = s.store.get(key)
            cur = v.buf[:v.length].tobytes() if v is not None else b""
            new = transform(cur)
            n = len(new)
            if v is None or v.buf.size < n:
                v = _Value(capacity=n)
                s.store[key] = v
            v.length = n
            if n:
                v.buf[:n] = np.frombuffer(new, np.uint8)
            s.bump(key)
            s.invalidate(key)
            s.copied += len(cur) + n
            return new, s.meta[key].version

    # -- chunked access ------------------------------------------------------
    #
    # get_range / set_range are the bytes-typed transfer primitives; the
    # zero-copy data plane below (readinto / write_from / add_inplace) is
    # what LocalTier.pull/pull_chunk/push/push_dirty/push_delta use.

    def get_range(self, key: str, offset: int, length: int, *,
                  host: str = "?") -> bytes:
        s = self._stripe(key)
        with s.lock:
            if _SAN is not None:
                _SAN.stripe_touch(s.lock, key)
            v = s.store[key]
            if offset < 0 or offset + length > v.length:
                raise IndexError(
                    f"state range [{offset}, {offset + length}) out of bounds "
                    f"for {key!r} of size {v.length}")
            val = v.buf[offset:offset + length].tobytes()
            s.pulled[host] = s.pulled.get(host, 0) + length
            s.copied += length
        return val

    def set_range(self, key: str, offset: int, value: bytes, *,
                  host: str = "?") -> None:
        s = self._stripe(key)
        n = len(value)
        with s.lock:
            if _SAN is not None:
                _SAN.stripe_touch(s.lock, key)
                _SAN.gen_bump(self, key)
            if offset < 0:
                raise IndexError("negative state offset")
            v = s.store.setdefault(key, _Value())
            v.ensure(max(v.length, offset + n))
            if n:
                v.buf[offset:offset + n] = np.frombuffer(value, np.uint8)
            s.bump(key)
            s.invalidate(key)
            s.pushed[host] = s.pushed.get(host, 0) + n
            s.copied += n

    # -- zero-copy data plane (replica buffer <-> global buffer) --------------

    def readinto(self, key: str, offset: int, dest: np.ndarray, *,
                 host: str = "?", clamp: bool = False,
                 return_version: bool = False):
        """memcpy ``value[offset : offset+len(dest)]`` straight into ``dest``
        (a replica buffer view) under the stripe lock — one copy, no
        intermediate ``bytes``.  With ``clamp``, a read past the current
        value end copies what exists (a concurrent truncating push may have
        shrunk the value since the caller sized its buffer).  Returns bytes
        moved; with ``return_version``, ``(bytes, version)`` — the key's
        write version captured atomically with the content, the base a
        later delta pull refreshes from."""
        dest = _as_u8(dest)
        n = dest.size
        s = self._stripe(key)
        with s.lock:
            if _SAN is not None:
                _SAN.stripe_touch(s.lock, key)
                _tok = _SAN.read_begin(self, key)
            v = s.store[key]
            if offset < 0 or (not clamp and offset + n > v.length):
                raise IndexError(
                    f"state range [{offset}, {offset + n}) out of bounds "
                    f"for {key!r} of size {v.length}")
            n = min(n, max(v.length - offset, 0))
            if n:
                dest[:n] = v.buf[offset:offset + n]
            s.pulled[host] = s.pulled.get(host, 0) + n
            s.copied += n
            if _SAN is not None:
                _SAN.read_end(self, key, _tok)
            if return_version:
                m = s.meta.get(key)
                return n, (m.version if m is not None else 0)
        return n

    def write_from(self, key: str, offset: int, src: np.ndarray, *,
                   host: str = "?", truncate: bool = False) -> int:
        """memcpy ``src`` (a replica buffer view) straight into the global
        buffer at ``offset`` under the stripe lock — one copy.  With
        ``truncate`` the value's length becomes exactly ``offset + len(src)``
        (full-value push semantics).  Returns bytes moved."""
        src = _as_u8(src)
        n = src.size
        s = self._stripe(key)
        with s.lock:
            if _SAN is not None:
                _SAN.stripe_touch(s.lock, key)
                _SAN.gen_bump(self, key)
            if offset < 0:
                raise IndexError("negative state offset")
            v = s.store.setdefault(key, _Value())
            v.ensure(max(v.length, offset + n))
            if n:
                v.buf[offset:offset + n] = src
            if truncate:
                v.length = offset + n
            s.bump(key)
            s.invalidate(key)
            s.pushed[host] = s.pushed.get(host, 0) + n
            s.copied += n
        return n

    def add_inplace(self, key: str, local: np.ndarray,
                    base: Optional[np.ndarray] = None, *,
                    host: str = "?", return_version: bool = False,
                    rebase: bool = False,
                    fence: Optional[Tuple[str, int, int]] = None):
        """HOGWILD delta push computed in place in the global buffer:
        ``global += local`` then ``global -= base`` — no value-sized copy at
        all (``bytes_copied`` does not move).  ``local``/``base`` are typed
        replica views; the overlap with the stored value is updated.
        Returns delta bytes accounted as pushed; with ``return_version``,
        ``(bytes, prev_version, version)`` — the version transition
        captured atomically with the add, so the pusher can keep its
        replica's base version current (its buffer *is* the post-push
        content) instead of degrading every later warm pull to a full
        re-pull."""
        dtype = local.dtype
        itemsize = dtype.itemsize
        if fence is not None and not self.fence_admit(key, fence):
            return None                      # superseded/duplicate attempt
        s = self._stripe(key)
        with s.lock:
            if _SAN is not None:
                _SAN.stripe_touch(s.lock, key)
                _SAN.gen_bump(self, key)
            v = s.store[key]
            g = v.buf[:v.length - v.length % itemsize].view(dtype)
            n = min(g.size, local.size)
            if n:
                if rebase and base is not None:
                    # one coherent read of the live replica: the same delta
                    # lands in the global buffer AND in the pusher's base, so
                    # a concurrent HOGWILD add after the read stays pending
                    # for the next push instead of being silently absorbed
                    # into a re-read base (lost update)
                    delta = local[:n] - base[:n]
                    g[:n] += delta
                    base[:n] += delta
                else:
                    g[:n] += local[:n]
                    if base is not None:
                        g[:n] -= base[:n]
            m = s.meta.get(key)
            prev = m.version if m is not None else 0
            s.bump(key)
            # the delta was never materialised: older bases can't be served
            # through the window across this write
            s.invalidate(key)
            moved = n * itemsize
            s.pushed[host] = s.pushed.get(host, 0) + moved
            if return_version:
                return moved, prev, s.meta[key].version
        return moved

    def apply_wire(self, key: str, frame: WireFrame, *,
                   host: str = "?", origin: Optional[str] = None,
                   fence: Optional[Tuple[str, int, int]] = None):
        """Land a push-direction wire frame in the global buffer.

        The frame decodes to a flat f32 delta; the overlap with the stored
        value is accumulated in place.  Accounting counts the frame's
        **wire** bytes (int8: payload + scales ≈ value/4 for f32; exact:
        the f32 delta itself) — exact frames accumulate arithmetically and,
        like :meth:`add_inplace`, add nothing to the memcpy accounting.

        ``host`` is the transfer-metrics id; ``origin`` the pushing *tier*
        (container tiers share a metrics host but are distinct fabric
        parties — defaults to ``host``).

        The frame is stamped with the version transition it performed
        (``prev_version → version``) and — for f32 values, when some
        *other* party has declared interest (a registered warm puller or a
        subscriber) — retained in the key's delta window so warm replicas
        can refresh via :meth:`pull_wire`.  With no interested party the
        window is invalidated instead of fed: write-only keys retain
        nothing.  Callers serialise under the key's global write lock and
        fan the stamped frame out with :meth:`broadcast` *after* releasing
        it.  A fenced push from a superseded or duplicate attempt performs
        no effect and returns ``None`` (see :meth:`fence_admit`)."""
        dt = np.dtype(frame.dtype)
        if fence is not None and not self.fence_admit(key, fence):
            return None                      # superseded/duplicate attempt
        delta = frame.decode()                   # numpy; outside no locks yet
        wire = frame.nbytes
        s = self._stripe(key)
        with s.lock:
            if _SAN is not None:
                _SAN.stripe_touch(s.lock, key)
                _SAN.gen_bump(self, key)
            v = s.store[key]
            g = v.buf[:v.length - v.length % dt.itemsize].view(dt)
            n = min(g.size, frame.numel)
            if n:
                g[:n] += delta[:n].astype(dt, copy=False)
            m = s.meta.get(key)
            frame.prev_version = m.version if m is not None else 0
            s.bump(key)
            m = s.meta[key]
            frame.version = m.version
            frame.origin = origin if origin is not None else host
            if _SAN is not None:
                _SAN.frame_applied(self, key, frame)
            interested = (any(p != frame.origin for p in m.pullers)
                          or any(h != frame.origin
                                 for h in s.subs.get(key, ())))
            if dt == np.float32 and self.delta_window > 0 and interested:
                s.record(key, frame, self.delta_window,
                         self.delta_window_bytes)
            else:
                s.invalidate(key)
            s.pushed[host] = s.pushed.get(host, 0) + wire
            if frame.wire != "exact":
                s.copied += wire
        return wire

    def apply_quantized(self, key: str, q: np.ndarray, scales: np.ndarray,
                        numel: int, *, dtype=np.float32,
                        host: str = "?") -> int:
        """Apply an int8-quantised delta push (the ``kernels/state_push``
        wire tuple) — compatibility front over :meth:`apply_wire`."""
        frame = frame_from_quantized(q, scales, numel, dtype=dtype)
        return self.apply_wire(key, frame, host=host)

    def pull_wire(self, key: str, base_version: int, *, wire: str = "int8",
                  dtype=np.float32, residual: Optional[np.ndarray] = None,
                  exclude_origin: Optional[str] = None,
                  backend: Optional[str] = None, host: str = "?"):
        """Delta pull: encode ``value(now) − value(at base_version)`` from
        the key's retained window for a warm replica refresh.

        ``exclude_origin`` names the pulling host: frames it pushed itself
        are skipped from the composition — its buffer already contains
        those deltas (in un-quantised form), so replaying them would
        double-apply its own writes when its push raced a peer's.

        Returns ``None`` when the pull is not serviceable (non-f32 value,
        unknown base, base older than the window floor, or a gap) — the
        caller falls back to a full pull.  Otherwise returns
        ``(frame, version, residual)``: ``frame`` is ``None`` when the
        replica is already current (0 bytes moved); ``residual`` is the
        puller's updated error-feedback carry (quantisation debt of this
        encode, owned by the pulling replica and threaded back in on its
        next delta pull so repeated int8 refreshes converge)."""
        dt = np.dtype(dtype)
        if dt != np.float32 or base_version < 0:
            return None
        s = self._stripe(key)
        with s.lock:
            m = s.meta.get(key)
            if m is None:
                return None
            # a delta-pull attempt is interest: keep the window fed even if
            # this one was too stale to serve
            m.pullers.add(exclude_origin if exclude_origin is not None
                          else host)
            cur = m.version
            if base_version == cur:
                return None, cur, residual
            if base_version > cur or base_version < m.floor:
                return None
            parts = [f for f in m.frames if f.version > base_version]
            if not parts:
                return None
            served = [f for f in parts
                      if exclude_origin is None or f.origin != exclude_origin]
            if not served:
                # every newer frame is the puller's own push: it is current
                return None, cur, residual
        # decode/compose and encode OUTSIDE the stripe lock: frames are
        # immutable once stamped, and both the per-frame dequantise and the
        # int8 re-encode (a fused-kernel dispatch) are full-value work that
        # must not serialise unrelated keys in the stripe behind it
        tel = _TEL
        cost = _wire_mod._COST
        timed = tel is not None or cost is not None
        t0 = tel.now() if tel is not None else 0.0
        w0 = _clock.now_ns() if timed else 0
        numel = max(f.numel for f in served)
        delta = np.zeros(numel, np.float32)
        for f in served:
            d = f.decode()
            delta[:d.size] += d
        if residual is not None and residual.size == delta.size:
            delta = delta + residual
        enc0 = _clock.now_ns() if timed else 0
        frame = get_codec(wire).encode_delta(delta, backend=backend,
                                             device=self.device)
        enc_ns = _clock.now_ns() - enc0 if timed else 0
        new_residual = None
        if frame.wire != "exact":
            new_residual = delta - frame.decode()
            if _SAN is not None:
                _SAN.check_residual(delta, frame.decode(), new_residual)
        frame.prev_version, frame.version = base_version, cur
        with s.lock:
            s.pulled[host] = s.pulled.get(host, 0) + frame.nbytes
            s.copied += frame.nbytes
        if cost is not None:
            # pull-direction evidence: the re-encode is the same codec work
            # a push pays, so it feeds the same per-(wire, size) curve
            cost.observe(frame.wire, frame.numel * 4, enc_ns,
                         wall_ns=_clock.now_ns() - w0)
        if tel is not None:
            tel.record("wire.pull", "wire", t0, tel.now(), key=key,
                       wire=frame.wire, nbytes=frame.nbytes,
                       numel=frame.numel, encode_ns=enc_ns,
                       prev_version=base_version, version=cur,
                       frames=len(served), puller=host)
        return frame, cur, new_residual

    def register_puller(self, key: str, origin: str) -> None:
        """Declare ``origin`` (a tier id) as holding a warm full replica of
        ``key``: from now on applied f32 frames are retained in the delta
        window so its refreshes can ride the wire.  Sticky for the key's
        lifetime (cluster-bounded set); the first refresh after interest is
        declared may still full-pull once while the window warms."""
        s = self._stripe(key)
        with s.lock:
            s.meta.setdefault(key, KeyMeta()).pullers.add(origin)

    def deregister_puller(self, origin: str,
                          key: Optional[str] = None) -> None:
        """Revoke ``origin``'s warm-puller interest for ``key`` (all keys
        when ``None`` — replica eviction/host failure), so write-only keys
        stop materialising and retaining frames once every consumer left."""
        stripes = [self._stripe(key)] if key is not None else self._stripes
        for s in stripes:
            with s.lock:
                metas = ([s.meta[key]] if key is not None and key in s.meta
                         else ([] if key is not None else s.meta.values()))
                for m in metas:
                    m.pullers.discard(origin)

    def wire_interest(self, key: str, exclude: Optional[str] = None) -> bool:
        """True when some party other than ``exclude`` consumes this key's
        wire frames (a registered warm puller or a broadcast subscriber) —
        the signal `LocalTier.push_delta` uses to decide whether an exact
        f32 push is worth materialising as a frame at all."""
        s = self._stripe(key)
        with s.lock:
            m = s.meta.get(key)
            if m is not None and any(p != exclude for p in m.pullers):
                return True
            return any(h != exclude for h in s.subs.get(key, ()))

    # -- peer broadcast (subscribed replicas) ---------------------------------

    def subscribe(self, key: str, host_id: str,
                  callback: Callable[[str, WireFrame], None]) -> None:
        """Register ``callback(key, frame)`` to receive every wire frame
        applied to ``key`` (push fan-out).  One subscription per host id;
        re-subscribing replaces the callback."""
        s = self._stripe(key)
        with s.lock:
            s.subs.setdefault(key, {})[host_id] = callback

    def unsubscribe(self, host_id: str, key: Optional[str] = None) -> None:
        """Drop ``host_id``'s subscription for ``key`` (all keys when
        ``None`` — host eviction/failure)."""
        stripes = [self._stripe(key)] if key is not None else self._stripes
        for s in stripes:
            with s.lock:
                if key is not None:
                    subs = [s.subs[key]] if key in s.subs else []
                else:
                    subs = list(s.subs.values())
                for d in subs:
                    d.pop(host_id, None)

    def broadcast(self, key: str, frame: WireFrame, *,
                  exclude: Optional[str] = None) -> int:
        """Fan an applied (version-stamped) wire frame out to every
        subscriber of ``key`` except ``exclude`` (the pusher, whose replica
        already contains the delta).  Returns subscribers enqueued to.

        Delivery is **asynchronous and backpressured**: the pusher only
        enqueues onto each subscriber's bounded coalescing channel and
        returns — a stalled subscriber can never stall the pusher.  When a
        channel already holds a frame for this key it is collapsed to the
        newest (the skipped predecessor is a version gap the subscriber's
        ``prev_version`` check tolerates; the next delta pull repairs it).
        When the channel is full of *distinct* keys, the subscriber is
        dropped back to pull-repair entirely.  A callback that raises on
        the pump thread (subscriber churn — e.g. its host died) is culled
        the same way the old synchronous fan-out culled it.

        Must be called with **no tier locks held** (the enqueue takes the
        stripe lock and the channel lock in sequence, never nested under a
        caller's lock).  Use :meth:`flush_broadcasts` where a test or
        benchmark needs delivery to have happened."""
        s = self._stripe(key)
        with s.lock:
            targets = [(h, cb) for h, cb in s.subs.get(key, {}).items()
                       if h != exclude]
        enqueued = 0
        for h, cb in targets:
            ch = self._bcast_channel(h)
            if ch is None:                       # tier closed: drop quietly
                break
            outcome = ch.q.put(key, (frame, cb))
            if outcome == "overflow":
                # bounded backlog exceeded: this subscriber is too far
                # behind to follow the fan-out — drop it to pull-repair
                with self._bcast_mu:
                    self.bcast_dropped += 1
                with s.lock:
                    d = s.subs.get(key)
                    if d is not None and d.get(h) is cb:
                        d.pop(h, None)
                continue
            if outcome == "coalesced":
                with self._bcast_mu:
                    self.bcast_coalesced += 1
            enqueued += 1
            with ch.cv:
                ch.cv.notify()
        return enqueued

    def _bcast_channel(self, host_id: str) -> Optional[_BcastChannel]:
        with self._bcast_mu:
            if self._bcast_closed:
                return None
            ch = self._bcast_channels.get(host_id)
            if ch is None:
                ch = _BcastChannel(host_id, self.bcast_depth)
                ch.thread = threading.Thread(
                    target=self._bcast_pump, args=(ch,),
                    name=f"bcast-pump-{host_id}", daemon=True)
                self._bcast_channels[host_id] = ch
                ch.thread.start()
            return ch

    def _bcast_pump(self, ch: _BcastChannel) -> None:
        """Drain loop for one subscriber channel (its own daemon thread).
        Delivers outside all tier locks; accounts ``s.bcast`` under the
        stripe lock after each successful delivery."""
        while True:
            with ch.cv:
                while not ch.stop and len(ch.q) == 0:
                    ch.cv.wait()
                if ch.stop:
                    return
                ch.busy = True
            for key, (frame, cb) in ch.q.drain():
                try:
                    cb(key, frame)
                except Exception:
                    s = self._stripe(key)
                    with s.lock:
                        d = s.subs.get(key)
                        if d is not None and d.get(ch.host) is cb:
                            d.pop(ch.host, None)
                else:
                    s = self._stripe(key)
                    with s.lock:
                        s.bcast += frame.nbytes
            with ch.cv:
                ch.busy = False
                ch.cv.notify_all()               # wake flush waiters

    def flush_broadcasts(self, timeout: float = 5.0) -> bool:
        """Block until every enqueued broadcast frame has been delivered
        (or culled), or ``timeout`` elapses.  Returns True on quiescence.
        Delivery is asynchronous; call this wherever a test or benchmark
        asserts on subscriber state right after a push."""
        end = time.monotonic() + timeout
        with self._bcast_mu:
            channels = list(self._bcast_channels.values())
        for ch in channels:
            with ch.cv:
                while (len(ch.q) or ch.busy) and not ch.stop:
                    left = end - time.monotonic()
                    if left <= 0.0:
                        return False
                    ch.cv.wait(min(left, 0.05))
        return True

    def close(self) -> None:
        """Stop the broadcast pump threads (idempotent).  Frames still
        queued are dropped — subscribers repair through delta pulls."""
        with self._bcast_mu:
            self._bcast_closed = True
            channels = list(self._bcast_channels.values())
            self._bcast_channels.clear()
        for ch in channels:
            with ch.cv:
                ch.stop = True
                ch.cv.notify_all()
        for ch in channels:
            if ch.thread is not None:
                ch.thread.join(timeout=1.0)

    def n_chunks(self, key: str) -> int:
        sz = self.size(key)
        return max(1, -(-sz // self.chunk_size))

    def chunk_bounds(self, key: str, idx: int) -> Tuple[int, int]:
        sz = self.size(key)
        start = idx * self.chunk_size
        return start, min(self.chunk_size, sz - start)

    # -- global locks / metadata ----------------------------------------------

    def lock(self, key: str) -> RWLock:
        s = self._stripe(key)
        with s.lock:
            lk = s.locks.get(key)
            if lk is None:
                lk = s.locks[key] = wrap_rwlock(RWLock(), "key", key)
            return lk

    def version(self, key: str) -> int:
        """Write version of ``key`` (0 if never written)."""
        s = self._stripe(key)
        with s.lock:
            m = s.meta.get(key)
            return m.version if m is not None else 0

    # -- metrics --------------------------------------------------------------

    @property
    def bytes_pulled(self) -> Dict[str, int]:
        """Per-host pulled bytes, aggregated across stripes (read-only view)."""
        out: Dict[str, int] = defaultdict(int)
        for s in self._stripes:
            with s.lock:
                for h, n in s.pulled.items():
                    out[h] += n
        return out

    @property
    def bytes_pushed(self) -> Dict[str, int]:
        out: Dict[str, int] = defaultdict(int)
        for s in self._stripes:
            with s.lock:
                for h, n in s.pushed.items():
                    out[h] += n
        return out

    def total_transfer(self) -> int:
        total = 0
        for s in self._stripes:
            with s.lock:
                total += sum(s.pulled.values()) + sum(s.pushed.values())
        return total

    def total_copied(self) -> int:
        """Bytes the tier actually memcpy'd (copy accounting: in-place delta
        pushes and lock-free metadata reads move nothing here)."""
        total = 0
        for s in self._stripes:
            with s.lock:
                total += s.copied
        return total

    def total_broadcast(self) -> int:
        """Wire bytes fanned out to peer subscribers (push-side paid; peer
        replicas converge without adding to ``bytes_pulled``)."""
        total = 0
        for s in self._stripes:
            with s.lock:
                total += s.bcast
        return total

    def reset_metrics(self) -> None:
        for s in self._stripes:
            with s.lock:
                s.pulled.clear()
                s.pushed.clear()
                s.copied = 0
                s.bcast = 0
