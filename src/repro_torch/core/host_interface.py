"""The Faaslet host interface — the full Table-2 API surface.

One ``FaasmAPI`` instance is bound per (Faaslet, call).  It is the *only* way
a function interacts with the outside world, and the single place where the
isolation invariants are enforced:

  * state access goes through shared regions (zero-copy, ``faaslet`` mode) or
    private copies (``container`` data-shipping baseline);
  * every byte moved to/from the global tier is charged against the Faaslet's
    network budget (traffic-shaping analogue) and the host's transfer metrics;
  * the filesystem is read-global / write-local with unforgeable handles
    (WASI capability style);
  * gettime is a per-call monotonic clock, getrandom draws host entropy.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.faaslet import Faaslet, FaasletMemoryFault


class StateKeyError(KeyError):
    pass


class CallCancelled(RuntimeError):
    """The call's speculative counterpart already settled: this execution is
    cooperatively cancelled at the next host-interface checkpoint (chain,
    await, state pull/push) so its executor slot frees instead of running a
    discarded computation to completion."""


class DeadlineExceeded(CallCancelled):
    """The call's end-to-end deadline expired mid-execution: same
    cooperative unwind as a cancel (next host-interface or kernel
    checkpoint), but the runtime settles the call with
    ``overload.DEADLINE_RC`` so waiters can tell a deadline from a
    speculative loss.  The attempt fence keeps any state effects the
    interrupted attempt already pushed exactly-once."""


class FaasmAPI:
    def __init__(self, faaslet: Faaslet, host, runtime, call):
        self.faaslet = faaslet
        self.host = host
        self.runtime = runtime
        self.call = call
        self._t0 = time.monotonic_ns()
        self._fds: Dict[int, dict] = {}
        self._fd_counter = itertools.count(3)
        self._dl_handles: Dict[int, str] = {}
        self._dl_counter = itertools.count(1)
        self._local_locked = {}
        # attempt fencing: per-key 1-based sequence of this attempt's delta
        # pushes.  A FaasmAPI is built fresh per physical execution, so a
        # re-executed attempt restarts its sequence — identical pushes from
        # identical (deterministic) re-runs carry identical (id, seq) pairs
        # and the global tier admits each effect exactly once.
        self._push_seq: Dict[str, int] = {}
        self._dirtied: set = set()
        # Snapshot the epoch at attempt start: a zombie attempt (host declared
        # dead by the heartbeat monitor while it was merely slow) must keep
        # pushing under its *own*, by-then superseded epoch — reading the
        # shared Call object live would let it impersonate the re-execution.
        self._fence_epoch = getattr(call, "fence_epoch", 0)

    def _fence(self, key: str) -> Optional[tuple]:
        """Fence token ``(call_id, epoch, seq)`` for the next delta push of
        ``key``, or ``None`` for unfenced contexts (init code)."""
        epoch = self._fence_epoch
        if not epoch:
            return None
        seq = self._push_seq.get(key, 0) + 1
        self._push_seq[key] = seq
        return (self.call.fence_id, epoch, seq)

    def dirtied_keys(self):
        """State keys this call wrote locally (host-side cleanup of
        un-pushed deltas when the call fails)."""
        return tuple(self._dirtied)

    # ------------------------------------------------------------------ calls --

    def check_cancelled(self) -> None:
        """Cooperative cancellation point: raise if this call was cancelled
        (its speculative twin already settled) or its end-to-end deadline
        expired.  Called automatically at chain/await and state pull/push
        boundaries, and from kernel dispatch via ``cancellation.checkpoint``.
        Deadline-less calls pay one pointer compare for the deadline arm."""
        ev = getattr(self.call, "cancel_event", None)
        if ev is not None and ev.is_set():
            raise CallCancelled(
                f"call {self.call.id} cancelled (speculative twin settled)")
        dl = getattr(self.call, "deadline", None)
        if dl is not None and dl.expired():
            raise DeadlineExceeded(
                f"call {self.call.id} exceeded its deadline "
                f"({dl.budget_s * 1e3:.1f} ms budget)")

    def read_call_input(self) -> bytes:
        return self.call.input

    def write_call_output(self, out_data: bytes) -> None:
        self.call.output = bytes(out_data)

    def chain_call(self, name: str, args: bytes = b"",
                   deadline=None) -> int:
        """Chain a child call.  ``deadline`` (a float budget in seconds or a
        ``repro_torch.overload.Deadline``) stamps a tighter expiry; omitted, the
        child inherits this call's remaining deadline budget."""
        self.check_cancelled()
        self.faaslet.usage.charge_net(n_out=len(args))
        return self.runtime.invoke(name, bytes(args), parent=self.call,
                                   deadline=deadline)

    def chain_call_many(self, name: str, args_list,
                        state_hint: Optional[List[str]] = None,
                        deadline=None) -> List[int]:
        """Batch chain: one submission for the whole fan-out (ordered IDs).

        ``state_hint`` names the state keys the batch touches so placement
        can prefer hosts already holding warm replicas of them.
        ``deadline`` is as in :meth:`chain_call`: explicit budget, else the
        children inherit the parent call's remaining deadline."""
        self.check_cancelled()
        args_list = [bytes(a) for a in args_list]
        for a in args_list:
            self.faaslet.usage.charge_net(n_out=len(a))
        return self.runtime.invoke_many(name, args_list, parent=self.call,
                                        state_hint=state_hint,
                                        deadline=deadline)

    def await_call(self, call_id: int, timeout: Optional[float] = None) -> int:
        self.check_cancelled()
        return self.runtime.wait(call_id, timeout=timeout)

    def await_all(self, call_ids,
                  timeout: Optional[float] = None) -> List[int]:
        """Block on one shared latch until every chained call finishes."""
        self.check_cancelled()
        return self.runtime.wait_all(call_ids, timeout=timeout)

    def get_call_output(self, call_id: int) -> bytes:
        out = self.runtime.output(call_id)
        self.faaslet.usage.charge_net(n_in=len(out))
        return out

    # ------------------------------------------------------------------ state --

    def _local(self):
        return self.host.local_tier_for(self.faaslet)

    def get_state(self, key: str, *, writable: bool = True) -> np.ndarray:
        """Pointer (numpy view) to the state value — maps a shared region.

        ``faaslet`` isolation: the view aliases the host-shared replica buffer
        (zero-copy).  ``container`` isolation: a private copy (data shipping).
        """
        lt = self._local()
        if not lt.has(key) and not self.runtime.global_tier.exists(key):
            raise StateKeyError(key)
        lt.pull(key)
        replica = lt.replica(key)
        if self.host.isolation == "container":
            self.faaslet.usage.charge_net(n_in=replica.buf.size)
            return replica.buf.copy()
        region = self.faaslet.region_for(key)
        if region is None or region.backing is not replica.buf:
            region = self.faaslet.map_shared_region(key, replica.buf,
                                                    writable=writable)
        if writable:
            # A writable mapping may mutate the shared replica behind the
            # api (e.g. VectorAsync's HOGWILD add): track the key so a
            # failed call's un-pushed deltas are discarded, not leaked into
            # later calls on this host (``discard_unpushed`` no-ops when
            # the replica has no dirty chunks).
            self._dirtied.add(key)
        return self.faaslet.read(region.base, region.size)

    def get_state_offset(self, key: str, offset: int, length: int,
                         *, writable: bool = True) -> np.ndarray:
        lt = self._local()
        lt.pull_range(key, offset, length)
        replica = lt.replica(key)
        if self.host.isolation == "container":
            self.faaslet.usage.charge_net(n_in=length)
            return replica.buf[offset:offset + length].copy()
        region = self.faaslet.region_for(key)
        if region is None or region.backing is not replica.buf:
            region = self.faaslet.map_shared_region(key, replica.buf,
                                                    writable=writable)
        return self.faaslet.read(region.base + offset, length)

    def set_state(self, key: str, value: bytes) -> None:
        value = bytes(value)
        lt = self._local()
        r = lt.replica(key, size=len(value))
        r.lock.acquire_write()
        try:
            with r.buf_lock:
                r.buf[:len(value)] = np.frombuffer(value, np.uint8)
            r.full = True
            r.present_chunks = set(range(self.runtime.global_tier.n_chunks(key)
                                         if self.runtime.global_tier.exists(key)
                                         else 1))
        finally:
            r.lock.release_write()
        lt.mark_dirty(key, 0, len(value))
        self._dirtied.add(key)

    def set_state_offset(self, key: str, value: bytes, offset: int) -> None:
        value = bytes(value)
        lt = self._local()
        r = lt.replica(key, size=offset + len(value))
        r.lock.acquire_write()
        try:
            with r.buf_lock:
                r.buf[offset:offset + len(value)] = np.frombuffer(value,
                                                                  np.uint8)
        finally:
            r.lock.release_write()
        lt.mark_dirty(key, offset, len(value))
        self._dirtied.add(key)

    def push_state(self, key: str) -> None:
        self.check_cancelled()
        n = self._local().push(key)
        self.faaslet.usage.charge_net(n_out=n)
        self._dirtied.discard(key)

    def push_state_partial(self, key: str) -> None:
        """Push only dirty chunks (what VectorAsync.push() uses)."""
        self.check_cancelled()
        n = self._local().push_dirty(key)
        self.faaslet.usage.charge_net(n_out=n)
        self._dirtied.discard(key)

    def push_state_delta(self, key: str, dtype=np.float32,
                         wire: str = "auto") -> None:
        """Accumulating push: global += local − base (cross-host HOGWILD).

        ``wire="auto"`` (default) lets the key's adaptive ``WirePolicy``
        pick the codec from observed delta magnitude/density and residual
        norm; ``"int8"`` forces the fused ``kernels/state_push`` quantised
        frame (int8 payload + per-row scales, ~¼ of the f32 bytes, with
        per-replica error feedback) and ``"exact"`` the f32 delta frame.
        The network budget is charged the wire bytes actually moved, not
        the value bytes."""
        self.check_cancelled()
        n = self._local().push_delta(key, dtype=dtype, wire=wire,
                                     fence=self._fence(key))
        self.faaslet.usage.charge_net(n_out=n)
        self._dirtied.discard(key)               # pushed (or fenced off)

    # -- device residency (DeviceReplica plane; transfers are intra-host) -----

    def state_to_device(self, key: str, dtype=np.float32,
                        track_delta: bool = False):
        """Materialise the replica as a torch tensor on the runtime's device
        (H2D, no global-tier traffic).  With ``track_delta``, arms a
        device-native ``push_delta`` by snapshotting the device base at this
        sync point.  Write results back with :meth:`state_update_device`
        (a new tensor), not in place."""
        self.check_cancelled()
        return self._local().to_device(key, dtype=dtype,
                                       track_delta=track_delta)

    def state_update_device(self, key: str, value) -> None:
        """Install a device-computed tensor as the replica's device copy."""
        self.check_cancelled()
        self._local().update_device(key, value)
        self._dirtied.add(key)

    def state_from_device(self, key: str) -> int:
        """Sync the device value back into the shared host replica (D2H)."""
        self.check_cancelled()
        n = self._local().from_device(key)
        self._dirtied.add(key)
        return n

    def pull_state(self, key: str, track_delta: bool = False,
                   wire: Optional[str] = None) -> None:
        """Replicate (or refresh) the value locally.  A warm replica
        refreshes through the wire fabric: only the retained delta ships
        (``wire="int8"`` ≈ ¼ of the f32 re-pull bytes; ``None``/"auto" lets
        the key's ``WirePolicy`` decide), with a full-pull fallback when
        the replica's base predates the retained window."""
        self.check_cancelled()
        moved = self._local().pull(key, wire=wire)
        if track_delta:
            # arm-only: the replica (and its base) is shared with co-located
            # faaslets — force-stamping here would absorb their pending
            # HOGWILD writes into the base and lose them (see snapshot_base)
            self._local().snapshot_base(key, force=False)
        self.faaslet.usage.charge_net(n_in=moved)

    def subscribe_state(self, key: str) -> None:
        """Subscribe the host's replica to the key's push fan-out: peer
        wire frames are applied in place as they land, so the warm replica
        converges without this function (or any later call on this host)
        paying a re-pull.  The initial sync pull is charged to the network
        budget like any other pull."""
        self.check_cancelled()
        moved = self._local().subscribe(key)
        self.faaslet.usage.charge_net(n_in=moved)

    def unsubscribe_state(self, key: Optional[str] = None) -> None:
        self._local().unsubscribe(key)

    def pull_state_chunk(self, key: str, chunk_idx: int) -> None:
        self.check_cancelled()
        moved = self._local().pull_chunk(key, chunk_idx)
        self.faaslet.usage.charge_net(n_in=moved)

    def append_state(self, key: str, value: bytes) -> None:
        self.runtime.global_tier.append(key, bytes(value), host=self.host.id)
        self.faaslet.usage.charge_net(n_out=len(value))

    # -- locks ----------------------------------------------------------------

    def lock_state_read(self, key: str):
        self._local().replica(key, size=max(1, self.runtime.global_tier.size(key)
                                            if self.runtime.global_tier.exists(key)
                                            else 1)).lock.acquire_read()

    def unlock_state_read(self, key: str):
        self._local()._replicas[key].lock.release_read()

    def lock_state_write(self, key: str):
        self._local().replica(key, size=max(1, self.runtime.global_tier.size(key)
                                            if self.runtime.global_tier.exists(key)
                                            else 1)).lock.acquire_write()

    def unlock_state_write(self, key: str):
        self._local()._replicas[key].lock.release_write()

    def lock_state_global_read(self, key: str):
        self.runtime.global_tier.lock(key).acquire_read()

    def unlock_state_global_read(self, key: str):
        self.runtime.global_tier.lock(key).release_read()

    def lock_state_global_write(self, key: str):
        self.runtime.global_tier.lock(key).acquire_write()

    def unlock_state_global_write(self, key: str):
        self.runtime.global_tier.lock(key).release_write()

    # ------------------------------------------------------------------ dynlink --

    def dlopen(self, name: str) -> int:
        if not self.runtime.has_module(name):
            raise FileNotFoundError(f"no module {name!r} uploaded")
        h = next(self._dl_counter)
        self._dl_handles[h] = name
        return h

    def dlsym(self, handle: int, symbol: str) -> Callable:
        name = self._dl_handles[handle]
        return self.runtime.module_symbol(name, symbol)

    def dlclose(self, handle: int) -> int:
        self._dl_handles.pop(handle, None)
        return 0

    # ------------------------------------------------------------------ memory --

    def mmap(self, length: int) -> int:
        return self.faaslet.mmap(length)

    def brk(self, new_brk: int) -> int:
        return self.faaslet.brk(new_brk)

    def sbrk(self, delta: int) -> int:
        return self.faaslet.sbrk(delta)

    # ------------------------------------------------------------------ network --

    def socket(self) -> int:
        fd = next(self._fd_counter)
        self._fds[fd] = {"kind": "socket", "peer": None, "rx": []}
        return fd

    def connect(self, fd: int, address: str) -> int:
        sock = self._fds.get(fd)
        if sock is None or sock["kind"] != "socket":
            raise OSError("bad socket fd")
        if address.startswith("unix:"):
            raise OSError("AF_UNIX not permitted")          # §3.2 networking
        sock["peer"] = address
        return 0

    def send(self, fd: int, data: bytes) -> int:
        sock = self._fds[fd]
        if sock["peer"] is None:
            raise OSError("not connected")
        self.faaslet.usage.charge_net(n_out=len(data))      # traffic shaping
        self.runtime.deliver_network(self.host.id, sock["peer"], bytes(data))
        return len(data)

    def recv(self, fd: int, max_len: int) -> bytes:
        sock = self._fds[fd]
        data = self.runtime.receive_network(self.host.id, sock["peer"], max_len)
        self.faaslet.usage.charge_net(n_in=len(data))
        return data

    # ------------------------------------------------------------------ file I/O --

    def open(self, path: str, mode: str = "r") -> int:
        vfs = self.runtime.vfs
        if "w" not in mode and not vfs.exists(self.host.id, path):
            raise FileNotFoundError(path)
        fd = next(self._fd_counter)
        self._fds[fd] = {"kind": "file", "path": path, "pos": 0, "mode": mode}
        return fd

    def read(self, fd: int, length: int) -> bytes:
        f = self._fds[fd]
        data = self.runtime.vfs.read(self.host.id, f["path"])
        out = data[f["pos"]:f["pos"] + length]
        f["pos"] += len(out)
        return out

    def write(self, fd: int, data: bytes) -> int:
        f = self._fds[fd]
        if "w" not in f["mode"] and "a" not in f["mode"]:
            raise PermissionError("fd not writable")
        self.runtime.vfs.write_local(self.host.id, f["path"], bytes(data),
                                     append=("a" in f["mode"] or f["pos"] > 0))
        f["pos"] += len(data)
        return len(data)

    def stat(self, path: str) -> dict:
        vfs = self.runtime.vfs
        if not vfs.exists(self.host.id, path):
            raise FileNotFoundError(path)
        return {"size": len(vfs.read(self.host.id, path))}

    def dup(self, fd: int) -> int:
        new = next(self._fd_counter)
        self._fds[new] = dict(self._fds[fd])
        return new

    def close(self, fd: int) -> int:
        self._fds.pop(fd, None)
        return 0

    # ------------------------------------------------------------------ misc --

    def gettime(self) -> int:
        """Per-call monotonic clock (ns since call start)."""
        return time.monotonic_ns() - self._t0

    def getrandom(self, n: int) -> bytes:
        return os.urandom(n)
