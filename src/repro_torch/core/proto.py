"""Proto-Faaslets: ahead-of-time snapshots restored in ~µs (Faasm §5.2).

Two cold-start costs exist on a TPU serving/training host, both attacked here:

  1. **Execution state** — the function's initialised linear memory plus any
     host objects its init code built (e.g. weights already laid out).  A
     ``ProtoFaaslet`` captures these once; ``restore()`` stamps out a fresh
     Faaslet from the snapshot.  Snapshots are plain bytes: OS-independent and
     restorable on any host in the cluster (cross-host restore).
  2. **XLA compilation** — seconds-to-minutes per (function, arch, shape,
     mesh).  The ``ExecutableCache`` is the Proto-Faaslet of the compiled
     artifact: the first lowering pays the compile; every Faaslet spawned
     afterwards binds the cached executable.

After every call the runtime *resets* the Faaslet from its Proto-Faaslet
(§5.2 multi-tenant reset): no information from the previous call survives in
private memory.

Restore cost is O(1), not O(arena): the snapshot is decoded once per process
into a shared read-only :class:`~repro_torch.core.faaslet.ArenaBase` that every
restore maps copy-on-write (``Faaslet.bind_base``), and the pickled
init-code products are decoded once into a cached template instead of paying
``pickle.loads`` per restore.  The template is shared read-only across all
restores on the process — the same discipline as the shared state tier
(§3.3); functions must not mutate it.  The pre-CoW full-copy path survives
as :meth:`ProtoFaaslet.restore_copy` (the benchmark baseline).
"""
from __future__ import annotations

import pickle
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.faaslet import ArenaBase, Faaslet
from repro_torch.telemetry import clock as tclock

_cache_lock = threading.Lock()
_PICKLE_FIELDS = ("func_name", "arena", "brk", "memory_limit", "user_state")


@dataclass(frozen=True)
class ProtoFaaslet:
    func_name: str
    arena: bytes
    brk: int
    memory_limit: int
    user_state: bytes = b""               # pickled init-code products

    @staticmethod
    def capture(faaslet: Faaslet, user_state: Any = None) -> "ProtoFaaslet":
        return ProtoFaaslet(
            func_name=faaslet.func_name,
            arena=faaslet.snapshot_arena(),
            brk=faaslet.brk_value,
            memory_limit=faaslet.memory_limit,
            user_state=pickle.dumps(user_state) if user_state is not None else b"",
        )

    # -- per-process decoded caches (built once, shared by every restore) ------

    def arena_base(self) -> ArenaBase:
        """The shared read-only CoW base for this snapshot (decoded once)."""
        base = self.__dict__.get("_arena_base")
        if base is None:
            with _cache_lock:
                base = self.__dict__.get("_arena_base")
                if base is None:
                    base = ArenaBase(self.arena, self.memory_limit)
                    object.__setattr__(self, "_arena_base", base)
        return base

    def user_state_template(self) -> Any:
        """Init-code products decoded once (no per-restore ``pickle.loads``).

        Shared read-only across every Faaslet restored from this proto."""
        if not self.user_state:
            return None
        if "_user_state_tpl" not in self.__dict__:
            with _cache_lock:
                if "_user_state_tpl" not in self.__dict__:
                    object.__setattr__(self, "_user_state_tpl",
                                       pickle.loads(self.user_state))
        return self.__dict__["_user_state_tpl"]

    # -- restore ---------------------------------------------------------------

    def restore(self, host_id: str) -> Tuple[Faaslet, Any]:
        """Stamp out a fresh Faaslet from this snapshot (any host).

        O(1) in arena size: binds the shared CoW base instead of copying."""
        f = Faaslet(self.func_name, host_id, memory_limit=self.memory_limit,
                    initial_pages=0)
        f.bind_base(self.arena_base(), self.brk)
        f.restored_from_proto = True
        return f, self.user_state_template()

    def restore_copy(self, host_id: str) -> Tuple[Faaslet, Any]:
        """Full-copy restore: the pre-CoW path (O(arena) memcpy + fresh
        ``pickle.loads``), kept as the benchmark comparison baseline."""
        f = Faaslet(self.func_name, host_id, memory_limit=self.memory_limit)
        f.restore_arena(self.arena, self.brk)
        f.restored_from_proto = True
        state = pickle.loads(self.user_state) if self.user_state else None
        return f, state

    # -- cross-host / global-tier transport -----------------------------------

    def __getstate__(self):
        # decoded caches (memfd-backed ArenaBase, live template objects) must
        # not travel with the snapshot bytes
        return {k: getattr(self, k) for k in _PICKLE_FIELDS}

    def __setstate__(self, state):
        for k in _PICKLE_FIELDS:
            object.__setattr__(self, k, state[k])

    def serialize(self) -> bytes:
        return pickle.dumps(self)

    @staticmethod
    def deserialize(data: bytes) -> "ProtoFaaslet":
        obj = pickle.loads(data)
        if not isinstance(obj, ProtoFaaslet):
            raise TypeError("not a ProtoFaaslet snapshot")
        return obj

    def size_bytes(self) -> int:
        return len(self.arena) + len(self.user_state)


class ExecutableCache:
    """Compiled-executable snapshots keyed by (fn, arch, shape, mesh) fingerprint."""

    def __init__(self):
        self._cache: Dict[Tuple, Any] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.compile_seconds = 0.0

    def get_or_build(self, key: Tuple, build: Callable[[], Any]):
        """Returns (executable, was_hit, seconds_spent)."""
        with self._lock:
            if key in self._cache:
                self.hits += 1
                return self._cache[key], True, 0.0
        t0 = tclock.now()
        built = build()
        dt = tclock.now() - t0
        with self._lock:
            self._cache.setdefault(key, built)
            self.misses += 1
            self.compile_seconds += dt
        return built, False, dt

    def contains(self, key: Tuple) -> bool:
        with self._lock:
            return key in self._cache

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._cache),
                    "compile_seconds": self.compile_seconds}
