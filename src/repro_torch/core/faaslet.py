"""Faaslet: the paper's isolation abstraction, adapted to this runtime.

A Faaslet owns
  * a **private linear memory** (the WebAssembly-style byte arena): a single
    contiguous address space starting at 0, grown via brk/mmap, with every
    access bounds-checked — the software-fault-isolation discipline.  Compute
    inside XLA executables is already confined to its buffers; the SFI
    enforcement point here is the host side that stitches calls and state.
  * **shared memory regions** (§3.3): page-aligned windows of the linear
    address space remapped onto local-tier replica buffers.  The function
    keeps seeing one dense address space; accesses to mapped offsets hit the
    *same numpy buffer* every co-located Faaslet maps — genuine zero-copy
    sharing (Fig. 2).
  * **resource budgets** — the cgroup/traffic-shaping analogue: CPU-time and
    network-byte accounting with hard caps enforced at the host interface.

Restore/reset cost (§5.2) is proportional to what *changed*, not to arena
size: a Faaslet tracks dirty WASM pages (``write``/``brk`` mark them), a
Proto-Faaslet snapshot is bound as a shared read-only :class:`ArenaBase`
(mapped copy-on-write, no per-restore arena copy), and the post-call reset
restores only the dirty pages from that base — handing them back to the
kernel via ``madvise(MADV_DONTNEED)`` on the mmap path (RSS shrinks under
churn; ``reclaimed_pages`` counts them), memcpy re-stamping elsewhere.
"""
from __future__ import annotations

import itertools
import mmap
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch import faults
from repro_torch.analysis.sanitizer import make_mutex
from repro_torch.telemetry import clock as tclock

WASM_PAGE = 65536
FAASLET_OVERHEAD_BYTES = 200 * 1024       # paper Tab. 3: ~200 kB per Faaslet
CONTAINER_OVERHEAD_BYTES = 8 * (1 << 20)  # paper §6.2: ~8 MB per container

_ids = itertools.count()

# Snapshots at or below this size restore by eager copy: a µs-scale memcpy
# beats an mmap syscall for tiny arenas, and the dirty-page reset on top is
# O(dirty) either way.  Larger snapshots map the base MAP_PRIVATE so restore
# stays O(1) and clean pages are shared across Faaslets.
EAGER_COPY_MAX_BYTES = 1 << 20


class FaasletMemoryFault(Exception):
    """Out-of-bounds access trapped by the SFI layer."""


class ArenaBase:
    """Shared read-only arena snapshot backing copy-on-write restores (§5.2).

    The snapshot bytes are written once into an anonymous memfd sized to the
    Faaslet's full memory limit (the tail beyond the snapshot is a file hole
    that reads as zeros, which covers pages later exposed by ``brk``).  Every
    restore maps the fd ``MAP_PRIVATE``: the mapping itself is O(1), clean
    pages are shared by all Faaslets stamped from this base, and the kernel
    copies a page only when it is first written.  Where memfd/mmap are
    unavailable the restore falls back to one eager copy — the software
    dirty-page reset on top stays O(dirty) either way.
    """

    def __init__(self, snapshot: bytes, memory_limit: int):
        self.snapshot = snapshot
        self.view = np.frombuffer(snapshot, np.uint8)       # zero-copy, RO
        pages = max(1, -(-max(memory_limit, len(snapshot)) // WASM_PAGE))
        self.span = pages * WASM_PAGE
        self._fd = -1
        if len(snapshot) <= EAGER_COPY_MAX_BYTES:
            return                          # small snapshot: eager-copy restores
        try:
            fd = os.memfd_create("faaslet-arena-base")
            os.truncate(fd, self.span)
            os.pwrite(fd, snapshot, 0)
            self._fd = fd
        except (AttributeError, OSError):
            self._fd = -1

    def __del__(self):
        if getattr(self, "_fd", -1) >= 0:
            try:
                os.close(self._fd)
            except OSError:
                pass

    def map_private(self) -> Tuple[np.ndarray, Optional[mmap.mmap]]:
        """A writable CoW view of the base (plus the mapping keeping it alive)."""
        if self._fd >= 0:
            try:
                mm = mmap.mmap(self._fd, self.span, flags=mmap.MAP_PRIVATE,
                               prot=mmap.PROT_READ | mmap.PROT_WRITE)
                return np.frombuffer(mm, np.uint8), mm
            except (OSError, ValueError):
                pass
        pages = -(-self.view.size // WASM_PAGE)
        arena = np.zeros(pages * WASM_PAGE, np.uint8)
        arena[:self.view.size] = self.view
        return arena, None

    def stamp(self, dest: np.ndarray, lo: int, hi: int) -> None:
        """Overwrite ``dest[lo:hi]`` with the base content of that range."""
        cut = min(hi, self.view.size)
        if lo < cut:
            dest[lo:cut] = self.view[lo:cut]
        if max(lo, cut) < hi:
            dest[max(lo, cut):hi] = 0


class ResourceLimitExceeded(Exception):
    """cgroup/tc analogue: CPU or network budget exhausted."""


@dataclass
class SharedRegion:
    base: int                 # address in the Faaslet's linear memory
    size: int
    key: str                  # state key this region is mapped onto
    backing: np.ndarray       # view into the local-tier replica buffer
    writable: bool = True


@dataclass
class ResourceUsage:
    cpu_ns: int = 0
    net_in: int = 0
    net_out: int = 0
    cpu_budget_ns: Optional[int] = None
    net_budget: Optional[int] = None

    def charge_cpu(self, ns: int):
        self.cpu_ns += ns
        if self.cpu_budget_ns is not None and self.cpu_ns > self.cpu_budget_ns:
            raise ResourceLimitExceeded(f"cpu budget exceeded ({self.cpu_ns} ns)")

    def charge_net(self, n_in: int = 0, n_out: int = 0):
        self.net_in += n_in
        self.net_out += n_out
        if self.net_budget is not None and \
                self.net_in + self.net_out > self.net_budget:
            raise ResourceLimitExceeded("network budget exceeded")


class Faaslet:
    """One isolated execution context bound to a host."""

    def __init__(self, func_name: str, host_id: str, *,
                 memory_limit: int = 64 * WASM_PAGE,
                 initial_pages: int = 4,
                 cpu_budget_ns: Optional[int] = None,
                 net_budget: Optional[int] = None):
        self.id = next(_ids)
        self.func_name = func_name
        self.host_id = host_id
        self.memory_limit = memory_limit
        self._arena = np.zeros(initial_pages * WASM_PAGE, np.uint8)
        self._brk = 0
        self._base: Optional[ArenaBase] = None   # CoW base (set by bind_base)
        self._base_brk = 0
        self._mm: Optional[mmap.mmap] = None     # keeps the private mapping alive
        self._dirty: Set[int] = set()            # page indices written since reset
        self._regions: List[SharedRegion] = []
        self._region_top = memory_limit            # shared regions map above it
        self.usage = ResourceUsage(cpu_budget_ns=cpu_budget_ns,
                                   net_budget=net_budget)
        self.created_at = tclock.now()
        self.calls_served = 0
        self.restored_from_proto = False
        self.reclaimed_pages = 0        # dirty pages handed back via madvise
        self.retained_pages = 0         # dirty pages re-stamped, kept resident
        self._lock = make_mutex("faaslet", f"faaslet:{self.id}")

    # -- private linear memory (brk/mmap) --------------------------------------

    @property
    def brk_value(self) -> int:
        return self._brk

    def brk(self, new_brk: int) -> int:
        with self._lock:
            if new_brk < 0 or new_brk > self.memory_limit:
                raise FaasletMemoryFault(
                    f"brk {new_brk} beyond memory limit {self.memory_limit}")
            if new_brk > self._arena.size:
                pages = -(-new_brk // WASM_PAGE)
                grown = np.zeros(pages * WASM_PAGE, np.uint8)
                grown[:self._arena.size] = self._arena
                self._arena = grown
            if new_brk > self._brk:
                self._mark_dirty(self._brk, new_brk - self._brk)
            self._brk = new_brk
            return self._brk

    def sbrk(self, delta: int) -> int:
        old = self._brk
        self.brk(self._brk + delta)
        return old

    def mmap(self, length: int) -> int:
        """Anonymous private mapping == arena grow (the paper's mmap action)."""
        return self.sbrk(-(-length // WASM_PAGE) * WASM_PAGE)

    # -- dirty-page tracking / copy-on-write base (§5.2) -----------------------

    def _mark_dirty(self, addr: int, length: int) -> None:
        if length > 0:
            self._dirty.update(range(addr // WASM_PAGE,
                                     (addr + length - 1) // WASM_PAGE + 1))

    @property
    def dirty_pages(self) -> Set[int]:
        """Arena pages written (or newly exposed by brk) since the last reset."""
        return set(self._dirty)

    def clear_dirty(self) -> None:
        with self._lock:
            self._dirty.clear()

    def has_base(self) -> bool:
        return self._base is not None

    def bind_base(self, base: ArenaBase, brk: int) -> None:
        """Bind a shared read-only snapshot as this Faaslet's arena (CoW).

        The arena becomes a private mapping of the base: no arena copy is
        made here; the kernel shares clean pages with every other Faaslet
        bound to the same base and copies a page on first write.
        """
        with self._lock:
            arena, mm = base.map_private()
            self._base_brk = min(brk, self.memory_limit)
            need = -(-self._base_brk // WASM_PAGE) * WASM_PAGE
            if arena.size < need:               # eager-copied base below brk
                grown = np.zeros(need, np.uint8)
                grown[:arena.size] = arena
                arena = grown
            self._arena, self._mm = arena, mm
            self._base = base
            self._brk = self._base_brk
            self._dirty.clear()

    def reset_from_base(self, reclaim: str = "always",
                        pressure: bool = False) -> int:
        """§5.2 post-call reset in O(dirty): restore only the dirty pages
        from the bound base (byte-identical to a full ``restore_arena`` from
        the same snapshot).  Returns the number of pages reset.

        ``reclaim`` picks the latency-for-RSS trade per reset:

          * ``"always"`` — on the mmap MAP_PRIVATE path, hand dirty pages
            back with ``madvise(MADV_DONTNEED)``: the private copy is
            dropped, the next access refaults the *shared* base page (file
            holes read as zeros, matching ``stamp``), so RSS shrinks under
            churn — but the next call pays a refault per re-dirtied page.
          * ``"never"`` — memcpy re-stamp only: pages stay resident, hot
            Faaslets stay refault-free.
          * ``"auto"`` — ``"always"`` when the caller signals memory
            ``pressure`` (host RSS over threshold, or the Faaslet is going
            cold behind other warm instances), ``"never"`` otherwise.

        ``reclaimed_pages`` counts pages actually madvise'd back;
        ``retained_pages`` counts pages re-stamped and kept resident (the
        madvise-unavailable fallback lands there too)."""
        if reclaim not in ("auto", "always", "never"):
            raise ValueError(
                f"reclaim {reclaim!r} not in ('auto', 'always', 'never')")
        if reclaim == "auto":
            reclaim = "always" if pressure else "never"
        faults.point("slow-host", host=self.host_id)
        with self._lock:
            if self._base is None:
                raise RuntimeError("no ArenaBase bound; use restore_arena")
            reset = 0
            can_reclaim = (reclaim == "always"
                           and self._mm is not None
                           and hasattr(mmap, "MADV_DONTNEED")
                           and hasattr(self._mm, "madvise"))
            for lo, hi in self._dirty_runs():
                if lo >= self._arena.size:
                    continue
                hi = min(hi, self._arena.size)
                n_pages = -(-(hi - lo) // WASM_PAGE)
                if can_reclaim:
                    try:
                        self._mm.madvise(mmap.MADV_DONTNEED, lo, hi - lo)
                        self.reclaimed_pages += n_pages
                        reset += n_pages
                        continue
                    except (OSError, ValueError):
                        can_reclaim = False      # fall back for the rest
                for p_lo in range(lo, hi, WASM_PAGE):
                    self._base.stamp(self._arena, p_lo,
                                     min(p_lo + WASM_PAGE, self._arena.size))
                    self.retained_pages += 1
                    reset += 1
            self._dirty.clear()
            self._brk = self._base_brk
            return reset

    def _dirty_runs(self):
        """Yield (lo, hi) byte ranges of maximal runs of dirty pages, so the
        madvise path issues one syscall per contiguous run."""
        run_start = prev = None
        for p in sorted(self._dirty):
            if prev is not None and p == prev + 1:
                prev = p
                continue
            if run_start is not None:
                yield run_start * WASM_PAGE, (prev + 1) * WASM_PAGE
            run_start = prev = p
        if run_start is not None:
            yield run_start * WASM_PAGE, (prev + 1) * WASM_PAGE

    # -- shared regions (§3.3) ------------------------------------------------------

    def map_shared_region(self, key: str, backing: np.ndarray,
                          writable: bool = True) -> SharedRegion:
        """Extend linear memory and remap the new pages onto ``backing``.

        Returns the region; its ``base`` is the Faaslet-local address."""
        with self._lock:
            size = -(-backing.size // WASM_PAGE) * WASM_PAGE
            region = SharedRegion(base=self._region_top, size=backing.size,
                                  key=key, backing=backing, writable=writable)
            self._regions.append(region)
            self._region_top += size
            return region

    def unmap_shared_region(self, region: SharedRegion) -> None:
        with self._lock:
            self._regions.remove(region)

    def region_for(self, key: str) -> Optional[SharedRegion]:
        with self._lock:
            for r in self._regions:
                if r.key == key:
                    return r
            return None

    # -- bounds-checked access (the SFI guarantee) -----------------------------------

    def _locate(self, addr: int, length: int) -> Tuple[np.ndarray, int]:
        if length < 0:
            raise FaasletMemoryFault("negative length")
        if 0 <= addr and addr + length <= self._brk:
            return self._arena, addr
        for r in self._regions:
            if r.base <= addr and addr + length <= r.base + r.size:
                return r.backing, addr - r.base
        raise FaasletMemoryFault(
            f"access [{addr}, {addr + length}) outside private memory "
            f"[0, {self._brk}) and all shared regions")

    def read(self, addr: int, length: int) -> np.ndarray:
        """Zero-copy view of linear memory (trap on out-of-bounds).

        Arena views come back read-only: mutations must go through
        :meth:`write` so dirty-page tracking sees them (otherwise a warm
        reset could miss them and leak bytes into the next call).  Shared
        regions stay writable — that is the §3.3 zero-copy write path —
        unless the region itself was mapped read-only."""
        buf, off = self._locate(addr, length)
        view = buf[off:off + length]
        if buf is self._arena:
            view.setflags(write=False)
        else:
            for r in self._regions:
                if r.backing is buf and not r.writable:
                    view.setflags(write=False)
                    break
        return view

    def write(self, addr: int, data) -> None:
        data = np.frombuffer(bytes(data), np.uint8) if not isinstance(
            data, np.ndarray) else data.view(np.uint8).reshape(-1)
        buf, off = self._locate(addr, len(data))
        for r in self._regions:
            if r.backing is buf and not r.writable:
                raise FaasletMemoryFault(f"write to read-only region {r.key!r}")
        if buf is self._arena:
            self._mark_dirty(off, len(data))
        buf[off:off + len(data)] = data

    # -- introspection ----------------------------------------------------------------

    def memory_bytes(self) -> int:
        """Private footprint (shared regions are counted once per host).

        A mmap-CoW Faaslet privately owns only its dirty pages — clean pages
        belong to the shared base, which :meth:`base_footprint` reports so
        the host can count it once across all Faaslets bound to it.  An
        eager-copied arena (small snapshot, or mmap unavailable) is fully
        private and charged in full."""
        if self._mm is not None:
            return len(self._dirty) * WASM_PAGE + FAASLET_OVERHEAD_BYTES
        return self._arena.size + FAASLET_OVERHEAD_BYTES

    def base_footprint(self) -> Optional[Tuple[int, int]]:
        """(base identity, resident bytes) of the shared CoW base, or None
        when the arena is a private copy (nothing is actually shared).
        Hosts deduplicate on the identity: one snapshot, one charge."""
        if self._mm is None:
            return None
        return id(self._base), -(-self._base.view.size // WASM_PAGE) * WASM_PAGE

    def snapshot_arena(self) -> bytes:
        with self._lock:
            return self._arena[:self._brk].tobytes()

    def restore_arena(self, data: bytes, brk: int) -> None:
        """Full-copy restore (the pre-CoW baseline, kept for comparison and
        for restores without a bound :class:`ArenaBase`)."""
        with self._lock:
            self.brk(max(brk, len(data)))
            self._arena[:len(data)] = np.frombuffer(data, np.uint8)
            self._mark_dirty(0, len(data))
            self._brk = brk
