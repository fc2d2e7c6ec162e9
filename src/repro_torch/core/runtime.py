"""FAASM runtime: hosts, calls, chaining, fault tolerance (Faasm §5).

A :class:`FaasmRuntime` manages a cluster of :class:`Host` instances (each a
runtime instance with its own local tier, local scheduler, Faaslet pool and
executor threads).  Functions are uploaded once (validation → codegen →
Proto-Faaslet generation, §3.4/§5.2) and then invoked/chained from anywhere.

Isolation modes (the paper's §6 comparison, same application code):
  * ``faaslet``   — co-located functions share the host local tier zero-copy;
                    cold starts restore Proto-Faaslets.
  * ``container`` — the Knative-like baseline: every Faaslet gets a *private*
                    tier (state is copied in/out — data shipping), cold starts
                    re-run init code, per-instance memory overhead is
                    container-sized.

Fault tolerance: heartbeat-based failure detection, re-execution of calls
lost on dead hosts, speculative re-execution of stragglers (work sharing),
elastic add/remove of hosts.

Device: the runtime runs its state plane — device replicas and the wire
codec's kernels — on ``device``: the CUDA card by default (it raises
without one), the CPU only when asked for (``device="cpu"``).  The
reference picks its accelerator implicitly; here the choice is explicit and
handed to the global tier, which hands it to every local tier.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
import zlib
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch import cancellation, faults
from repro_torch import overload as oload
from repro_torch.analysis.sanitizer import make_mutex
from repro_torch.core.faaslet import (CONTAINER_OVERHEAD_BYTES,
                                FAASLET_OVERHEAD_BYTES, Faaslet)
from repro_torch.core.host_interface import (CallCancelled, DeadlineExceeded,
                                       FaasmAPI)
from repro_torch.core.proto import ExecutableCache, ProtoFaaslet
from repro_torch.core.scheduler import LocalScheduler
from repro_torch.core.vfs import VirtualFS
from repro_torch.kernels.common import resolve_device
from repro_torch.state import wire as _wire_mod
from repro_torch.state.kv import GlobalTier
from repro_torch.state.local import LocalTier
from repro_torch.telemetry import clock as tclock
from repro_torch.telemetry import metrics as tmetrics

_call_ids = itertools.count(1)

# Telemetry hook state, installed by repro_torch.telemetry.enable(); every hook
# site below is guarded by one pointer compare — zero ring writes disarmed
# (asserted by scripts/check_jax_pin.py).
_TEL = None

try:
    import resource as _resource
    _PAGE_SIZE = _resource.getpagesize()
except ImportError:  # pragma: no cover - CPython always ships resource on linux
    _PAGE_SIZE = 4096


def _proc_rss_bytes() -> Optional[int]:
    """The process's real resident set size from ``/proc/self/statm``
    (field 2, in pages), or ``None`` where procfs is unavailable — callers
    fall back to the tier/Faaslet bookkeeping estimate."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * _PAGE_SIZE
    except (OSError, IndexError, ValueError):
        return None


@dataclass
class FunctionDef:
    """An uploaded function: the 'WebAssembly module' analogue."""

    name: str
    fn: Callable[[FaasmAPI], int]               # returns a status code
    init_fn: Optional[Callable[[FaasmAPI], Any]] = None
    memory_limit: int = 64 * 65536
    cpu_budget_ns: Optional[int] = None
    net_budget: Optional[int] = None
    # dequeue shed floor: a deadlined call whose remaining budget is below
    # this when it reaches the front of a host queue is shed (DEADLINE_RC)
    # instead of burning an executor slot on work that can't finish in time.
    # 0.0 defers to OverloadPolicy.deadline_floor_s.
    deadline_floor_s: float = 0.0


@dataclass
class Call:
    id: int
    fn: str
    input: bytes
    status: str = "pending"                      # pending|running|done|failed
    output: bytes = b""
    return_code: int = -1
    host: Optional[str] = None
    parent: Optional[int] = None
    attempts: int = 0
    cold_start: bool = False
    t_submit: float = 0.0
    t_start: float = 0.0
    t_end: float = 0.0
    error: str = ""
    twin_id: Optional[int] = None                # speculative re-execution
    primary_id: Optional[int] = None             # set on twins: who to adopt into
    # end-to-end deadline (repro_torch.overload.Deadline), inherited by chained
    # children.  None — the overwhelmingly common case — keeps every
    # deadline hook site at one pointer compare.
    deadline: Optional[oload.Deadline] = None
    # attempt fencing (exactly-once state effects): every physical execution
    # of this logical call — first dispatch, requeue after host loss, or a
    # speculative twin — carries a distinct epoch drawn from the *primary*
    # call's counter.  The global tier rejects delta pushes from superseded
    # or sealed epochs, so re-execution can't double-apply state.
    fence_epoch: int = 0                         # epoch of the current attempt
    _epoch_counter: int = 0                      # allocator (primaries only)
    event: threading.Event = field(default_factory=threading.Event)
    # cooperative cancel: set when this execution's speculative counterpart
    # already settled; checked by FaasmAPI at chain/await/state points
    cancel_event: threading.Event = field(default_factory=threading.Event)
    _cb_lock: threading.Lock = field(default_factory=threading.Lock,
                                     repr=False)
    _callbacks: List[Callable[["Call"], None]] = field(default_factory=list,
                                                       repr=False)

    @property
    def latency(self) -> float:
        return (self.t_end or tclock.now()) - self.t_submit

    @property
    def queue_wait(self) -> float:
        """Submit → start of the winning attempt, on the telemetry clock
        (all three stamps come from ``repro_torch.telemetry.clock``, so the
        difference is well-defined by construction)."""
        if not self.t_start:
            return 0.0
        return max(self.t_start - self.t_submit, 0.0)

    @property
    def exec_wall(self) -> float:
        """Start → settle of the current/last attempt (running calls
        report elapsed-so-far)."""
        if not self.t_start:
            return 0.0
        return (self.t_end or tclock.now()) - self.t_start

    @property
    def fence_id(self) -> str:
        """Logical-call identity for attempt fencing: a speculative twin
        writes state under its primary's id, so both race for one fence."""
        base = self.id if self.primary_id is None else self.primary_id
        return f"c{base}"

    def alloc_epoch(self) -> int:
        """Next attempt epoch.  Call on the *primary* only — twins draw
        their epochs from the primary's counter (shared fence)."""
        with self._cb_lock:
            self._epoch_counter += 1
            return self._epoch_counter

    def add_done_callback(self, cb: Callable[["Call"], None]) -> None:
        """Run ``cb(call)`` once the call completes (immediately if done)."""
        with self._cb_lock:
            if not self.event.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    def _settle(self, mutate: Callable[["Call"], None]) -> bool:
        """Atomically apply the final result fields and mark the call done.

        Only the first settle wins: a late completion (e.g. a straggler whose
        speculative twin already adopted its result into us) must not
        overwrite what waiters have observed.  Returns False if already done.
        """
        with self._cb_lock:
            if self.event.is_set():
                return False
            mutate(self)
            self.event.set()
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)
        return True


class Host:
    """One FAASM runtime instance (one server / TPU host)."""

    def __init__(self, host_id: str, runtime: "FaasmRuntime", *,
                 capacity: int = 8, isolation: str = "faaslet",
                 reclaim: str = "auto",
                 reclaim_rss_bytes: int = 256 << 20,
                 max_queue_depth: Optional[int] = None):
        self.id = host_id
        self.runtime = runtime
        self.capacity = capacity
        # bounded admission: at most capacity + max_queue_depth calls may be
        # in flight (running + queued); submit() beyond that raises
        # overload.QueueFull for the dispatcher to spill or shed.  None
        # keeps the queue unbounded (today's behaviour).
        self.max_queue_depth = max_queue_depth
        self.isolation = isolation
        # CoW page-reclaim policy for the §5.2 post-call reset: "always"
        # madvises every dirty page back (lowest RSS, next call refaults),
        # "never" re-stamps in place (hot Faaslets stay refault-free), and
        # "auto" reclaims only when host RSS exceeds ``reclaim_rss_bytes``
        # (the warm pool is LIFO, so the Faaslet being reset is the hot one).
        # "auto" pressure reads the process's real RSS growth since this
        # host came up (/proc/self/statm), falling back to the tier+Faaslet
        # bookkeeping estimate where procfs is unavailable — the baseline
        # delta keeps the interpreter's own footprint (jax alone dwarfs the
        # default threshold) out of the signal.
        self.reclaim = reclaim
        self.reclaim_rss_bytes = reclaim_rss_bytes
        self._rss_baseline = _proc_rss_bytes()
        self.local_tier = LocalTier(host_id, runtime.global_tier)
        self._container_tiers: Dict[int, LocalTier] = {}
        self._warm: Dict[str, List[Faaslet]] = defaultdict(list)
        self._user_state: Dict[int, Any] = {}
        self._mutex = make_mutex("host", f"host:{host_id}")
        self._inflight = 0
        self.alive = True
        self.pool = ThreadPoolExecutor(max_workers=capacity,
                                       thread_name_prefix=f"host-{host_id}")
        self.heartbeat = time.monotonic()
        # metrics
        self.cold_starts = 0
        self.warm_hits = 0
        self.resets = 0                  # §5.2 post-call resets performed
        self.reset_pages = 0             # dirty pages re-stamped across resets
        self.reclaimed_pages = 0         # dirty pages madvise'd back (CoW path)
        self.retained_pages = 0          # dirty pages re-stamped, kept resident
        self.cancelled_execs = 0         # speculative losers stopped early
        self.rejected_submits = 0        # bounded-queue admission refusals
        self.init_seconds: List[float] = []
        self.billable_byte_seconds = 0.0
        self.calls_done = 0

    # -- capacity / liveness -----------------------------------------------------

    def has_capacity(self) -> bool:
        with self._mutex:
            return self.alive and self._inflight < self.capacity

    def has_room(self) -> bool:
        """Would :meth:`submit` admit a call right now?  Unlike
        ``has_capacity`` (free executor slot), this is the bounded-queue
        admission bound: running + queued below capacity + max_queue_depth.
        Always True for unbounded hosts."""
        with self._mutex:
            if not self.alive:
                return False
            if self.max_queue_depth is None:
                return True
            return self._inflight < self.capacity + self.max_queue_depth

    def queue_depth(self) -> int:
        """Calls admitted but not yet running (executor backlog)."""
        with self._mutex:
            return max(0, self._inflight - self.capacity)

    def beat(self):
        self.heartbeat = time.monotonic()

    # -- tiers -------------------------------------------------------------------

    def local_tier_for(self, faaslet: Faaslet) -> LocalTier:
        if self.isolation == "container":
            with self._mutex:
                t = self._container_tiers.get(faaslet.id)
                if t is None:
                    t = LocalTier(f"{self.id}/c{faaslet.id}",
                                  self.runtime.global_tier)
                    # container pulls are charged to the host for metrics
                    t.host_id = self.id
                    self._container_tiers[faaslet.id] = t
                return t
        return self.local_tier

    def memory_bytes(self) -> int:
        """Host resident footprint: shared tier + per-instance overheads.
        CoW bases are charged once per host, not once per Faaslet."""
        with self._mutex:
            warm = [f for fl in self._warm.values() for f in fl]
            per_inst = sum(f.memory_bytes() for f in warm)
            bases = dict(fp for fp in (f.base_footprint() for f in warm)
                         if fp is not None)
            per_inst += sum(bases.values())
            if self.isolation == "container":
                per_inst += sum(t.memory_bytes()
                                for t in self._container_tiers.values())
                per_inst += CONTAINER_OVERHEAD_BYTES * max(
                    1, sum(len(fl) for fl in self._warm.values()))
            return self.local_tier.memory_bytes() + per_inst

    # -- execution -------------------------------------------------------------

    def submit(self, call: Call):
        # chaos hook: an armed queue-flood rule makes this admission behave
        # as if the bounded queue were full (outside the mutex — the armed
        # path may sleep, and lock-blocking forbids that under a lock)
        flooded = faults.point("queue-flood", call=call.id, host=self.id)
        with self._mutex:
            if not self.alive:
                raise RuntimeError(f"host {self.id} is down")
            if flooded or (self.max_queue_depth is not None
                           and self._inflight >=
                           self.capacity + self.max_queue_depth):
                self.rejected_submits += 1
                raise oload.QueueFull(
                    f"host {self.id} admission queue full "
                    f"({self._inflight} in flight)")
            # Claim the call for this host *before* it reaches the pool:
            # if the host dies while the call is still queued (never ran),
            # ``_requeue_lost`` must still find and re-dispatch it.
            call.host = self.id
            self._inflight += 1
        self.pool.submit(self._run_guarded, call)

    def _run_guarded(self, call: Call):
        try:
            self._run(call)
        except faults.HostCrash:
            # injected fail-stop: the call is NOT settled — the host dies
            # and its in-flight work (this call included) is requeued
            # elsewhere with a fresh fence epoch, exactly like an external
            # ``fail_host``.  Fencing makes the re-execution exactly-once.
            self.runtime.fail_host(self.id)
        except Exception as e:                    # defensive: never lose a call
            self.runtime._finish_call(call, rc=1, status="failed",
                                      error=f"host crash: {e!r}")
        finally:
            tel = _TEL
            if tel is not None:
                tel.clear_ctx()                  # executor thread is reused
            with self._mutex:
                self._inflight -= 1

    def _acquire_faaslet(self, fdef: FunctionDef):
        with self._mutex:
            pool = self._warm[fdef.name]
            if pool:
                self.warm_hits += 1
                return pool.pop(), False
        # cold start
        t0 = tclock.now()
        proto = self.runtime.proto_for(fdef.name, host=self.id)
        if proto is not None and self.isolation == "faaslet":
            f, user_state = proto.restore(self.id)
            self._user_state[f.id] = user_state
        else:
            f = Faaslet(fdef.name, self.id, memory_limit=fdef.memory_limit,
                        cpu_budget_ns=fdef.cpu_budget_ns,
                        net_budget=fdef.net_budget)
            if fdef.init_fn is not None:          # container path re-inits
                api = FaasmAPI(f, self, self.runtime, _InitCall())
                self._user_state[f.id] = fdef.init_fn(api)
        dt = tclock.now() - t0
        with self._mutex:
            self.cold_starts += 1
            self.init_seconds.append(dt)
        return f, True

    def user_state(self, faaslet: Faaslet) -> Any:
        return self._user_state.get(faaslet.id)

    def _run(self, call: Call):
        self.beat()
        rt = self.runtime
        fdef = rt.functions[call.fn]
        dl = call.deadline
        if dl is not None:
            # dequeue shed: a call that waited out (most of) its budget in
            # the queue is settled DEADLINE_RC here instead of occupying an
            # executor slot it can't finish in.  The skew point lets chaos
            # runs evaporate the budget between queue and check.
            faults.point("deadline-clock-skew", call=call.id, host=self.id)
            floor = fdef.deadline_floor_s
            ovl = rt.overload
            if floor <= 0.0 and ovl is not None:
                floor = ovl.deadline_floor_s
            if dl.remaining() <= floor:
                rt._count_overload("deadline_total")
                rt._finish_call(call, rc=oload.DEADLINE_RC, status="deadline",
                                error="deadline expired before execution")
                return
        call.host = self.id
        call.status = "running"
        call.t_start = tclock.now()
        # attempt identity: if the runtime supersedes this epoch mid-flight
        # (host declared dead, call requeued), this attempt is a zombie and
        # must not settle the call — see the guard before _finish_call below
        my_epoch = call.fence_epoch
        tel = _TEL
        if tel is not None:
            # trace context for everything this attempt does on this
            # thread (wire frames, fault hits, kernel work): twins and
            # retries share the primary's fence with distinct epochs, so
            # their spans group as siblings of one logical call
            tel.set_ctx(call=call.id, fence=call.fence_id,
                        epoch=call.fence_epoch, host=self.id)
            tel.record("call.queue", "call", call.t_submit, call.t_start,
                       fn=call.fn, attempt=call.attempts)
        faaslet, cold = self._acquire_faaslet(fdef)
        call.cold_start = cold
        if tel is not None:
            # restore = proto arena bind (cold) or warm-pool pop (~0)
            tel.record("call.restore", "call", call.t_start, tclock.now(),
                       fn=call.fn, cold=cold)
        api = FaasmAPI(faaslet, self, rt, call)
        t0 = tclock.now()
        faults.point("slow-host", call=call.id, host=self.id)
        # arm the time-sliced cancel checkpoint: kernel dispatch wrappers
        # call it, so pure-compute loops between host-interface calls also
        # honour cancel_event within a bounded slice.  The checkpoint also
        # beats the host heartbeat, so a long kernel loop doesn't read as a
        # dead host to a short ``heartbeat_timeout``.
        cancellation.install(api.check_cancelled, beat=self.beat,
                             budget=dl.remaining if dl is not None else None)
        try:
            ret = fdef.fn(api)
            rc = int(ret) if ret is not None else 0
            status = "done" if rc == 0 else "failed"
            error = ""
        except faults.HostCrash:
            # injected fail-stop: the whole host dies with the call mid-
            # flight — no settling, no cleanup; _run_guarded turns this
            # into a host failure + requeue, like an external fail_host
            raise
        except DeadlineExceeded as e:
            # end-to-end deadline hit mid-execution: same cooperative
            # unwind as a cancel, distinct return code for waiters.  The
            # cleanup below discards un-pushed deltas; already-pushed ones
            # stay exactly-once under the attempt fence.
            rt._count_overload("deadline_total")
            rc, status, error = oload.DEADLINE_RC, "deadline", repr(e)
        except CallCancelled as e:
            # speculative counterpart already settled: stop quietly and free
            # the executor slot (the result everyone sees was adopted already)
            rc, status, error = 1, "cancelled", repr(e)
        except Exception as e:
            rc, status, error = 1, "failed", repr(e)
        finally:
            cancellation.clear()                 # executor thread is reused
        t_end = tclock.now()
        if tel is not None:
            tel.record("call.exec", "call", t0, t_end, fn=call.fn,
                       status=status, rc=rc, cold=cold)
        dur = t_end - t0
        faaslet.usage.charge_cpu(int(dur * 1e9))
        faaslet.calls_served += 1

        # billable memory (GB·s attribution, §6.1 "billable memory")
        overhead = (CONTAINER_OVERHEAD_BYTES if self.isolation == "container"
                    else FAASLET_OVERHEAD_BYTES)
        priv = faaslet.memory_bytes() - FAASLET_OVERHEAD_BYTES + overhead
        if self.isolation == "container":
            priv += self.local_tier_for(faaslet).memory_bytes()
        with self._mutex:
            self.billable_byte_seconds += dur * priv
            self.calls_done += 1
            if status == "cancelled":
                self.cancelled_execs += 1

        # failed call in container mode: drop the private tier (and any
        # half-written replica) so a retry re-pulls clean state
        if self.isolation == "container" and status != "done":
            with self._mutex:
                self._container_tiers.pop(faaslet.id, None)
        # failed call in faaslet mode: the host tier is shared, so it can't
        # be dropped wholesale — instead resync any key this call dirtied
        # but never pushed back to global truth, so a half-written delta
        # doesn't leak into the next call's view (or a later push)
        if self.isolation == "faaslet" and status != "done":
            for k in api.dirtied_keys():
                self.local_tier.discard_unpushed(k)

        # §5.2: reset from Proto-Faaslet so no private data leaks across
        # calls — O(dirty pages) when the Faaslet carries a CoW base
        proto = rt.proto_for(call.fn, host=self.id, transfer=False)
        if proto is not None and self.isolation == "faaslet":
            t0_reset = tclock.now()
            if faaslet.has_base():
                reclaimed0 = faaslet.reclaimed_pages
                retained0 = faaslet.retained_pages
                pressure = False
                if self.reclaim == "auto":
                    # the warm pool is LIFO (this Faaslet is appended last
                    # and popped first), so a returning Faaslet is the HOT
                    # one — keep it refault-free unless host RSS actually
                    # crossed the threshold.  Real RSS growth since host
                    # init (procfs) is the ground truth; the bookkeeping
                    # estimate (memory_bytes() counts only pooled Faaslets,
                    # so add the one being reset — its dirty pages are
                    # exactly what reclaim would return) is the fallback.
                    rss = _proc_rss_bytes()
                    if rss is not None and self._rss_baseline is not None:
                        pressure = (rss - self._rss_baseline
                                    >= self.reclaim_rss_bytes)
                    else:
                        pressure = (self.memory_bytes()
                                    + faaslet.memory_bytes()
                                    >= self.reclaim_rss_bytes)
                pages = faaslet.reset_from_base(reclaim=self.reclaim,
                                                pressure=pressure)
                reclaimed = faaslet.reclaimed_pages - reclaimed0
                retained = faaslet.retained_pages - retained0
            else:
                faaslet.restore_arena(proto.arena, proto.brk)
                pages = len(faaslet.dirty_pages)
                faaslet.clear_dirty()
                reclaimed = retained = 0
            with self._mutex:
                self.resets += 1
                self.reset_pages += pages
                self.reclaimed_pages += reclaimed
                self.retained_pages += retained
            if tel is not None:
                tel.record("call.reset", "call", t0_reset, tclock.now(),
                           pages=pages, reclaimed=reclaimed,
                           retained=retained)
        with self._mutex:
            if self.alive:
                self._warm[call.fn].append(faaslet)
        self.beat()
        if my_epoch and (call.fence_epoch != my_epoch
                         or rt.global_tier.fence_is_dead(call.fence_id,
                                                         my_epoch)):
            # Zombie attempt: the runtime gave up on this epoch (heartbeat
            # false positive / fail_host requeue) while the body was still
            # running.  Any push made after the supersede was fence-rejected,
            # so settling ``done`` here would report success for effects that
            # never landed — the re-dispatched epoch owns the settle.  The
            # supersede-before-redispatch ordering in _requeue_lost makes
            # this check sound: a push that was admitted implies the epoch
            # was live at push time, and an epoch still live *here* (after
            # the last push) was live for every push.
            return
        self.runtime._finish_call(call, rc=rc, status=status, error=error,
                                  t_end=t_end)

    # -- failure / drain ---------------------------------------------------------

    def fail(self):
        """Simulate host loss: local tier and warm pool are gone."""
        with self._mutex:
            self.alive = False
            self._warm.clear()
            self._container_tiers.clear()
        self.local_tier.drop()
        self.pool.shutdown(wait=False, cancel_futures=True)

    def drain(self):
        with self._mutex:
            self.alive = False
        self.pool.shutdown(wait=True)


class _InitCall:
    """Placeholder call context for init-code execution."""
    id = 0
    input = b""
    output = b""


class CompletionLatch:
    """Counts down once per completed call; waiters block on a single event.

    ``wait_all`` registers one latch across N calls instead of N sequential
    ``Event.wait`` rounds, so a thousand-call fan-out wakes its waiter once.
    """

    def __init__(self, n: int):
        self._lock = threading.Lock()
        self._remaining = n
        self._event = threading.Event()
        if n <= 0:
            self._event.set()

    def count_down(self, _call: Optional[Call] = None) -> None:
        with self._lock:
            self._remaining -= 1
            if self._remaining <= 0:
                self._event.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


class BatchTimeout(TimeoutError):
    """A ``wait_all`` deadline passed with part of the batch outstanding.

    Carries the split as structured payload so a partial fan-out timeout is
    debuggable without tracing: ``pending`` is the ids still in flight (in
    batch order) and ``done`` maps each completed id to its return code."""

    def __init__(self, pending: List[int], done: Dict[int, int],
                 timeout: Optional[float]):
        self.pending = pending
        self.done = done
        self.timeout = timeout
        super().__init__(
            f"{len(pending)}/{len(pending) + len(done)} calls still "
            f"outstanding after {timeout}s: {pending}")


class FaasmRuntime:
    def __init__(self, n_hosts: int = 2, *, isolation: str = "faaslet",
                 use_proto: bool = True, capacity: int = 8,
                 chunk_size: int = 1 << 20,
                 straggler_timeout: Optional[float] = None,
                 heartbeat_timeout: Optional[float] = None,
                 reclaim: str = "auto",
                 max_retries: int = 2, backoff: float = 0.005,
                 overload: Optional[oload.OverloadPolicy] = None,
                 device="cuda"):
        # heartbeat_timeout: when set, the background monitor declares hosts
        # silent for that long (with calls in flight) dead and requeues their
        # work.  Opt-in: a host only beats at call boundaries (and at kernel
        # cancellation checkpoints), so any timeout shorter than a legitimate
        # call would hard-fail a healthy host.
        # max_retries: re-execution budget per call beyond the first attempt
        # (host loss or dispatch failure); backoff: base of the exponential
        # re-dispatch delay (attempt n sleeps backoff * 2^(n-1), capped).
        # overload: arms the overload control plane (bounded host queues,
        # default deadlines, retry budget, per-host circuit breakers — see
        # repro_torch.overload.OverloadPolicy).  None, the default, leaves every
        # overload hook disarmed at one pointer compare.
        assert isolation in ("faaslet", "container")
        assert reclaim in ("auto", "always", "never")
        assert max_retries >= 0 and backoff >= 0.0
        # first: a runtime asked for the card raises before it starts a
        # host or a thread
        self.device = resolve_device(device)
        self.isolation = isolation
        self.reclaim = reclaim
        self.use_proto = use_proto and isolation == "faaslet"
        self.global_tier = GlobalTier(chunk_size=chunk_size,
                                      device=self.device)
        self.vfs = VirtualFS(self.global_tier)
        self.exec_cache = ExecutableCache()
        self.functions: Dict[str, FunctionDef] = {}
        self._protos: Dict[str, ProtoFaaslet] = {}       # host-side proto cache
        self._modules: Dict[str, Dict[str, Callable]] = {}
        self.hosts: Dict[str, Host] = {}
        self.schedulers: Dict[str, LocalScheduler] = {}
        self._calls: Dict[int, Call] = {}
        self._active: set = set()                # ids of not-yet-completed calls
        self._rr = itertools.count()
        self._mutex = make_mutex("runtime")
        # virtual-socket mailboxes: bounded so a flooding sender backpressures
        # instead of growing an invisible unbounded backlog (bounded-queue
        # lint rule; depth is the factory default)
        self._net: Dict[tuple, queue.Queue] = defaultdict(oload.bounded_queue)
        self.straggler_timeout = straggler_timeout
        self.heartbeat_timeout = heartbeat_timeout
        self.max_retries = max_retries
        self.backoff = backoff
        self.max_attempts = max_retries + 1
        # overload control plane (all None/zero when disarmed)
        self.overload = overload
        self._retry_budget = overload.retry_budget if overload else None
        self._breakers: Optional[Dict[str, oload.CircuitBreaker]] = (
            {} if overload is not None and overload.breaker is not None
            else None)
        self.shed_total = 0              # admission refusals settled SHED_RC
        self.deadline_total = 0          # calls settled DEADLINE_RC
        self.spill_total = 0             # admissions spilled to a peer
        # one registry per runtime: hot paths keep their lock-local
        # counters; this collector snapshots them into gauges at scrape
        # time (metrics_text / cold_start_stats / benchmarks all read it)
        self.metrics = tmetrics.Registry()
        self._init_pub: Dict[str, int] = {}      # init_seconds scrape cursors
        self.metrics.register_collector(self._publish_metrics)
        for i in range(n_hosts):
            self.add_host(capacity=capacity)
        # Background monitor: straggler speculation + heartbeat failure
        # detection fire from here, so no waiter ever has to spin-poll.
        self._monitor_cv = threading.Condition()
        self._monitor_stop = False
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, name="faasm-monitor", daemon=True)
        self._monitor_thread.start()

    # -- cluster elasticity ------------------------------------------------------

    def add_host(self, capacity: int = 8) -> str:
        ovl = self.overload
        with self._mutex:
            hid = f"host{len(self.hosts)}"
            while hid in self.hosts:
                hid += "x"
            h = Host(hid, self, capacity=capacity, isolation=self.isolation,
                     reclaim=self.reclaim,
                     max_queue_depth=(ovl.max_queue_depth
                                      if ovl is not None else None))
            self.hosts[hid] = h
            self.schedulers[hid] = LocalScheduler(h, self)
            if self._breakers is not None:
                self._breakers[hid] = ovl.breaker()
            return hid

    def remove_host(self, host_id: str, drain: bool = True) -> None:
        h = self.hosts[host_id]
        if drain:
            h.drain()
        else:
            h.fail()
        self.schedulers[host_id].deregister_warm(host_id)

    def alive_hosts(self) -> List[Host]:
        return [h for h in self.hosts.values() if h.alive]

    # -- upload service (§3.4 + §5.2) -----------------------------------------------

    def upload(self, fdef: FunctionDef) -> None:
        """Validate, 'code-generate', and build the Proto-Faaslet."""
        if not callable(fdef.fn):
            raise TypeError("function body must be callable")
        self.functions[fdef.name] = fdef
        if self.use_proto:
            host = next(iter(self.alive_hosts()))
            f = Faaslet(fdef.name, host.id, memory_limit=fdef.memory_limit)
            api = FaasmAPI(f, host, self, _InitCall())
            user_state = fdef.init_fn(api) if fdef.init_fn else None
            proto = ProtoFaaslet.capture(f, user_state)
            # store in the global tier => restorable on any host (cross-host)
            self.global_tier.set(f"proto/{fdef.name}", proto.serialize(),
                                 host="upload")

    def proto_for(self, fn: str, *, host: str,
                  transfer: bool = True) -> Optional[ProtoFaaslet]:
        if not self.use_proto:
            return None
        with self._mutex:
            p = self._protos.get(fn)
        if p is None:
            key = f"proto/{fn}"
            if not self.global_tier.exists(key):
                return None
            data = (self.global_tier.get(key, host=host) if transfer
                    else self.global_tier.get(key, host="cache"))
            p = ProtoFaaslet.deserialize(data)
            with self._mutex:
                self._protos[fn] = p
        return p

    # -- modules (dlopen) --------------------------------------------------------

    def register_module(self, name: str, symbols: Dict[str, Callable]) -> None:
        self._modules[name] = dict(symbols)

    def has_module(self, name: str) -> bool:
        return name in self._modules

    def module_symbol(self, name: str, symbol: str) -> Callable:
        return self._modules[name][symbol]

    # -- invocation --------------------------------------------------------------

    def invoke(self, fn: str, input_data: bytes = b"",
               parent: Optional[Call] = None,
               deadline: Optional[Any] = None) -> int:
        return self.invoke_many(fn, [input_data], parent=parent,
                                deadline=deadline)[0]

    def _resolve_deadline(self, deadline, parent: Optional[Call]):
        """Deadline for a new batch: explicit (a Deadline, or a float budget
        in seconds) > inherited from the parent (same absolute expiry, so
        children get exactly the remaining budget) > the overload policy's
        default.  None everywhere — the common case — stays None."""
        if deadline is not None:
            if isinstance(deadline, oload.Deadline):
                return deadline
            return oload.Deadline.after(float(deadline))
        if parent is not None and parent.deadline is not None:
            return parent.deadline
        ovl = self.overload
        if ovl is not None and ovl.default_deadline_s:
            return oload.Deadline.after(ovl.default_deadline_s)
        return None

    def invoke_many(self, fn: str, inputs, parent: Optional[Call] = None,
                    state_hint: Optional[List[Any]] = None,
                    deadline: Optional[Any] = None) -> List[int]:
        """Submit one call per input in a single batch; returns all call IDs.

        The IDs come back in input order — pair with :meth:`wait_all` for
        thousand-call fan-outs without per-call round trips.

        ``state_hint`` optionally names the state keys the batch will touch:
        placement then prefers warm hosts whose local tier already holds
        those keys (Cloudburst-style locality awareness) before
        round-robining, avoiding a redundant global-tier pull per host.
        Two shapes are accepted: a flat list of keys shared by the whole
        batch (``["k"]``), or one entry *per call* — a key, a list of keys,
        or ``None`` (``[["a"], ["b"], None, ...]``, same length as
        ``inputs``).  Per-call hints rendezvous each call to the holder of
        **its own** key, so a fan-out over disjoint keys shards across the
        holder set instead of piling onto whichever host won the batch vote.

        ``deadline`` stamps an end-to-end expiry on every call in the batch:
        an :class:`repro_torch.overload.Deadline`, or a float budget in seconds.
        Omitted, chained children inherit their parent's deadline and
        top-level calls take the overload policy's default (if armed).
        Expired work settles with ``overload.DEADLINE_RC`` at admission,
        dequeue, or the next mid-execution checkpoint.
        """
        if fn not in self.functions:
            raise KeyError(f"function {fn!r} not uploaded")
        pid = parent.id if parent is not None else None
        dl = self._resolve_deadline(deadline, parent)
        calls = []
        with self._mutex:
            for inp in inputs:
                call = Call(id=next(_call_ids), fn=fn, input=bytes(inp),
                            parent=pid, t_submit=tclock.now(), deadline=dl)
                self._calls[call.id] = call
                self._active.add(call.id)
                calls.append(call)
        self._dispatch_batch(calls, state_hint=state_hint)
        self._kick_monitor()
        return [c.id for c in calls]

    # -- overload control plane helpers ---------------------------------------

    def _count_overload(self, counter: str) -> None:
        with self._mutex:
            setattr(self, counter, getattr(self, counter) + 1)

    def _breaker_allows(self, host_id: str) -> bool:
        """Scheduler-side breaker consult.  Disarmed: one pointer compare."""
        brs = self._breakers
        if brs is None:
            return True
        br = brs.get(host_id)
        return br is None or br.allow()

    def _admit_expired(self, call: Call) -> bool:
        """Admission-time deadline gate: settle already-expired work with
        DEADLINE_RC before it touches a host queue.  True = rejected."""
        dl = call.deadline
        if dl is None or not dl.expired():
            return False
        self._count_overload("deadline_total")
        self._finish_call(call, rc=oload.DEADLINE_RC, status="deadline",
                          error="deadline expired before admission")
        return True

    def _spill_or_shed(self, call: Call, tried: set) -> None:
        """A bounded host queue refused ``call``: spill down the rendezvous
        ranking to the first peer with room (admission policy permitting),
        else settle fast with SHED_RC.  Shed calls never wait — failing in
        microseconds is the point."""
        ovl = self.overload
        mode = ovl.admission.on_full(call) if ovl is not None else "spill"
        if mode == "spill":
            peers = [h for h in self.alive_hosts()
                     if h.id not in tried and h.has_room()
                     and self._breaker_allows(h.id)]
            # rendezvous order (crc32 max wins) keeps the spill target for
            # a given call stable regardless of which host refused it first
            peers.sort(key=lambda h: zlib.crc32(f"{call.id}@{h.id}".encode()),
                       reverse=True)
            for h in peers:
                try:
                    self._assign_epoch(call)
                    h.submit(call)
                    self._count_overload("spill_total")
                    return
                except oload.QueueFull:
                    tried.add(h.id)
                except Exception:
                    tried.add(h.id)
        self._count_overload("shed_total")
        self._finish_call(call, rc=oload.SHED_RC, status="shed",
                          error="admission queue full, no peer had room")

    @staticmethod
    def _rank_holders(state_hint: List[str], holders: List[Host]) -> List[Host]:
        """Order replica holders for a batch: consistent-hash pinning.

        Each hint key is pinned to one holder by rendezvous hashing
        (``crc32(key@host)`` max wins), so the same key lands on the same
        holder batch after batch — its replica stays hot there instead of
        being re-warmed round-robin across the holder set.  Holders are
        ranked by how many of the batch's keys pin to them (tie-broken by
        the hash itself, keeping the order deterministic)."""
        votes = {h.id: 0 for h in holders}
        for k in state_hint:
            win = max(holders,
                      key=lambda h: zlib.crc32(f"{k}@{h.id}".encode()))
            votes[win.id] += 1
        return sorted(
            holders,
            key=lambda h: (votes[h.id],
                           zlib.crc32(f"{state_hint[0]}@{h.id}".encode())),
            reverse=True)

    def _dispatch_batch(self, calls: List[Call],
                        state_hint: Optional[List[Any]] = None) -> None:
        """Place a homogeneous batch with one warm-set resolution.

        Single calls keep the full Omega placement; for a fan-out the warm
        host set is read once and the batch round-robins across it, so
        thousand-call waves don't pay a placement lookup per call.  When the
        batch declares the state keys it touches (``state_hint``), warm
        hosts already holding replicas of those keys are preferred: the
        keys are **pinned** to holders by consistent hashing (rendezvous —
        stable across batches, so a key's replica stays hot on one host)
        and each call goes to the first pinned holder with capacity
        (``has_capacity`` is re-read per call, so an over-capacity batch
        spills down the pinned ranking instead of queueing blindly).

        A *per-call* hint (one entry per call — key, key list, or ``None``)
        pins each call by **its own** keys' rendezvous ranking rather than
        the batch vote, so fan-outs over disjoint keys shard across the
        holder set — call i chasing ``"a"`` lands where ``"a"``'s replica
        is hot even while call j chasing ``"b"`` lands elsewhere.  Only
        when nobody holds anything does the batch fall back to
        round-robining the warm pool."""
        if not calls:
            return
        if len(calls) == 1 and not state_hint:
            self._dispatch(calls[0])
            return
        fn = calls[0].fn
        alive = self.alive_hosts()
        if not alive:
            for c in calls:
                self._finish_call(c, status="failed", error="no alive hosts")
            return
        # breaker-aware entry choice: a cold batch registers its warm set on
        # the entry host, so picking a tripped host here would park the whole
        # fan-out behind an open breaker (fail open when every breaker is)
        candidates = alive
        if self._breakers is not None:
            allowed = [h for h in alive if self._breaker_allows(h.id)]
            if allowed:
                candidates = allowed
        entry = candidates[next(self._rr) % len(candidates)]
        sched = self.schedulers[entry.id]
        pool = [self.hosts[h] for h in sched.warm_hosts(fn)
                if h in self.hosts and self.hosts[h].alive]
        if not pool:
            sched.register_warm(fn)          # batch cold-starts on the entry
            pool = [entry]
        # batch-aware warm-set growth: a fan-out bigger than the pool's free
        # executor capacity cold-starts additional alive hosts (registering
        # them warm) instead of piling the whole batch behind a handful of
        # busy executors — without this the warm set never grows past the
        # first entry host and a 6-host cluster serves fan-outs at the
        # concurrency of one
        def free_slots():
            return sum(max(0, h.capacity - h._inflight) for h in pool)
        if len(calls) > free_slots():
            in_pool = {h.id for h in pool}
            for h in candidates:
                if h.id not in in_pool:
                    self.schedulers[h.id].register_warm(fn)
                    pool.append(h)
                    in_pool.add(h.id)
                    if len(calls) <= free_slots():
                        break
        # circuit breakers: open hosts leave the candidate pool; if every
        # candidate is open, fail open and keep the pool (refusing all
        # placement would turn a breaker trip into a total outage)
        if self._breakers is not None:
            allowed = [h for h in pool if self._breaker_allows(h.id)]
            if allowed:
                pool = allowed
        # hint shape: flat list = one key set for the whole batch; any
        # list/tuple/None entry = per-call hints, one entry per call
        per_call = None
        flat_hint: List[str] = []
        if state_hint:
            if any(isinstance(h, (list, tuple)) or h is None
                   for h in state_hint):
                per_call = [([h] if isinstance(h, str) else list(h or []))
                            for h in state_hint]
                flat_hint = [k for ks in per_call for k in ks]
            else:
                flat_hint = list(state_hint)
        pinned = None
        holders: List[Host] = []
        if flat_hint:
            holders = [h for h in pool
                       if any(h.local_tier.has(k) for k in flat_hint)]
            if holders and per_call is None:
                pinned = self._rank_holders(flat_hint, holders)
        rank_cache: dict = {}
        n = len(pool)
        for i, c in enumerate(calls):
            if self._admit_expired(c):
                continue
            c.attempts += 1
            self._assign_epoch(c)
            ranked = pinned
            if per_call is not None and holders:
                keys = tuple(per_call[i]) if i < len(per_call) else ()
                if keys:
                    ranked = rank_cache.get(keys)
                    if ranked is None:
                        # prefer hosts already holding *this call's* keys;
                        # a cold key still rendezvous-pins among the batch
                        # holders so it warms on one stable host
                        own = [h for h in holders
                               if any(h.local_tier.has(k) for k in keys)]
                        ranked = self._rank_holders(list(keys), own or holders)
                        rank_cache[keys] = ranked
                else:
                    ranked = None
            if ranked is not None:
                # first pinned holder with capacity; when every holder is
                # saturated, round-robin the queueing across the holder set
                # (locality kept) instead of piling on the top-ranked one
                target = next((h for h in ranked if h.has_capacity()),
                              ranked[i % len(ranked)])
            else:
                target = pool[i % n]
            try:
                target.submit(c)
            except oload.QueueFull:
                self._spill_or_shed(c, {target.id})
            except Exception:
                self._dispatch(c)            # full path: re-place or fail

    def _assign_epoch(self, call: Call) -> None:
        """Stamp this physical dispatch with a fresh fence epoch, always
        drawn from the primary call's allocator (twins share the fence)."""
        owner = call
        if call.primary_id is not None:
            owner = self._calls.get(call.primary_id, call)
        call.fence_epoch = owner.alloc_epoch()

    def _retry_backoff(self, attempts: int) -> None:
        """Exponential re-dispatch delay: attempt n waits backoff·2^(n-1),
        capped at 250 ms so a lost host never stalls recovery for long."""
        if self.backoff > 0.0 and attempts > 0:
            time.sleep(min(self.backoff * (2 ** (attempts - 1)), 0.25))

    def _dispatch(self, call: Call) -> None:
        if self._admit_expired(call):
            return
        alive = self.alive_hosts()
        if not alive:
            self._finish_call(call, status="failed", error="no alive hosts")
            return
        # round-robin entry point, then Omega placement (§5.1)
        entry = alive[next(self._rr) % len(alive)]
        target = self.schedulers[entry.id].place(call)
        if not target.alive:
            target = entry
        if not self._breaker_allows(target.id):
            # open breaker: reroute to any closed/half-open host; if every
            # breaker is open, fail open and keep the placement
            rerouted = next((h for h in alive if h.id != target.id
                             and self._breaker_allows(h.id)), None)
            if rerouted is not None:
                target = rerouted
        call.attempts += 1
        self._assign_epoch(call)
        try:
            target.submit(call)
        except oload.QueueFull:
            self._spill_or_shed(call, {target.id})
        except Exception as e:
            # target died between placement and submit: retry elsewhere, and
            # never leave the call pending (a waiter would hang forever)
            rb = self._retry_budget
            if call.attempts < self.max_attempts and \
                    (rb is None or rb.try_spend()):
                self._retry_backoff(call.attempts)
                self._dispatch(call)
            else:
                self._finish_call(call, status="failed",
                                  error=f"dispatch failed: {e!r}")

    def wait(self, call_id: int, timeout: Optional[float] = None) -> int:
        """Block until the call completes.  Event-driven: latency is bounded
        by the work itself, not by a polling granularity."""
        call = self._calls[call_id]
        if not call.event.wait(timeout=timeout):
            raise TimeoutError(f"call {call_id} timed out")
        return call.return_code

    def wait_all(self, call_ids, timeout: Optional[float] = None) -> List[int]:
        """Wait for a batch of calls on one shared completion latch.

        Returns the calls' return codes in the order given; per-call failures
        are isolated (a failed call yields its nonzero code, others still
        complete).  On timeout raises :class:`BatchTimeout`, whose
        ``pending``/``done`` payload names exactly which calls are still
        outstanding and what the rest returned."""
        ids = list(call_ids)
        calls = [self._calls[cid] for cid in ids]
        latch = CompletionLatch(len(calls))
        for c in calls:
            c.add_done_callback(latch.count_down)
        if not latch.wait(timeout):
            pending = [c.id for c in calls if not c.event.is_set()]
            if pending:
                done = {c.id: c.return_code for c in calls
                        if c.event.is_set()}
                raise BatchTimeout(pending, done, timeout)
        return [c.return_code for c in calls]

    # -- completion (the single exit path for every call) ---------------------

    def _finish_call(self, call: Call, *, rc: Optional[int] = None,
                     status: str = "failed", error: str = "",
                     t_end: Optional[float] = None) -> None:
        """Settle ``call`` exactly once: write the final result fields, fire
        its event + callbacks, and adopt a winning twin's result into its
        primary.  Late completions (straggler finishing after its twin was
        adopted) are no-ops."""
        def mutate(c: Call) -> None:
            if rc is not None:
                c.return_code = rc
            c.status = status
            if error:
                c.error = error
            c.t_end = t_end if t_end is not None else tclock.now()

        first = call._settle(mutate)
        tel = _TEL
        if tel is not None and first:
            tel.instant("call.settle", "call", call=call.id,
                        fence=call.fence_id, epoch=call.fence_epoch,
                        host=call.host, status=call.status,
                        queue_wait=call.queue_wait,
                        exec_wall=call.exec_wall)
        with self._mutex:
            self._active.discard(call.id)
        # overload plane feedback (both hooks are one pointer compare when
        # disarmed): successes refill the retry budget, and every attributable
        # outcome feeds the executing host's circuit breaker.  Shed/deadline
        # settles say nothing about host health and are excluded.
        if first:
            rb = self._retry_budget
            if rb is not None and call.status == "done":
                rb.on_success()
            brs = self._breakers
            if brs is not None and call.host is not None \
                    and call.status in ("done", "failed"):
                br = brs.get(call.host)
                if br is not None:
                    br.record(call.status == "done")
        # exactly-once: the winning settle seals the call's fence, so any
        # still-running attempt (a speculative loser, a zombie on a host
        # declared dead) gets its remaining pushes rejected by the tier
        if first and call.status == "done" and call.fence_epoch:
            self.global_tier.fence_seal(call.fence_id, call.fence_epoch)
        # speculation cleanup: the first 'done' of a speculative pair cancels
        # the counterpart, so the straggler stops at its next host-interface
        # checkpoint instead of running to completion in an executor slot
        if first and call.status == "done":
            other_id = call.twin_id if call.twin_id is not None \
                else call.primary_id
            other = self._calls.get(other_id) if other_id is not None else None
            if other is not None:
                other.cancel_event.set()
        if call.primary_id is not None and call.status == "done":
            primary = self._calls.get(call.primary_id)
            if primary is not None:
                def adopt(p: Call) -> None:
                    p.output = call.output
                    p.return_code = call.return_code
                    p.status = "done"
                    p.t_end = call.t_end

                primary._settle(adopt)
                with self._mutex:
                    self._active.discard(primary.id)

    def output(self, call_id: int) -> bytes:
        return self._calls[call_id].output

    def call(self, call_id: int) -> Call:
        return self._calls[call_id]

    # -- fault tolerance -----------------------------------------------------------

    def fail_host(self, host_id: str) -> None:
        """Kill a host; in-flight calls are re-executed elsewhere."""
        h = self.hosts[host_id]
        h.fail()
        brs = self._breakers
        if brs is not None and host_id in brs:
            brs[host_id].trip()          # dead host: breaker opens outright
        self.schedulers[host_id].deregister_warm(host_id)
        self._requeue_lost(host_id)

    def _requeue_lost(self, host_id: str) -> None:
        with self._mutex:
            lost = [c for c in self._calls.values()
                    if c.host == host_id and not c.event.is_set()]
        rb = self._retry_budget
        for c in lost:
            if c.attempts >= self.max_attempts:
                self._finish_call(
                    c, status="failed",
                    error=f"host {host_id} lost, retries exhausted")
            elif rb is not None and not rb.try_spend():
                # retry budget dry: a fault storm must not amplify into a
                # retry storm — settle failed immediately, no backoff loop
                self._finish_call(
                    c, status="failed",
                    error=f"host {host_id} lost, retry budget exhausted")
            else:
                # fence off the lost attempt BEFORE re-dispatching: any
                # straggling push from the dead host's epoch (e.g. a frame
                # delayed on the wire) must lose to the re-execution
                if c.fence_epoch:
                    self.global_tier.fence_supersede(c.fence_id,
                                                     c.fence_epoch)
                c.status = "pending"
                c.host = None
                self._retry_backoff(c.attempts)
                self._dispatch(c)

    def _speculate(self, call: Call) -> bool:
        """Straggler mitigation: duplicate the call; first completion wins."""
        others = [h for h in self.alive_hosts()
                  if h.id != call.host and h.has_capacity()]
        if not others:
            return False
        twin = Call(id=next(_call_ids), fn=call.fn, input=call.input,
                    parent=call.parent, t_submit=tclock.now())
        twin.attempts = call.attempts
        twin.primary_id = call.id
        # the twin writes state under the primary's fence with its own
        # epoch: whichever attempt settles first seals the fence, and the
        # loser's in-flight pushes are dropped instead of double-applied
        twin.fence_epoch = call.alloc_epoch()
        with self._mutex:
            self._calls[twin.id] = twin
            self._active.add(twin.id)
        call.twin_id = twin.id
        others[0].submit(twin)
        return True

    def monitor_once(self, timeout: Optional[float] = None) -> List[str]:
        """Heartbeat sweep: declare silent hosts dead, requeue their calls."""
        timeout = timeout if timeout is not None else self.heartbeat_timeout
        if timeout is None:
            return []
        now = time.monotonic()
        dead = []
        for h in list(self.hosts.values()):
            if h.alive and now - h.heartbeat > timeout and \
                    h._inflight > 0:
                h.fail()
                self.schedulers[h.id].deregister_warm(h.id)
                self._requeue_lost(h.id)
                dead.append(h.id)
        return dead

    # -- background monitor (event-driven lifecycle, no waiter spinning) -------

    def _kick_monitor(self) -> None:
        with self._monitor_cv:
            self._monitor_cv.notify_all()

    def _monitor_interval(self) -> float:
        iv = 0.25
        if self.heartbeat_timeout:
            iv = min(iv, self.heartbeat_timeout / 4)
        if self.straggler_timeout:
            iv = min(iv, self.straggler_timeout / 4)
        return max(iv, 0.01)

    def _monitor_loop(self) -> None:
        while True:
            with self._mutex:
                idle = not self._active
            with self._monitor_cv:
                if self._monitor_stop:
                    return
                self._monitor_cv.wait(0.5 if idle else self._monitor_interval())
                if self._monitor_stop:
                    return
            try:
                self._monitor_sweep()
            except Exception:                    # never let the monitor die
                pass

    def _monitor_sweep(self) -> None:
        self.monitor_once()
        with self._mutex:
            active = [self._calls[cid] for cid in self._active
                      if cid in self._calls]
        # calls stranded on hosts that died without a requeue (e.g. a direct
        # Host.fail) are re-dispatched here
        stranded_hosts = set()
        for c in active:
            if c.host is not None and not c.event.is_set():
                h = self.hosts.get(c.host)
                if h is not None and not h.alive:
                    stranded_hosts.add(c.host)
        for hid in stranded_hosts:
            self._requeue_lost(hid)
        # straggler speculation: duplicate long-running calls (twins adopt
        # their result into the primary on completion)
        if self.straggler_timeout:
            now = tclock.now()
            for c in active:
                if (c.twin_id is None and c.primary_id is None
                        and c.status == "running" and not c.event.is_set()
                        and now - c.t_start > self.straggler_timeout):
                    self._speculate(c)

    # -- virtual networking (host interface sockets) ----------------------------------

    def deliver_network(self, src: str, dst: str, data: bytes) -> None:
        self._net[(dst, src)].put(data)

    def receive_network(self, host: str, peer: str, max_len: int) -> bytes:
        try:
            data = self._net[(host, peer)].get(timeout=1.0)
        except queue.Empty:
            return b""
        return data[:max_len]

    # -- metrics --------------------------------------------------------------------

    def billable_gb_seconds(self) -> float:
        return sum(h.billable_byte_seconds for h in self.hosts.values()) / 1e9

    def transfer_bytes(self) -> int:
        return self.global_tier.total_transfer()

    def _publish_metrics(self, reg: tmetrics.Registry) -> None:
        """Scrape-time collector: snapshot the fabric's lock-local counters
        into registry gauges.  Runs on every ``collect()`` (metrics_text,
        snapshot, cold_start_stats, the serve /metrics endpoint) — never on
        a hot path."""
        hosts = list(self.hosts.values())
        g = reg.gauge

        def _sum(attr):
            return sum(getattr(h, attr) for h in hosts)

        g("faasm_host_cold_starts_total",
          "proto-Faaslet restores from scratch").set(_sum("cold_starts"))
        g("faasm_host_warm_hits_total",
          "calls served from the warm pool").set(_sum("warm_hits"))
        g("faasm_host_resets_total",
          "§5.2 post-call dirty resets").set(_sum("resets"))
        g("faasm_host_reset_pages",
          "dirty pages re-stamped across resets").set(_sum("reset_pages"))
        g("faasm_host_reclaimed_pages",
          "dirty pages madvised back (CoW)").set(_sum("reclaimed_pages"))
        g("faasm_host_retained_pages",
          "dirty pages re-stamped, kept resident").set(_sum("retained_pages"))
        g("faasm_host_cancelled_execs_total",
          "speculative losers stopped early").set(_sum("cancelled_execs"))
        g("faasm_runtime_calls_done_total").set(_sum("calls_done"))
        g("faasm_host_billable_byte_seconds",
          "§6.1 billable memory integral").set(_sum("billable_byte_seconds"))
        with self._mutex:
            occupancy = sum(
                sum(len(fl) for fl in h._warm.values()) for h in hosts)
        g("faasm_host_warm_pool_count",
          "Faaslets resident in warm pools").set(occupancy)
        # init times: feed only the not-yet-scraped tail of each host's
        # init_seconds into the histogram (collectors run repeatedly)
        hist = reg.histogram("faasm_host_init_ms",
                             "proto restore + module init wall time")
        for h in hosts:
            seen = self._init_pub.get(h.id, 0)
            tail = h.init_seconds[seen:]
            self._init_pub[h.id] = seen + len(tail)
            for s in tail:
                hist.observe(1e3 * s)

        gt = self.global_tier
        g("faasm_tier_net_bytes",
          "wire bytes moved through the global tier").set(gt.total_transfer())
        g("faasm_tier_copied_bytes",
          "bytes served host-local (zero-copy path)").set(gt.total_copied())
        g("faasm_tier_broadcast_bytes",
          "wire bytes fanned out to subscribers").set(gt.total_broadcast())
        g("faasm_tier_fence_rejections_total",
          "pushes refused by the attempt fence").set(gt.fence_rejections)

        tiers = [h.local_tier for h in hosts]
        for h in hosts:
            with h._mutex:
                tiers.extend(h._container_tiers.values())
        g("faasm_wire_codec_fallbacks_total",
          "int8 encodes rescued by the exact wire").set(
              sum(t.codec_fallbacks for t in tiers))
        g("faasm_wire_policy_flips_total",
          "damped WirePolicy wire switches").set(
              sum(t.policy_flips() for t in tiers))

        # wire cost model (docs/observability.md "Wire cost-model gauges"):
        # disarmed (the default) publishes nothing — one None check
        cost = _wire_mod._COST
        if cost is not None:
            snap = cost.snapshot()
            g("faasm_wire_cost_samples_total",
              "encode/transfer observations folded into the model").set(
                  cost.samples)
            for wire_name, buckets in snap.items():
                for bucket, (enc_ns, rest_ns) in buckets.items():
                    g(f"faasm_wire_cost_{wire_name}_b{bucket}_encode_us",
                      "EWMA encode cost at 2^b value bytes").set(
                          enc_ns / 1e3)
                    g(f"faasm_wire_cost_{wire_name}_b{bucket}_rest_us",
                      "EWMA non-encode push cost at 2^b value bytes").set(
                          rest_ns / 1e3)

        # overload control plane (docs/observability.md "Overload metrics")
        with self._mutex:
            shed, dl_n, spill = (self.shed_total, self.deadline_total,
                                 self.spill_total)
        g("faasm_overload_shed_total",
          "calls refused at admission (SHED_RC)").set(shed)
        g("faasm_overload_deadline_total",
          "calls settled DEADLINE_RC (admission/dequeue/mid-exec)").set(dl_n)
        g("faasm_overload_spill_total",
          "full-queue admissions spilled to a peer").set(spill)
        g("faasm_overload_rejected_submits_total",
          "bounded-queue refusals at Host.submit").set(
              _sum("rejected_submits"))
        g("faasm_overload_queue_depth_count",
          "calls queued beyond running capacity, cluster-wide").set(
              sum(h.queue_depth() for h in hosts))
        rb = self._retry_budget
        if rb is not None:
            g("faasm_overload_retry_budget_ratio",
              "retry token bucket fullness").set(rb.fill_ratio())
            g("faasm_overload_retry_denied_total",
              "retries refused by the exhausted budget").set(rb.denied_total)
        brs = self._breakers
        if brs is not None:
            g("faasm_overload_breaker_open_total",
              "circuit-breaker trips across hosts").set(
                  sum(b.opened_total for b in brs.values()))
        g("faasm_overload_bcast_coalesced_total",
          "broadcast frames collapsed to a newer same-key frame").set(
              gt.bcast_coalesced)
        g("faasm_overload_bcast_dropped_total",
          "subscribers dropped to pull-repair by queue overflow").set(
              gt.bcast_dropped)

        plan = faults.active()
        if plan is not None:
            g("faasm_faults_hits_total",
              "fault rules triggered by the armed plan").set(plan.fired())

    def metrics_text(self) -> str:
        """Prometheus text exposition of this runtime's registry (scrapes
        the collector first) — same body the serve ``--metrics-port``
        endpoint returns."""
        return self.metrics.render_text()

    def cold_start_stats(self) -> dict:
        """Cold-start/reset statistics, read through the metrics registry
        (one source of truth with metrics_text and the benchmarks).
        Counts are exact; init_p99_ms is the registry histogram's
        log-bucketed percentile (≤ ~2.2 % relative error)."""
        self.metrics.collect()
        m = self.metrics.get

        def _g(name):
            inst = m(name)
            return int(inst.value) if inst is not None else 0

        hist = m("faasm_host_init_ms")
        return {
            "cold_starts": _g("faasm_host_cold_starts_total"),
            "warm_hits": _g("faasm_host_warm_hits_total"),
            "init_mean_ms": (hist.sum / hist.count
                             if hist is not None and hist.count else 0.0),
            "init_p99_ms": (hist.percentile(0.99)
                            if hist is not None and hist.count else 0.0),
            "resets": _g("faasm_host_resets_total"),
            "reset_pages": _g("faasm_host_reset_pages"),
            "reclaimed_pages": _g("faasm_host_reclaimed_pages"),
            "retained_pages": _g("faasm_host_retained_pages"),
        }

    def shutdown(self) -> None:
        with self._monitor_cv:
            self._monitor_stop = True
            self._monitor_cv.notify_all()
        self._monitor_thread.join(timeout=5.0)
        for h in self.hosts.values():
            if h.alive:
                h.drain()
        self.global_tier.close()         # stop the broadcast pump threads
