"""Omega-style distributed shared-state scheduler (Faasm §5.1).

Every host runs a *local scheduler*.  The set of warm hosts per function is
**shared state living in the global tier** (key ``sched/warm/<fn>``); each
scheduler reads and updates it while making a placement decision — the Omega
optimistic-concurrency pattern.

The warm set is a **delta-record log**: registration appends one ``+host``
record and deregistration one ``-host`` record via the tier's atomic
``append`` (stripe-lock only — no global key lock, no whole-list JSON
rewrite on the registration path).  Readers replay the log, and compact it
back to one record per member (under the tier's atomic ``rewrite``) once the
log outgrows the membership.

Placement policy (paper §5.1): execute locally if warm with capacity; else
share with a warm host; else cold-start locally and register warm.  The
sharing queue doubles as the work-stealing channel used for straggler
mitigation.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

WARM_PREFIX = "sched/warm/"
_COMPACT_SLACK = 8          # compact when records exceed membership by this


def _replay(raw: bytes) -> Tuple[List[str], int]:
    """Replay a delta-record log; returns (sorted members, record count)."""
    members = {}
    n = 0
    for rec in raw.decode().split("\n"):
        if not rec:
            continue
        n += 1
        op, host = rec[0], rec[1:]
        if op == "+":
            members[host] = True
        elif op == "-":
            members.pop(host, None)
    return sorted(members), n


def _encode(hosts: List[str]) -> bytes:
    return "".join(f"+{h}\n" for h in hosts).encode()


class LocalScheduler:
    def __init__(self, host, runtime):
        self.host = host
        self.runtime = runtime
        # warm-set read cache, invalidated by the key's write version in the
        # global tier — placement on the hot path skips the log replay
        # unless some scheduler actually changed the set.
        self._warm_cache = {}                   # fn -> (version, hosts)

    # -- warm-set shared state --------------------------------------------------

    def _warm_key(self, fn: str) -> str:
        return WARM_PREFIX + fn

    def warm_hosts(self, fn: str) -> List[str]:
        gt = self.runtime.global_tier
        key = self._warm_key(fn)
        ver = gt.version(key)
        cached = self._warm_cache.get(fn)
        if cached is not None and cached[0] == ver:
            return cached[1]
        if not gt.exists(key):
            hosts: List[str] = []
        else:
            hosts, n_records = _replay(gt.get(key, host=self.host.id))
            if n_records > len(hosts) + _COMPACT_SLACK:
                # the log outgrew the membership: compact it atomically.
                # Cache against the version rewrite itself stamped — an
                # append racing in right after must invalidate this cache.
                raw, ver = gt.rewrite(
                    key, lambda cur: _encode(_replay(cur)[0]),
                    host=self.host.id)
                hosts, _ = _replay(raw)
        self._warm_cache[fn] = (ver, hosts)
        return hosts

    def register_warm(self, fn: str) -> None:
        if self.host.id in self.warm_hosts(fn):
            return                              # already a member: no record
        gt = self.runtime.global_tier
        gt.append(self._warm_key(fn), f"+{self.host.id}\n".encode(),
                  host=self.host.id)

    def deregister_warm(self, host_id: str, fn: Optional[str] = None) -> None:
        gt = self.runtime.global_tier
        keys = ([self._warm_key(fn)] if fn else
                [k for k in gt.keys() if k.startswith(WARM_PREFIX)])
        for key in keys:
            if gt.exists(key):
                gt.append(key, f"-{host_id}\n".encode(), host=host_id)

    # -- placement ---------------------------------------------------------------

    def place(self, call) -> "Host":
        """Choose the executing host for ``call`` (may be self).

        Alongside liveness and capacity, placement consults the runtime's
        per-host circuit breakers (``repro_torch.overload.CircuitBreaker``): a
        host whose breaker is open left the warm candidate set until a
        half-open probe readmits it.  Disarmed (no breakers configured) the
        consult is one pointer compare per candidate.  If *every* warm host
        is breaker-open the unfiltered set is kept — placement fails open
        rather than turning breaker trips into a total outage."""
        rt = self.runtime
        warm = [h for h in self.warm_hosts(call.fn)
                if h in rt.hosts and rt.hosts[h].alive]
        admitted = [h for h in warm if rt._breaker_allows(h)]
        if admitted:
            warm = admitted
        me = self.host
        if me.id in warm and me.has_capacity():
            return me
        # share with another warm host that has capacity
        for hid in warm:
            h = rt.hosts[hid]
            if h is not me and h.has_capacity():
                return h
        if me.id in warm:                      # warm but saturated: queue locally
            return me
        if warm:                               # all warm hosts saturated
            return rt.hosts[warm[call.id % len(warm)]]
        # nobody warm: cold start locally, register in the shared warm set
        self.register_warm(call.fn)
        return me
