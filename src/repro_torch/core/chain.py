"""Chained-call helpers (the paper's chain/await loops, Listing 1 pattern)."""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

from repro_torch.overload import DEADLINE_RC


def chain(api, name: str, inputs: Sequence[bytes],
          deadline=None) -> List[int]:
    """Spawn one chained call per input; returns the call IDs (input order).

    ``deadline`` (a float budget in seconds or an ``overload.Deadline``)
    bounds the children end-to-end; omitted, they inherit the calling
    function's remaining deadline budget."""
    if hasattr(api, "chain_call_many"):
        return api.chain_call_many(name, list(inputs), deadline=deadline)
    return [api.chain_call(name, inp, deadline=deadline) for inp in inputs]


def await_all(api, call_ids: Iterable[int]) -> List[int]:
    """Block until every chained call finishes; returns their codes."""
    ids = list(call_ids)
    if hasattr(api, "await_all"):
        return api.await_all(ids)
    return [api.await_call(cid) for cid in ids]


def outputs(api, call_ids: Iterable[int]) -> List[bytes]:
    return [api.get_call_output(cid) for cid in call_ids]


def scatter_gather(api, name: str, inputs: Sequence[bytes], *,
                   retries: int = 1, deadline=None) -> List[Tuple[int, bytes]]:
    """Fan out one call per input and gather ``(return_code, output)`` pairs
    in input order, re-chaining failed children up to ``retries`` times.

    This is the *application-level* retry above the runtime's own
    re-execution: the runtime requeues calls lost to host failure (with
    attempt fencing keeping their state effects exactly-once), while this
    helper re-submits calls that **settled as failed** — e.g. shed by a
    degraded cluster or out of runtime retry budget.  A re-chained child is
    a fresh call with a fresh fence, so re-running it is safe by the same
    exactly-once argument.  Failures that persist through the budget are
    returned, not raised: per-input isolation, the caller decides.

    Deadline interplay: ``deadline`` bounds every child (first attempt and
    retries alike — the retries share the original absolute expiry, they do
    not restart the clock).  A child that settled with ``DEADLINE_RC`` is
    **not** re-chained: its end-to-end budget is spent, and re-submitting
    work that is already too late only deepens an overload.  Shed children
    (``SHED_RC``) stay retryable — a later wave may find room."""
    inputs = [bytes(i) for i in inputs]
    ids = chain(api, name, inputs, deadline=deadline)
    codes = await_all(api, ids)
    pending = [i for i, rc in enumerate(codes)
               if rc != 0 and rc != DEADLINE_RC]
    for _ in range(retries):
        if not pending:
            break
        retry_ids = chain(api, name, [inputs[i] for i in pending],
                          deadline=deadline)
        retry_codes = await_all(api, retry_ids)
        still = []
        for i, cid, rc in zip(pending, retry_ids, retry_codes):
            ids[i], codes[i] = cid, rc
            if rc != 0 and rc != DEADLINE_RC:
                still.append(i)
        pending = still
    return [(codes[i], api.get_call_output(ids[i])) for i in range(len(ids))]
