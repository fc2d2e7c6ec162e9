"""Distributed data objects (Faasm §4): typed fronts over the byte-array state API.

These mirror Listing 1 of the paper: ``SparseMatrixReadOnly`` /
``MatrixReadOnly`` pull only the state *chunks* backing the columns a function
touches; ``VectorAsync`` gives HOGWILD-style direct writes to a shared-region
pointer with sporadic ``push()`` to the global tier (eventual consistency);
``DistDict`` / ``Counter`` demonstrate strongly-consistent DDOs built with
global locks.
"""
from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np

META_SUFFIX = "::meta"


def _write_meta(gt, key: str, meta: dict) -> None:
    gt.set(key + META_SUFFIX, json.dumps(meta).encode(), host="upload")


def _read_meta(api, key: str) -> dict:
    return json.loads(bytes(api.get_state(key + META_SUFFIX, writable=False)))


class MatrixReadOnly:
    """Dense 2-D matrix stored column-major so column ranges are contiguous
    byte ranges — a ``columns`` access pulls only the covering chunks."""

    @staticmethod
    def create(global_tier, key: str, value: np.ndarray) -> None:
        value = np.asarray(value, np.float32)
        global_tier.set(key, np.asfortranarray(value).tobytes(order="F"),
                        host="upload")
        _write_meta(global_tier, key, {"shape": list(value.shape),
                                       "dtype": "float32"})

    def __init__(self, api, key: str):
        self.api = api
        self.key = key
        meta = _read_meta(api, key)
        self.shape: Tuple[int, int] = tuple(meta["shape"])
        self.itemsize = 4

    def columns(self, c0: int, c1: int) -> np.ndarray:
        """Read-only view of columns [c0, c1) — pulls only what is needed."""
        rows = self.shape[0]
        off = c0 * rows * self.itemsize
        length = (c1 - c0) * rows * self.itemsize
        raw = self.api.get_state_offset(self.key, off, length, writable=False)
        return np.frombuffer(bytes(raw), np.float32).reshape(
            rows, c1 - c0, order="F")


class SparseMatrixReadOnly:
    """CSC sparse matrix over three state values (data/indices/indptr)."""

    @staticmethod
    def create(global_tier, key: str, dense: np.ndarray) -> None:
        """The reference's CSC layout (nonzeros column by column, rows in
        order), built in one pass over the transposed matrix instead of a
        Python loop over columns: the same bytes."""
        dense = np.asarray(dense, np.float32)
        rows, cols = dense.shape
        by_col = np.ascontiguousarray(dense.T)
        cs, rs = np.nonzero(by_col)
        data = by_col[cs, rs]
        indptr = np.zeros(cols + 1, np.int64)
        np.cumsum(np.bincount(cs, minlength=cols), out=indptr[1:])
        global_tier.set(key + "::data", data.tobytes(), host="upload")
        global_tier.set(key + "::indices", rs.astype(np.int32).tobytes(),
                        host="upload")
        global_tier.set(key + "::indptr", indptr.tobytes(), host="upload")
        _write_meta(global_tier, key, {"shape": [rows, cols],
                                       "nnz": int(data.size)})

    def __init__(self, api, key: str):
        self.api = api
        self.key = key
        meta = _read_meta(api, key)
        self.shape = tuple(meta["shape"])
        self.nnz = meta["nnz"]
        self._indptr = np.frombuffer(
            bytes(api.get_state(key + "::indptr", writable=False)), np.int64)

    def columns(self, c0: int, c1: int):
        """Yield (col_idx, row_indices, values) for columns [c0, c1)."""
        p0, p1 = int(self._indptr[c0]), int(self._indptr[c1])
        vals = np.frombuffer(bytes(self.api.get_state_offset(
            self.key + "::data", p0 * 4, (p1 - p0) * 4, writable=False)),
            np.float32)
        idxs = np.frombuffer(bytes(self.api.get_state_offset(
            self.key + "::indices", p0 * 4, (p1 - p0) * 4, writable=False)),
            np.int32)
        for c in range(c0, c1):
            a, b = int(self._indptr[c] - p0), int(self._indptr[c + 1] - p0)
            yield c, idxs[a:b], vals[a:b]


class VectorAsync:
    """Shared f32 vector with lock-free local writes and sporadic push().

    The local view is a *pointer into the host-shared region*: co-located
    functions see each other's updates immediately (HOGWILD!).  ``push()``
    writes only dirty chunks to the global tier; consistency between tiers is
    eventual, as tolerated by SGD (paper §4.1).
    """

    @staticmethod
    def create(global_tier, key: str, value: np.ndarray) -> None:
        value = np.asarray(value, np.float32)
        global_tier.set(key, value.tobytes(), host="upload")
        _write_meta(global_tier, key, {"shape": list(value.shape),
                                       "dtype": "float32"})

    def __init__(self, api, key: str):
        self.api = api
        self.key = key
        meta = _read_meta(api, key)
        self.shape = tuple(meta["shape"])
        raw = api.get_state(key, writable=True)      # maps the shared region
        self._view = raw.view(np.float32)[:int(np.prod(self.shape))]

    @property
    def values(self) -> np.ndarray:
        return self._view

    def __getitem__(self, i):
        return self._view[i]

    def __setitem__(self, i, v):
        self._view[i] = v
        self.api._local().mark_dirty(self.key, 0, self._view.nbytes)

    def add(self, idx, delta) -> None:
        """Unlocked accumulate (HOGWILD) through the shared-region pointer."""
        np.add.at(self._view, idx, delta)
        self.api._local().mark_dirty(self.key, 0, self._view.nbytes)

    def _flush_if_copy(self) -> None:
        """Container isolation hands out *copies* (data shipping): mutations
        must be written back through set_state before a push — exactly the
        extra copy the paper's Knative baseline pays."""
        if getattr(self.api.host, "isolation", "faaslet") == "container":
            self.api.set_state(self.key,
                               np.asarray(self._view, np.float32).tobytes())

    def push(self) -> None:
        self._flush_if_copy()
        self.api.push_state_partial(self.key)

    def push_delta(self, wire: str = "auto") -> None:
        """Accumulating push — concurrent pushes from different hosts compose.

        ``wire="auto"`` (default) lets the key's adaptive ``WirePolicy``
        choose; ``"int8"`` forces the quantised ``kernels/state_push``
        frame (~¼ of the f32 bytes, error-feedback carried across pushes)
        and ``"exact"`` the f32 delta frame."""
        self._flush_if_copy()
        self.api.push_state_delta(self.key, dtype=np.float32, wire=wire)

    def pull(self, track_delta: bool = False, wire: str = None) -> None:
        """Refresh the local view.  Warm replicas refresh through the wire
        fabric (delta pull, ``wire`` as in :meth:`push_delta`); a replica
        subscribed via :meth:`subscribe` is typically already current and
        the pull moves zero bytes."""
        self.api.pull_state(self.key, track_delta=track_delta, wire=wire)
        raw = self.api.get_state(self.key, writable=True)
        self._view = raw.view(np.float32)[:int(np.prod(self.shape))]

    def subscribe(self) -> None:
        """Subscribe the host replica to peer push fan-out (Cloudburst-style
        push-based cache refresh): later pulls on this host are free unless
        a broadcast was missed."""
        self.api.subscribe_state(self.key)


class DistDict:
    """Strongly-consistent dict: global write locks around read-modify-write."""

    def __init__(self, api, key: str):
        self.api = api
        self.key = key

    def _load(self) -> dict:
        gt = self.api.runtime.global_tier
        if not gt.exists(self.key):
            return {}
        return json.loads(gt.get(self.key, host=self.api.host.id) or b"{}")

    def get(self, k, default=None):
        self.api.lock_state_global_read(self.key)
        try:
            return self._load().get(k, default)
        finally:
            self.api.unlock_state_global_read(self.key)

    def set(self, k, v) -> None:
        self.api.lock_state_global_write(self.key)
        try:
            d = self._load()
            d[k] = v
            self.api.runtime.global_tier.set(
                self.key, json.dumps(d).encode(), host=self.api.host.id)
        finally:
            self.api.unlock_state_global_write(self.key)


class Counter:
    """Atomic distributed counter (global write lock)."""

    def __init__(self, api, key: str):
        self.api = api
        self.key = key

    def increment(self, by: int = 1) -> int:
        gt = self.api.runtime.global_tier
        self.api.lock_state_global_write(self.key)
        try:
            cur = int(gt.get(self.key, host=self.api.host.id) or b"0") \
                if gt.exists(self.key) else 0
            cur += by
            gt.set(self.key, str(cur).encode(), host=self.api.host.id)
            return cur
        finally:
            self.api.unlock_state_global_write(self.key)

    def value(self) -> int:
        gt = self.api.runtime.global_tier
        if not gt.exists(self.key):
            return 0
        return int(gt.get(self.key, host=self.api.host.id))
