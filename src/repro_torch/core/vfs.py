"""Read-global / write-local virtual filesystem (Faasm §3.1).

Global files live in the global tier under ``fs::<path>`` (the object store);
writes land in a host-local overlay — functions can read shared library/model
files and write scratch output without filesystem isolation machinery
(no chroot / layered FS, per the paper).
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict

from repro_torch.state.kv import GlobalTier

_PREFIX = "fs::"


class VirtualFS:
    def __init__(self, global_tier: GlobalTier):
        self.global_tier = global_tier
        self._local: Dict[str, Dict[str, bytearray]] = defaultdict(dict)
        self._mutex = threading.RLock()

    def put_global(self, path: str, data: bytes) -> None:
        """Upload a file to the global object store (admin/upload service)."""
        self.global_tier.set(_PREFIX + path, bytes(data), host="upload")

    def exists(self, host_id: str, path: str) -> bool:
        with self._mutex:
            if path in self._local[host_id]:
                return True
        return self.global_tier.exists(_PREFIX + path)

    def read(self, host_id: str, path: str) -> bytes:
        with self._mutex:
            local = self._local[host_id].get(path)
            if local is not None:
                return bytes(local)
        return self.global_tier.get(_PREFIX + path, host=host_id)

    def write_local(self, host_id: str, path: str, data: bytes,
                    append: bool = False) -> None:
        with self._mutex:
            files = self._local[host_id]
            if append and path in files:
                files[path].extend(data)
            else:
                files[path] = bytearray(data)

    def drop_local(self, host_id: str) -> None:
        with self._mutex:
            self._local.pop(host_id, None)
