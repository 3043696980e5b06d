"""Entity blob store: in-memory LRU with optional disk spill (npz).

Plays the role of VDMS's TDB/visual-data store: decouples entity
payloads from metadata so the engine passes pointers, not pixels."""
from __future__ import annotations

import collections
import os
import threading

import numpy as np


class BlobStore:
    def __init__(self, capacity_bytes: int = 2 << 30,
                 spill_dir: str | None = None):
        self.capacity = capacity_bytes
        self.spill_dir = spill_dir
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._mem: collections.OrderedDict[str, np.ndarray] = collections.OrderedDict()
        self._bytes = 0
        self.spills = 0
        self.hits = 0
        self.misses = 0

    def put(self, key: str, arr) -> None:
        arr = np.asarray(arr)
        with self._lock:
            if key in self._mem:
                self._bytes -= self._mem.pop(key).nbytes
            self._mem[key] = arr
            self._bytes += arr.nbytes
            self._evict_locked()

    def get(self, key: str):
        with self._lock:
            if key in self._mem:
                self._mem.move_to_end(key)
                self.hits += 1
                return self._mem[key]
        path = self._path(key)
        if path and os.path.exists(path):
            with self._lock:
                self.misses += 1
            arr = np.load(path)["a"]
            self.put(key, arr)
            return arr
        raise KeyError(key)

    def delete(self, key: str):
        with self._lock:
            if key in self._mem:
                self._bytes -= self._mem.pop(key).nbytes
        path = self._path(key)
        if path and os.path.exists(path):
            os.remove(path)

    def _evict_locked(self):
        while self._bytes > self.capacity and len(self._mem) > 1:
            key, arr = self._mem.popitem(last=False)
            self._bytes -= arr.nbytes
            path = self._path(key)
            if path:
                np.savez_compressed(path, a=arr)
                self.spills += 1

    def _path(self, key: str) -> str | None:
        if not self.spill_dir:
            return None
        safe = key.replace("/", "_")
        return os.path.join(self.spill_dir, safe + ".npz")

    def __contains__(self, key: str) -> bool:
        with self._lock:
            if key in self._mem:
                return True
        path = self._path(key)
        return bool(path and os.path.exists(path))
