"""Coordination key-value store — the substrate for distributed TWA.

A copy of the reference's ``repro/core/kvstore.py`` but for one repair:
``FileKVStore.compare_and_swap`` writes under the key's lock it holds,
where the reference's calls ``set``, which waits on that lock forever.

At cluster scale the analogue of "a cache line" is "a key on the coordination
service" (etcd/Zookeeper/jax.distributed's KV): every poll is a network RPC and
the service's per-key QPS is the scalability bottleneck, exactly as the
invalidation diameter is for a cache line.  The in-memory store counts per-key
reads/writes so benchmarks can measure hot-key load directly.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict


class InMemoryKVStore:
    """Thread-safe KV store with per-key telemetry (models the coordination
    service for single-process multi-worker tests and benchmarks)."""

    def __init__(self) -> None:
        self._data: dict[str, int] = {}
        self._mutex = threading.Lock()
        self.read_counts: dict[str, int] = defaultdict(int)
        self.write_counts: dict[str, int] = defaultdict(int)

    def get(self, key: str, default: int = 0) -> int:
        with self._mutex:
            self.read_counts[key] += 1
            return self._data.get(key, default)

    def set(self, key: str, value: int) -> None:
        with self._mutex:
            self.write_counts[key] += 1
            self._data[key] = value

    def fetch_add(self, key: str, delta: int = 1) -> int:
        with self._mutex:
            self.write_counts[key] += 1
            old = self._data.get(key, 0)
            self._data[key] = old + delta
            return old

    def compare_and_swap(self, key: str, expected: int, new: int) -> int:
        with self._mutex:
            self.write_counts[key] += 1
            old = self._data.get(key, 0)
            if old == expected:
                self._data[key] = new
            return old

    # -- telemetry ----------------------------------------------------------
    def reset_counts(self) -> None:
        with self._mutex:
            self.read_counts.clear()
            self.write_counts.clear()

    def hot_keys(self, top: int = 5) -> list[tuple[str, int]]:
        with self._mutex:
            return sorted(self.read_counts.items(), key=lambda kv: -kv[1])[:top]


class FileKVStore:
    """File-backed KV store for *multi-process* coordination (launcher, ckpt
    arbitration).  One JSON file per key; RMW atomicity via an O_EXCL lockfile
    per key (NFS-safe enough for checkpoint-rate traffic)."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "__") + ".json")

    def _with_key_lock(self, key: str, fn):
        lockpath = self._path(key) + ".lock"
        while True:
            try:
                fd = os.open(lockpath, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                break
            except FileExistsError:
                time.sleep(0.001)
        try:
            return fn()
        finally:
            os.close(fd)
            os.unlink(lockpath)

    def get(self, key: str, default: int = 0) -> int:
        try:
            with open(self._path(key)) as f:
                return json.load(f)["v"]
        except (FileNotFoundError, json.JSONDecodeError):
            return default

    def _write(self, key: str, value: int) -> None:
        """Replace the key's file (the caller holds the key's lock)."""
        tmp = self._path(key) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"v": value}, f)
        os.replace(tmp, self._path(key))

    def set(self, key: str, value: int) -> None:
        self._with_key_lock(key, lambda: self._write(key, value))

    def fetch_add(self, key: str, delta: int = 1) -> int:
        def _do():
            old = self.get(key)
            self._write(key, old + delta)
            return old
        return self._with_key_lock(key, _do)

    def compare_and_swap(self, key: str, expected: int, new: int) -> int:
        # The reference calls set() here, which takes the key's lock file
        # again and spins on it forever; the write happens under the lock
        # already held.
        def _do():
            old = self.get(key)
            if old == expected:
                self._write(key, new)
            return old
        return self._with_key_lock(key, _do)
