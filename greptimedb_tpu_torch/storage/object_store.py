"""Object store abstraction (the JAX package's storage/object_store.py).
Backends: the local file system, memory (tests) and an LRU read cache over
either. The API is the minimal surface the engine needs: whole-object
read/write/delete/list plus ranged reads. The S3 backend needs a network
and raises UnsupportedError."""

from __future__ import annotations

import os
import threading

from dataclasses import dataclass

from greptimedb_tpu_torch import concurrency
from greptimedb_tpu_torch.errors import UnsupportedError

@dataclass
class ObjectMeta:
    path: str
    size: int


class ObjectStore:
    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        raise NotImplementedError

    def write(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str) -> list[ObjectMeta]:
        raise NotImplementedError

    # local filesystem path for readers that memory-map; the memory
    # backend raises.
    def local_path(self, path: str) -> str:
        raise NotImplementedError

    def local_read_path(self, path: str) -> str:
        """A local file holding this object's bytes, for zero-copy READS
        (mmap). Unlike local_path, implementations may serve a cached
        copy; writing through it is NOT meaningful."""
        return self.local_path(path)


class FsObjectStore(ObjectStore):
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _abs(self, path: str) -> str:
        p = os.path.normpath(os.path.join(self.root, path.lstrip("/")))
        assert p.startswith(self.root), f"path escapes root: {path}"
        return p

    def read(self, path: str) -> bytes:
        with open(self._abs(path), "rb") as f:
            return f.read()

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        with open(self._abs(path), "rb") as f:
            f.seek(offset)
            return f.read(length)

    def write(self, path: str, data: bytes) -> None:
        p = self._abs(path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        # unique temp name: concurrent writers on a SHARED store (wire
        # cluster datanodes) must not race each other's rename source.
        # The .tmp suffix stays LAST so list()'s filter keeps hiding
        # in-flight and crash-orphaned temps
        tmp = f"{p}.{os.getpid()}.{threading.get_native_id()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    def delete(self, path: str) -> None:
        try:
            os.remove(self._abs(path))
        except FileNotFoundError:
            pass

    def exists(self, path: str) -> bool:
        return os.path.exists(self._abs(path))

    def list(self, prefix: str) -> list[ObjectMeta]:
        base = self._abs(prefix)
        out: list[ObjectMeta] = []
        if not os.path.isdir(base):
            return out
        for dirpath, _dirs, files in os.walk(base):
            for name in files:
                if name.endswith(".tmp"):
                    continue
                full = os.path.join(dirpath, name)
                rel = os.path.relpath(full, self.root)
                out.append(ObjectMeta(rel.replace(os.sep, "/"),
                                      os.path.getsize(full)))
        out.sort(key=lambda m: m.path)
        return out

    def local_path(self, path: str) -> str:
        return self._abs(path)


class MemoryObjectStore(ObjectStore):
    def __init__(self):
        self._data: dict[str, bytes] = {}
        self._lock = concurrency.Lock()

    def read(self, path: str) -> bytes:
        with self._lock:
            return self._data[path]

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        with self._lock:
            return self._data[path][offset:offset + length]

    def write(self, path: str, data: bytes) -> None:
        with self._lock:
            self._data[path] = bytes(data)

    def delete(self, path: str) -> None:
        with self._lock:
            self._data.pop(path, None)

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._data

    def list(self, prefix: str) -> list[ObjectMeta]:
        with self._lock:
            return sorted(
                (ObjectMeta(p, len(d)) for p, d in self._data.items()
                 if p.startswith(prefix)),
                key=lambda m: m.path,
            )

    def local_path(self, path: str) -> str:
        raise NotImplementedError("memory store has no local paths")


class S3ObjectStore(ObjectStore):
    """S3-compatible backend: it needs a network, which the port does not
    reach; constructing one raises (object_store_from_options does too)."""

    def __init__(self, **_kwargs):
        raise UnsupportedError(
            "S3ObjectStore needs a network; the port keeps objects on the "
            "local file system (type = fs) or in memory (type = memory)")


class CachedObjectStore(ObjectStore):
    """LRU read cache + write-through layer over another store: reads fill
    a local directory bounded by max_bytes; writes land locally AND in the
    backing store, so cold restarts hit the cache and remote reads are
    skipped for hot objects."""

    def __init__(self, inner: ObjectStore, cache_dir: str,
                 max_bytes: int = 1024 * 1024 * 1024):
        import collections

        self.inner = inner
        self.cache_dir = cache_dir
        self.max_bytes = max_bytes
        self._lock = concurrency.Lock()
        self._lru: "collections.OrderedDict[str, int]" = (
            collections.OrderedDict()
        )
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        os.makedirs(cache_dir, exist_ok=True)
        # recover the cache index from disk (files named by path hash);
        # drop leftover .tmp files from interrupted writes
        for f in os.listdir(cache_dir):
            p = os.path.join(cache_dir, f)
            if f.endswith(".tmp"):
                try:
                    os.remove(p)
                except OSError:
                    pass
                continue
            if os.path.isfile(p):
                self._lru[f] = os.path.getsize(p)
                self._bytes += self._lru[f]

    def _key(self, path: str) -> str:
        import hashlib

        return hashlib.sha256(path.encode()).hexdigest()

    def _cache_put(self, path: str, data: bytes):
        key = self._key(path)
        p = os.path.join(self.cache_dir, key)
        with self._lock:
            old = self._lru.pop(key, 0)
            self._bytes -= old
            if old and len(data) > self.max_bytes:
                # an uncacheable update must also remove the stale file,
                # or a restart re-index would serve the OLD content
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass
            if len(data) <= self.max_bytes:
                tmp = p + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, p)
                self._lru[key] = len(data)
                self._bytes += len(data)
            while self._bytes > self.max_bytes and self._lru:
                k, sz = self._lru.popitem(last=False)
                self._bytes -= sz
                self._evictions += 1
                try:
                    os.remove(os.path.join(self.cache_dir, k))
                except FileNotFoundError:
                    pass

    def _cache_get(self, path: str) -> bytes | None:
        key = self._key(path)
        with self._lock:
            if key not in self._lru:
                self._misses += 1
                return None
            self._lru.move_to_end(key)
            self._hits += 1
        try:
            with open(os.path.join(self.cache_dir, key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            with self._lock:
                self._bytes -= self._lru.pop(key, 0)
            return None

    def _cache_drop(self, path: str):
        key = self._key(path)
        with self._lock:
            self._bytes -= self._lru.pop(key, 0)
        try:
            os.remove(os.path.join(self.cache_dir, key))
        except FileNotFoundError:
            pass

    def read(self, path: str) -> bytes:
        data = self._cache_get(path)
        if data is not None:
            return data
        data = self.inner.read(path)
        self._cache_put(path, data)
        return data

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        data = self._cache_get(path)
        if data is not None:
            return data[offset:offset + length]
        return self.inner.read_range(path, offset, length)

    def write(self, path: str, data: bytes) -> None:
        self.inner.write(path, data)
        self._cache_put(path, data)

    def delete(self, path: str) -> None:
        self.inner.delete(path)
        self._cache_drop(path)

    def exists(self, path: str) -> bool:
        key = self._key(path)
        with self._lock:
            if key in self._lru:
                return True
        return self.inner.exists(path)

    def list(self, prefix: str) -> list[ObjectMeta]:
        return self.inner.list(prefix)

    def local_path(self, path: str) -> str:
        return self.inner.local_path(path)

    def local_read_path(self, path: str) -> str:
        """Serve reads from the cache FILE (filling it on miss) so
        mmap-based readers skip the remote round-trip; uncacheable
        objects fall back to the inner store's own local path."""
        if self._cache_get(path) is None:
            data = self.inner.read(path)
            self._cache_put(path, data)
            if len(data) > self.max_bytes:
                return self.inner.local_path(path)  # may raise
        return os.path.join(self.cache_dir, self._key(path))


def object_store_from_options(storage: dict, data_root: str) -> ObjectStore:
    """Build the store the JAX package's [storage] section names: type
    fs|memory (s3 raises), optional cache_capacity_bytes wrapping it in
    the local read/write cache."""
    kind = str(storage.get("type", "fs")).lower()
    if kind == "fs":
        # storage.root overrides the node-local data_home: datanodes of
        # a wire cluster share one fs store so failed-over regions can
        # reopen their SSTs/manifest from the new owner
        inner: ObjectStore = FsObjectStore(
            storage.get("root") or data_root
        )
    elif kind == "memory":
        inner = MemoryObjectStore()
    elif kind == "s3":
        inner = S3ObjectStore()
    else:
        raise ValueError(f"unknown storage.type {kind!r}")
    cap = int(storage.get("cache_capacity_bytes", 0) or 0)
    if cap > 0 and kind != "fs":
        inner = CachedObjectStore(
            inner, os.path.join(data_root, ".object_cache"),
            max_bytes=cap,
        )
    return inner
