"""Query sessions: device-resident result buffers across polls (the JAX
package's query/sessions.py).

The grid caches (query/device_range.py, promql/fast.py) keep a table's
input state on the card; this registry keeps the folded result of one
query shape there too, so a repeated dashboard poll skips the program
(and its kernel launches) altogether, and a `since` delta poll narrows
the resident buffer on the card before anything is read back
(query/readback.read_delta).

Keyed by (table key, shape key) and validated by a version: the grid
entry's data version when the buffer was produced, so a write, truncate
or ALTER invalidates by comparison; the grid caches purge an entry's
buffers whenever they drop the entry (`DeviceRangeCache._release`,
`SelectorGridCache._release`), and an entry collected without a drop
(its engine went away) is purged before the registry answers again
(`put(owner=)`), so an id() reused by a later entry never meets a stale
buffer. A buffer is a tensor or a list of tensors (the
parts of a sharded result) that the program owns: nothing a later launch
writes. Bounded by an LRU byte budget (1 GiB) and an entry cap (512).

The JAX package's `gtpu_session_*` metrics and its memory pool wait for
the telemetry (ROADMAP A9); their tallies are the registry's own
attributes (`hits`, `misses`, `evictions`, `byte_count`, `entry_count`).

The `since` cursor lives here too: the protocol layer binds the client's
watermark (HTTP `since`) and the execution paths emit only rows whose
time index is strictly greater.
"""

from __future__ import annotations

import contextvars
import weakref
from collections import OrderedDict

from greptimedb_tpu_torch import concurrency

_DEFAULT_BYTES = 1 * 1024**3
# an entry cap beside the byte budget: result buffers can be tiny, and a
# stream of distinct query shapes must not pin thousands of them
_MAX_ENTRIES = 512


def buffer_nbytes(buf) -> int:
    """Device bytes of a buffer: a tensor or a list of tensors."""
    if isinstance(buf, (list, tuple)):
        return sum(int(t.numel() * t.element_size()) for t in buf)
    return int(buf.numel() * buf.element_size())


class SessionRegistry:
    """LRU byte-budgeted registry of device result buffers."""

    def __init__(self, max_bytes: int = _DEFAULT_BYTES, enabled: bool = True):
        self.max_bytes = int(max_bytes)
        self.enabled = bool(enabled)
        self._lock = concurrency.Lock()
        # (tkey, shape key) -> (version, buffer, nbytes); tkey first, so
        # purge_table drops a dropped entry's buffers at once
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # tkeys whose owner has a finalizer, and those whose owner was
        # collected: purged under the lock before the next answer (a
        # finalizer runs wherever the collector runs, so it only queues)
        self._owned: set = set()
        self._dead: list = []

    # ------------------------------------------------------------------
    def _reap_locked(self) -> None:
        while self._dead:
            tkey = self._dead.pop()
            self._owned.discard(tkey)
            for k in [k for k in self._entries if k[0] == tkey]:
                self._drop_locked(k)

    def get(self, tkey, shape_key, version):
        if not self.enabled:
            return None
        key = (tkey, shape_key)
        with self._lock:
            self._reap_locked()
            hit = self._entries.get(key)
            if hit is not None and hit[0] != version:
                # the data changed since this buffer was folded: it can
                # never be served again, so free the card's memory now
                self._drop_locked(key)
                hit = None
            if hit is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return hit[1]

    def put(self, tkey, shape_key, version, buf, nbytes: int | None = None,
            owner=None):
        """Store `buf` (a tensor or a list of tensors the program owns).
        `owner`: the object whose id() `tkey` holds; when it is collected
        its buffers go, so a later object with its id never meets them."""
        nbytes = buffer_nbytes(buf) if nbytes is None else int(nbytes)
        if not self.enabled or nbytes > self.max_bytes:
            return
        key = (tkey, shape_key)
        with self._lock:
            self._reap_locked()
            if owner is not None and tkey not in self._owned:
                self._owned.add(tkey)
                weakref.finalize(owner, self._dead.append, tkey)
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[2]
            self._entries[key] = (version, buf, nbytes)
            self._bytes += nbytes
            while (self._bytes > self.max_bytes
                   or len(self._entries) > _MAX_ENTRIES) \
                    and len(self._entries) > 1:
                self._drop_locked(next(iter(self._entries)))

    # ------------------------------------------------------------------
    def purge_table(self, tkey) -> None:
        """Drop every buffer of `tkey` (a grid entry dropped, replaced or
        evicted: a later entry could reuse its id)."""
        with self._lock:
            for k in [k for k in self._entries if k[0] == tkey]:
                self._drop_locked(k)

    def clear(self) -> None:
        with self._lock:
            self._reap_locked()
            for k in list(self._entries):
                self._drop_locked(k)

    def _drop_locked(self, key) -> None:
        ent = self._entries.pop(key, None)
        if ent is not None:
            self._bytes -= ent[2]
            self.evictions += 1

    def evict_bytes(self, target: int) -> int:
        """Shed LRU entries until `target` bytes are freed; returns the
        bytes freed."""
        freed = 0
        with self._lock:
            while freed < target and self._entries:
                key = next(iter(self._entries))
                freed += self._entries[key][2]
                self._drop_locked(key)
        return freed

    def set_max_bytes(self, v: int) -> None:
        """Runtime budget update; a shrink trims LRU entries at once."""
        with self._lock:
            self.max_bytes = int(v)
            while self._bytes > self.max_bytes and self._entries:
                self._drop_locked(next(iter(self._entries)))

    @property
    def entry_count(self) -> int:
        with self._lock:
            self._reap_locked()
            return len(self._entries)

    @property
    def byte_count(self) -> int:
        with self._lock:
            return self._bytes


# process-wide registry (like promql/fast._CACHE): every QueryEngine in the
# process folds into one budget
global_sessions = SessionRegistry()


def configure(options: dict | None) -> None:
    """Apply the JAX package's `[sessions]` options (`enable`,
    `hbm_bytes`) to this process."""
    o = options or {}
    global_sessions.enabled = bool(o.get("enable", True))
    global_sessions.max_bytes = int(o.get("hbm_bytes", _DEFAULT_BYTES))
    if not global_sessions.enabled:
        global_sessions.clear()


# ----------------------------------------------------------------------
# `since` delta cursor: a client watermark in data time (epoch ms).
# Row-returning queries emit only rows whose time index is strictly
# greater, applied before ORDER BY / LIMIT like an extra WHERE on it.
# ----------------------------------------------------------------------

_since_var: contextvars.ContextVar = contextvars.ContextVar(
    "since_ms", default=None)


def bind_since(since_ms):
    """Bind the delta cursor for this execution; returns a reset token.
    None binds explicitly (clearing an outer cursor)."""
    return _since_var.set(None if since_ms is None else int(since_ms))


def reset_since(token) -> None:
    _since_var.reset(token)


def current_since():
    """The active `since` watermark in epoch ms, or None."""
    return _since_var.get()
