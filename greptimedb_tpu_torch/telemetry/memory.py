"""Process-wide memory accountant: one ledger over every byte-budgeted
pool.

The device-resident result path made HBM a contended long-lived
resource: session result buffers, range cell-state grids and PromQL
selector grids all pin device memory across queries, next to host-side
byte pools (merged-scan cache, result cache, page cache, trace ring,
ingest queues) — and each pool was a silo with its own budget. This
module is the arbiter the tf.data design (PAPERS.md) argues for: every
pool registers here with an owner tag and reports
bytes/entries/budget/hits/evictions through ONE interface, the way the
reference exposes jemalloc heap accounting behind /debug/prof.

Three capabilities on top of registration:

- **unified surfaces** — `gtpu_mem_{bytes,entries,budget_bytes,
  evictions_total}{pool,tier=device|host}` refresh on every /metrics
  scrape (a registry collector, no background thread), mirrored by
  `information_schema.memory_pools` and `/debug/prof/hbm`;

- **device live-buffer census** — owner-tagged CUDA tensors enumerated
  by each device pool are reconciled against the caching allocator's
  `torch.cuda.memory_allocated` (PyTorch keeps no list of live
  tensors): the pools' storages, de-duplicated by storage pointer and
  rounded up to the allocator's 512-byte blocks, are the accounted
  bytes, and `gtpu_mem_unaccounted_device_bytes` is the residue no pool
  claims, an always-on detector for the stranded-buffer leak class;

- **cross-pool pressure** — a global `[memory] device_budget_bytes`
  watermark below the sum of individual pool budgets is enforced by
  demand-driven proportional eviction: a device pool calls
  `note_device_bytes()` after growing (OUTSIDE its own lock — eviction
  re-enters other pools), and the accountant asks each evictable pool
  to shed its proportional share of the overage. Three independent
  LRUs can no longer jointly exceed HBM with no arbiter.

Registrations hold the pool through a weakref: a GC'd pool (a closed
test instance) silently drops out of the ledger, so no unregister
plumbing is needed and pool names aggregate across live instances.
"""

from __future__ import annotations

import time
import weakref

import torch

from dataclasses import dataclass

from greptimedb_tpu_torch.telemetry.metrics import global_registry

from greptimedb_tpu_torch import concurrency

_BYTES = global_registry.gauge(
    "gtpu_mem_bytes",
    "bytes held per registered memory pool", ("pool", "tier"),
)
_ENTRIES = global_registry.gauge(
    "gtpu_mem_entries",
    "entries held per registered memory pool", ("pool", "tier"),
)
_BUDGET = global_registry.gauge(
    "gtpu_mem_budget_bytes",
    "configured byte budget per registered memory pool (0 = entry- or "
    "row-bounded)", ("pool", "tier"),
)
_EVICTIONS = global_registry.counter(
    "gtpu_mem_evictions_total",
    "entries evicted per registered memory pool (budget, staleness or "
    "cross-pool pressure)", ("pool", "tier"),
)
_CROSS_EVICTED = global_registry.counter(
    "gtpu_mem_cross_pool_evicted_bytes_total",
    "device bytes evicted by the global [memory] device_budget_bytes "
    "watermark, per shedding pool", ("pool",),
)
_DEVICE_LIVE = global_registry.gauge(
    "gtpu_mem_device_live_bytes",
    "bytes the CUDA caching allocator holds in live tensors "
    "(torch.cuda.memory_allocated over every initialized card)",
)
_DEVICE_ACCOUNTED = global_registry.gauge(
    "gtpu_mem_device_accounted_bytes",
    "census bytes owned by a registered device pool",
)
_UNACCOUNTED = global_registry.gauge(
    "gtpu_mem_unaccounted_device_bytes",
    "live device bytes no registered pool claims — the leak gauge",
)


@dataclass
class PoolStats:
    """One pool's aggregated snapshot (summed across live instances of
    the same registered name)."""

    name: str
    tier: str                 # "device" | "host"
    bytes: int = 0
    entries: int = 0
    budget_bytes: int = 0
    max_entries: int = 0      # 0 = no entry cap
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    instances: int = 0

    def to_doc(self) -> dict:
        return {
            "pool": self.name, "tier": self.tier,
            "bytes": int(self.bytes), "entries": int(self.entries),
            "budget_bytes": int(self.budget_bytes),
            "max_entries": int(self.max_entries),
            "hits": int(self.hits), "misses": int(self.misses),
            "evictions": int(self.evictions),
            "instances": int(self.instances),
        }


class _Registration:
    __slots__ = ("name", "tier", "ref", "stats_fn", "evict_fn",
                 "buffers_fn", "last_evictions")

    def __init__(self, name, tier, ref, stats_fn, evict_fn, buffers_fn):
        self.name = name
        self.tier = tier
        self.ref = ref
        self.stats_fn = stats_fn
        self.evict_fn = evict_fn
        self.buffers_fn = buffers_fn
        # per-INSTANCE published-evictions baseline: deltas keyed on the
        # aggregate would stall behind a dead instance's high-water mark
        self.last_evictions = 0


def iter_device_arrays(obj, _depth: int = 0):
    """Best-effort walk of nested containers for CUDA tensors — pools
    whose derived caches hold tuples/dicts of device inputs (promql
    match/group/win caches) enumerate them for the census without
    knowing their exact shape."""
    if _depth > 4 or obj is None:
        return
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            yield obj
        return
    if isinstance(obj, dict):
        for v in obj.values():
            yield from iter_device_arrays(v, _depth + 1)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from iter_device_arrays(v, _depth + 1)


class MemoryAccountant:
    """The process-wide pool ledger. One instance (`global_accountant`)
    serves every pool in the process."""

    def __init__(self):
        self._lock = concurrency.Lock()
        self._regs: list[_Registration] = []
        self.enabled = True
        # 0 = no global watermark: per-pool budgets only
        self.device_budget_bytes = 0
        # refresh the census gauges on every /metrics render
        self.census_on_scrape = True
        # (name, tier) keys whose gauges this accountant has published:
        # a pool whose last instance died must have its gauges zeroed,
        # not frozen at the final value
        self._published: set = set()
        # serializes enforcement: taken NON-blocking, so (a) an
        # eviction triggered by enforcement can never recursively
        # re-enforce on the same thread (a plain Lock is
        # non-reentrant), and (b) two threads that both notice the
        # same overage do not each run a full sweep and jointly shed
        # twice the required bytes
        self._enforce_lock = concurrency.Lock()
        # (monotonic, bytes) TTL cache for device_bytes_cached(): span
        # attribution reads this per traced device call and must not
        # take every pool's lock each time
        self._dev_bytes_cache = (-1e18, 0)

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------
    def register_pool(self, name: str, tier: str, pool, *, stats,
                      evict=None, buffers=None) -> None:
        """Register one pool instance.

        - `stats(pool) -> dict` with any of bytes/entries/budget_bytes/
          max_entries/hits/misses/evictions (missing keys default 0);
        - `evict(pool, target_bytes) -> freed_bytes` (device pools that
          participate in cross-pool pressure eviction);
        - `buffers(pool) -> iterable of (array, owner_tag)` (device
          pools; feeds the live-buffer census).
        """
        if tier not in ("device", "host"):
            raise ValueError(f"tier must be device|host, got {tier!r}")
        reg = _Registration(name, tier, weakref.ref(pool), stats, evict,
                            buffers)
        with self._lock:
            self._regs.append(reg)

    def _live(self) -> list[tuple[_Registration, object]]:
        with self._lock:
            regs = list(self._regs)
        out = []
        dead = []
        for r in regs:
            p = r.ref()
            if p is None:
                dead.append(r)
            else:
                out.append((r, p))
        if dead:
            with self._lock:
                self._regs = [r for r in self._regs if r not in dead]
        return out

    # ------------------------------------------------------------------
    # snapshots + publication
    # ------------------------------------------------------------------
    def snapshot(self) -> list[PoolStats]:
        """Per-pool aggregated stats, summed across live instances of
        each registered name, sorted device-first then by name."""
        agg: dict[tuple, PoolStats] = {}
        for reg, pool in self._live():
            try:
                doc = reg.stats_fn(pool) or {}
            except Exception:  # noqa: BLE001 - a pool mid-teardown must
                # not break the whole ledger
                continue
            key = (reg.tier, reg.name)
            st = agg.get(key)
            if st is None:
                st = agg[key] = PoolStats(name=reg.name, tier=reg.tier)
            st.bytes += int(doc.get("bytes", 0))
            st.entries += int(doc.get("entries", 0))
            st.budget_bytes += int(doc.get("budget_bytes", 0))
            st.max_entries += int(doc.get("max_entries", 0))
            st.hits += int(doc.get("hits", 0))
            st.misses += int(doc.get("misses", 0))
            st.evictions += int(doc.get("evictions", 0))
            st.instances += 1
        return [
            agg[k] for k in sorted(
                agg, key=lambda k: (k[0] != "device", k[1])
            )
        ]

    def device_bytes(self) -> int:
        """Total bytes reported by device-tier pools (the number the
        global watermark is enforced against)."""
        total = 0
        for reg, pool in self._live():
            if reg.tier != "device":
                continue
            try:
                total += int((reg.stats_fn(pool) or {}).get("bytes", 0))
            except Exception:  # noqa: BLE001
                continue
        self._dev_bytes_cache = (time.monotonic(), total)
        return total

    def device_bytes_cached(self, max_age_s: float = 0.5) -> int:
        """device_bytes() behind a short TTL: per-span attribution on
        the traced hot path reads this, so a burst of device calls
        takes the pool locks once per TTL window, not once per call."""
        ts, val = self._dev_bytes_cache
        if time.monotonic() - ts <= max_age_s:
            return val
        return self.device_bytes()

    def publish(self) -> None:
        """Refresh the gtpu_mem_* families from current pool state
        (called by the registry collector on every scrape)."""
        if not self.enabled:
            return
        rows = []
        for reg, pool in self._live():
            try:
                doc = reg.stats_fn(pool) or {}
            except Exception:  # noqa: BLE001 - a pool mid-teardown
                continue
            rows.append((reg, doc))
        agg: dict[tuple, list] = {}
        for reg, doc in rows:
            a = agg.setdefault((reg.name, reg.tier), [0, 0, 0])
            a[0] += int(doc.get("bytes", 0))
            a[1] += int(doc.get("entries", 0))
            a[2] += int(doc.get("budget_bytes", 0))
        # delta bookkeeping under the accountant lock: two concurrent
        # scrapes reading the same stale baseline would both inc() the
        # counter with the full delta and inflate it forever. Baselines
        # are per-REGISTRATION: a dead instance's count dies with it
        # instead of masking the survivors' evictions behind the old
        # aggregate high-water mark.
        with self._lock:
            for reg, doc in rows:
                ev = int(doc.get("evictions", 0))
                if ev > reg.last_evictions:
                    _EVICTIONS.labels(reg.name, reg.tier).inc(
                        ev - reg.last_evictions
                    )
                reg.last_evictions = max(reg.last_evictions, ev)
            # a pool whose last instance was GC'd must report zero, not
            # freeze at its final published value
            for key in list(self._published):
                if key not in agg:
                    _BYTES.labels(*key).set(0.0)
                    _ENTRIES.labels(*key).set(0.0)
                    _BUDGET.labels(*key).set(0.0)
                    self._published.discard(key)
            for key, (b, e, bu) in agg.items():
                _BYTES.labels(*key).set(float(b))
                _ENTRIES.labels(*key).set(float(e))
                _BUDGET.labels(*key).set(float(bu))
                self._published.add(key)

    # ------------------------------------------------------------------
    # device live-buffer census
    # ------------------------------------------------------------------
    def census(self, top: int = 0) -> dict:
        """Reconcile owner-tagged pool buffers against the caching
        allocator. Returns {live_bytes, accounted_bytes,
        unaccounted_bytes, unaccounted_count, pools: {name: bytes},
        top: [{bytes, owner, shape, dtype}]} and refreshes the census
        gauges. A pool buffer counts its storage once (storages are
        de-duplicated by pointer: views and aliases share one), rounded
        up to the allocator's 512-byte block as memory_allocated counts
        it. unaccounted_count is 0: the allocator lists no buffers.
        `top` > 0 additionally ranks the largest pool storages with
        their owner attribution."""
        # storage pointer -> (tensor, owner, bytes): the tensor is
        # PINNED here for the duration of the census, so a concurrent
        # eviction cannot free a storage and let the allocator hand
        # its pointer to an unrelated tensor mid-census
        owned: dict[tuple, tuple] = {}
        per_pool: dict[str, int] = {}
        for reg, pool in self._live():
            if reg.tier != "device" or reg.buffers_fn is None:
                continue
            try:
                bufs = list(reg.buffers_fn(pool))
            except Exception:  # noqa: BLE001 - census is best-effort
                continue
            per_pool.setdefault(reg.name, 0)
            for item in bufs:
                arr, owner = (item if isinstance(item, tuple)
                              else (item, reg.name))
                if not isinstance(arr, torch.Tensor) or not arr.is_cuda:
                    continue
                st = arr.untyped_storage()
                key = (arr.device.index, st.data_ptr())
                if key in owned:
                    continue
                nb = _block_bytes(st.nbytes())
                owned[key] = (arr, owner, nb)
                per_pool[reg.name] += nb
        accounted = sum(nb for _a, _o, nb in owned.values())
        live_bytes = _allocated_bytes()
        unaccounted = max(live_bytes - accounted, 0)
        _DEVICE_LIVE.set(float(live_bytes))
        _DEVICE_ACCOUNTED.set(float(accounted))
        _UNACCOUNTED.set(float(unaccounted))
        out = {
            "live_bytes": live_bytes,
            "accounted_bytes": accounted,
            "unaccounted_bytes": unaccounted,
            "unaccounted_count": 0,
            "pools": per_pool,
        }
        if top > 0:
            ranked = sorted(owned.values(), key=lambda r: -r[2])[:top]
            out["top"] = [
                {"bytes": nb, "owner": ow, "shape": str(tuple(a.shape)),
                 "dtype": str(a.dtype)}
                for a, ow, nb in ranked
            ]
        return out

    # ------------------------------------------------------------------
    # cross-pool pressure
    # ------------------------------------------------------------------
    def note_device_bytes(self) -> int:
        """Device pools call this after growing, OUTSIDE their own lock
        (enforcement re-enters pools through their evict callbacks).
        Near-free when no global watermark is configured."""
        if not self.enabled or self.device_budget_bytes <= 0:
            return 0
        return self.enforce_device_budget()

    def enforce_device_budget(self) -> int:
        """Demand-driven proportional eviction: while total device pool
        bytes (evictable or not — a non-evictable pool's residency
        still consumes HBM) exceed the watermark, each evictable pool
        sheds its byte-share of the overage (largest pools first); a
        residual overage (a pool that could not free) falls through to
        a greedy second pass. Returns bytes freed."""
        budget = self.device_budget_bytes
        if budget <= 0:
            return 0
        if not self._enforce_lock.acquire(blocking=False):
            # another thread (or this one, re-entered through an evict
            # callback) is already sweeping the same overage
            return 0
        try:
            freed_total = 0
            for greedy in (False, True):
                evictable = []
                total = 0
                ev_total = 0
                for reg, pool in self._live():
                    if reg.tier != "device":
                        continue
                    try:
                        b = int(
                            (reg.stats_fn(pool) or {}).get("bytes", 0)
                        )
                    except Exception:  # noqa: BLE001
                        continue
                    total += b
                    if reg.evict_fn is not None and b > 0:
                        evictable.append((reg, pool, b))
                        ev_total += b
                overage = total - budget
                if overage <= 0 or not evictable:
                    return freed_total
                evictable.sort(key=lambda t: -t[2])
                for reg, pool, b in evictable:
                    if overage <= 0:
                        break
                    target = (min(b, overage) if greedy
                              else min(b, -(-overage * b // ev_total)))
                    try:
                        got = int(reg.evict_fn(pool, target) or 0)
                    except Exception:  # noqa: BLE001 - one pool's
                        # failure must not stop the sweep
                        got = 0
                    if got > 0:
                        _CROSS_EVICTED.labels(reg.name).inc(got)
                        freed_total += got
                        if greedy:
                            overage -= got
            return freed_total
        finally:
            self._enforce_lock.release()


# the CUDA caching allocator rounds every block up to 512 bytes
_BLOCK = 512


def _block_bytes(nbytes: int) -> int:
    return -(-int(nbytes) // _BLOCK) * _BLOCK


def _allocated_bytes() -> int:
    """Bytes in live tensors on every card, WITHOUT initializing CUDA
    (0 on a process that never touched the card)."""
    if not torch.cuda.is_initialized():
        return 0
    return int(sum(torch.cuda.memory_allocated(d)
                   for d in range(torch.cuda.device_count())))


global_accountant = MemoryAccountant()


def register_pool(name: str, tier: str, pool, *, stats, evict=None,
                  buffers=None) -> None:
    """Module-level convenience over the process-wide accountant."""
    global_accountant.register_pool(
        name, tier, pool, stats=stats, evict=evict, buffers=buffers
    )


def note_device_bytes() -> int:
    return global_accountant.note_device_bytes()


def configure(options: dict | None) -> None:
    """Apply the `[memory]` TOML section to this process."""
    o = options or {}
    acct = global_accountant
    acct.enabled = bool(o.get("enable", True))
    acct.device_budget_bytes = int(o.get("device_budget_bytes", 0))
    acct.census_on_scrape = bool(o.get("census_on_scrape", True))
    if acct.enabled and acct.device_budget_bytes > 0:
        # a watermark configured below current residency applies now,
        # not at the next put
        acct.enforce_device_budget()


def hbm_report(top: int = 10) -> dict:
    """The /debug/prof/hbm document: per-pool stats (device pools also
    carry their census-enumerated bytes), the live-buffer census with
    unaccounted residue, and the top-N live buffers by size with owner/
    shape/dtype attribution."""
    acct = global_accountant
    census = acct.census(top=top)
    pools = []
    for st in acct.snapshot():
        doc = st.to_doc()
        if st.tier == "device":
            doc["census_bytes"] = int(
                census["pools"].get(st.name, 0)
            )
        pools.append(doc)
    return {
        "pools": pools,
        "device_budget_bytes": acct.device_budget_bytes,
        "census": {
            "live_bytes": census["live_bytes"],
            "accounted_bytes": census["accounted_bytes"],
            "unaccounted_bytes": census["unaccounted_bytes"],
            "unaccounted_count": census["unaccounted_count"],
        },
        "top_buffers": census.get("top", []),
    }


def render_hbm_text(doc: dict) -> str:
    """Plain-text rendering of hbm_report (the default /debug/prof/hbm
    response, beside the CPU/heap text routes)."""
    lines = []
    c = doc["census"]
    budget = doc.get("device_budget_bytes", 0)
    lines.append(
        f"device census: live={c['live_bytes']} "
        f"accounted={c['accounted_bytes']} "
        f"unaccounted={c['unaccounted_bytes']} "
        f"({c['unaccounted_count']} buffers)"
    )
    lines.append(
        "global device budget: "
        + (f"{budget}" if budget > 0 else "(none)")
    )
    for tier in ("device", "host"):
        rows = [p for p in doc["pools"] if p["tier"] == tier]
        lines.append("")
        lines.append(f"{tier} pools:")
        lines.append(
            f"{'pool':<18} {'bytes':>14} {'census':>14} {'entries':>10} "
            f"{'budget':>14} {'hits':>10} {'miss':>10} {'evict':>8}"
        )
        for p in rows:
            census_col = (str(p.get("census_bytes", ""))
                          if tier == "device" else "-")
            lines.append(
                f"{p['pool']:<18} {p['bytes']:>14} {census_col:>14} "
                f"{p['entries']:>10} {p['budget_bytes']:>14} "
                f"{p['hits']:>10} {p['misses']:>10} {p['evictions']:>8}"
            )
    tops = doc.get("top_buffers", [])
    if tops:
        lines.append("")
        lines.append("top live buffers:")
        lines.append(f"{'bytes':>14}  {'shape':<20} {'dtype':<10} owner")
        for b in tops:
            lines.append(
                f"{b['bytes']:>14}  {b['shape']:<20} {b['dtype']:<10} "
                f"{b['owner']}"
            )
    return "\n".join(lines) + "\n"


def _scrape_collect() -> None:
    acct = global_accountant
    if not acct.enabled:
        return
    acct.publish()
    if acct.census_on_scrape:
        acct.census()


global_registry.register_collector(_scrape_collect)
