"""Admission control: per-tenant token buckets and concurrency limits over
a bounded priority queue (the JAX package's sched/admission.py).

Under overload the accepting edge sheds a typed error at once (a tenant
over its quota, a full queue) or after a bounded queue-time SLO, so the
tail of admitted work stays bounded because the queue's sojourn time is,
and memory stays bounded because its depth is. A statement admitted here
also gets its absolute deadline bound into its context (deadline.py):
admission is the one place where "never a hang" is enforced.

The defaults are permissive (no qps quota, no concurrency limit): the
controller rides every data-plane statement but never queues and never
sheds until limits are configured (`SchedulerConfig.from_options` takes
the JAX package's `[scheduler]` dict). The JAX package's `gtpu_sched_*`
metrics wait for the telemetry (ROADMAP A9); their tallies are the
controller's own attributes here (`admitted`, `shed`,
`deadline_expired`), keyed by a bounded tenant label. The JAX package's
runtime limit update (`set_max_concurrency`) waits for its caller, the
autotuner (A9), and its partial results for the distributed roles
(A10).
"""

from __future__ import annotations

import contextvars
import heapq
import time
from collections import OrderedDict

from greptimedb_tpu_torch import concurrency
from greptimedb_tpu_torch.errors import (
    QueryDeadlineExceededError,
    QueryOverloadedError,
    QueryQueueTimeoutError,
)
from greptimedb_tpu_torch.sched import deadline as _deadline

# The tenant string is client-controlled when unauthenticated (the HTTP
# `db` parameter), so everything keyed on it stays bounded under a storm
# of rotating names: tally labels collapse to "_other" past this many
# distinct unconfigured tenants, and token buckets live in an LRU of the
# same kind (an evicted bucket refills to its burst, which only
# under-counts a name-rotating client whose per-name bucket was full).
_TENANT_STATE_MAX = 4096
_LABEL_TENANTS_MAX = 64


def tenant_of(ctx) -> str:
    """Tenant of a session: the authenticated user when there is one,
    else the database the session is scoped to."""
    if ctx is None:
        return "public"
    return getattr(ctx, "username", "") or getattr(
        ctx, "database", "") or "public"


class _TenantLimits:
    __slots__ = ("qps", "burst", "concurrency", "priority")

    def __init__(self, qps: float, burst: float, concurrency: int,
                 priority: int):
        self.qps = float(qps)
        self.burst = float(burst) if burst > 0 else max(1.0, 2 * self.qps)
        self.concurrency = int(concurrency)
        self.priority = int(priority)


class SchedulerConfig:
    """The `[scheduler]` options. 0 means unlimited for every limit knob;
    `tenants` holds per-tenant overrides {name: {qps, burst, concurrency,
    priority}} (a lower priority number is admitted first)."""

    def __init__(self, *, enable: bool = True, max_concurrency: int = 0,
                 queue_depth: int = 256, queue_timeout_s: float = 10.0,
                 default_deadline_s: float = 0.0,
                 tenant_qps: float = 0.0, tenant_burst: float = 0.0,
                 tenant_concurrency: int = 0,
                 tenants: dict | None = None):
        self.enable = bool(enable)
        self.max_concurrency = int(max_concurrency)
        self.queue_depth = int(queue_depth)
        self.queue_timeout_s = float(queue_timeout_s)
        self.default_deadline_s = float(default_deadline_s)
        self.tenant_qps = float(tenant_qps)
        self.tenant_burst = float(tenant_burst)
        self.tenant_concurrency = int(tenant_concurrency)
        self.tenants = dict(tenants or {})
        self._limits_cache: dict[str, _TenantLimits] = {}
        # every unconfigured tenant shares one limits object: the cache
        # holds configured tenants only, never client-invented names
        self._default_limits = _TenantLimits(
            qps=self.tenant_qps, burst=self.tenant_burst,
            concurrency=self.tenant_concurrency, priority=100)

    @classmethod
    def from_options(cls, options: dict | None) -> "SchedulerConfig":
        o = options or {}
        return cls(
            enable=o.get("enable", True),
            max_concurrency=o.get("max_concurrency", 0),
            queue_depth=o.get("queue_depth", 256),
            queue_timeout_s=o.get("queue_timeout_s", 10.0),
            default_deadline_s=o.get("default_deadline_s", 0.0),
            tenant_qps=o.get("tenant_qps", 0.0),
            tenant_burst=o.get("tenant_burst", 0.0),
            tenant_concurrency=o.get("tenant_concurrency", 0),
            tenants={k: dict(v) for k, v in (o.get("tenants") or {}).items()
                     if isinstance(v, dict)},
        )

    def limits(self, tenant: str) -> _TenantLimits:
        over = self.tenants.get(tenant)
        if over is None:
            return self._default_limits
        lim = self._limits_cache.get(tenant)
        if lim is None:
            lim = _TenantLimits(
                qps=over.get("qps", self.tenant_qps),
                burst=over.get("burst", self.tenant_burst),
                concurrency=over.get("concurrency",
                                     self.tenant_concurrency),
                priority=over.get("priority", 100))
            self._limits_cache[tenant] = lim
        return lim

    def configured(self, tenant: str) -> bool:
        return tenant in self.tenants


class _Waiter:
    __slots__ = ("tenant", "limits", "event", "admitted", "abandoned")

    def __init__(self, tenant: str, limits: _TenantLimits):
        self.tenant = tenant
        self.limits = limits
        self.event = concurrency.Event()
        self.admitted = False
        self.abandoned = False


# re-entrancy guard: a statement run inside an admitted statement (the
# EXECUTE of a prepared statement) rides the parent's slot and deadline
# instead of deadlocking against its own tenant's concurrency limit
_active: contextvars.ContextVar = contextvars.ContextVar(
    "sched_active", default=False)


class AdmissionController:
    """One per instance; `admit(ctx)` guards one statement's execution."""

    def __init__(self, config: SchedulerConfig | None = None):
        self.config = config or SchedulerConfig()
        self._lock = concurrency.Lock()
        self._running_total = 0
        self._running_tenant: dict[str, int] = {}
        self._heap: list[tuple[int, int, _Waiter]] = []
        self._queued = 0
        self._seq = 0
        self._buckets: OrderedDict[str, list[float]] = OrderedDict()
        self._label_tenants: set = set()
        # tallies (the JAX package's gtpu_sched_* series): tenant label ->
        # count, (tenant label, reason) -> count
        self.admitted: dict[str, int] = {}
        self.shed: dict[tuple[str, str], int] = {}
        self.deadline_expired: dict[str, int] = {}

    # ---- public surface ---------------------------------------------
    def admit(self, ctx=None, *, tenant: str | None = None,
              timeout_s: float | None = None) -> "_Admission":
        return _Admission(self, ctx, tenant, timeout_s)

    def snapshot(self) -> dict:
        with self._lock:
            return {"running": self._running_total, "queued": self._queued,
                    "tenants": dict(self._running_tenant)}

    # ---- internals ----------------------------------------------------
    def _label(self, tenant: str) -> str:
        """The tally key of `tenant`: bounded under name rotation."""
        if self.config.configured(tenant) or tenant in self._label_tenants:
            return tenant
        if len(self._label_tenants) < _LABEL_TENANTS_MAX:
            self._label_tenants.add(tenant)
            return tenant
        return "_other"

    def _tally(self, tally: dict, key) -> None:
        tally[key] = tally.get(key, 0) + 1

    def _can_run_locked(self, tenant: str, lim: _TenantLimits) -> bool:
        if 0 < self.config.max_concurrency <= self._running_total:
            return False
        if 0 < lim.concurrency <= self._running_tenant.get(tenant, 0):
            return False
        return True

    def _start_locked(self, tenant: str):
        self._running_total += 1
        self._running_tenant[tenant] = \
            self._running_tenant.get(tenant, 0) + 1

    def _take_token_locked(self, tenant: str, lim: _TenantLimits) -> bool:
        if lim.qps <= 0:
            return True
        now = time.monotonic()
        b = self._buckets.get(tenant)
        if b is None:
            if len(self._buckets) >= _TENANT_STATE_MAX:
                self._buckets.popitem(last=False)
            self._buckets[tenant] = b = [lim.burst, now]
        else:
            self._buckets.move_to_end(tenant)
            b[0] = min(lim.burst, b[0] + (now - b[1]) * lim.qps)
            b[1] = now
        if b[0] < 1.0:
            return False
        b[0] -= 1.0
        return True

    def _acquire(self, tenant: str, dl: _deadline.Deadline | None):
        cfg = self.config
        if not cfg.enable:
            return
        with self._lock:
            mt = self._label(tenant)
        if dl is not None and dl.expired():
            # a spent budget never reaches execution, whichever path
            # would run the query
            with self._lock:
                self._tally(self.shed, (mt, "deadline"))
                self._tally(self.deadline_expired, mt)
            raise QueryDeadlineExceededError(
                "query deadline expired before admission")
        lim = cfg.limits(tenant)
        with self._lock:
            if not self._take_token_locked(tenant, lim):
                self._tally(self.shed, (mt, "qps"))
                raise QueryOverloadedError(
                    f"tenant {tenant!r} is over its rate quota "
                    f"({lim.qps:g} qps); back off and retry")
            if self._can_run_locked(tenant, lim):
                self._start_locked(tenant)
                self._tally(self.admitted, mt)
                return
            if 0 < cfg.queue_depth <= self._queued:
                self._tally(self.shed, (mt, "queue_full"))
                raise QueryOverloadedError(
                    f"admission queue is full ({cfg.queue_depth}); "
                    "back off and retry")
            w = _Waiter(tenant, lim)
            self._seq += 1
            heapq.heappush(self._heap, (lim.priority, self._seq, w))
            self._queued += 1
        # queue_timeout_s 0 = no SLO, like every other limit knob: wait
        # until a slot frees or the deadline lapses
        wait_s = cfg.queue_timeout_s if cfg.queue_timeout_s > 0 else None
        if dl is not None:
            rem = dl.remaining()
            wait_s = rem if wait_s is None else min(wait_s, rem)
        # + epsilon: Event.wait can return a hair early; when the deadline
        # binds it must have lapsed afterwards, so the shed classifies as
        # a deadline, not a queue timeout
        w.event.wait(None if wait_s is None else wait_s + 0.02)
        with self._lock:
            admitted = w.admitted
            if not admitted:
                # dropped from the heap lazily by the next handover
                w.abandoned = True
                self._queued -= 1
            if admitted:
                self._tally(self.admitted, mt)
                return
            if dl is not None and dl.expired():
                self._tally(self.shed, (mt, "deadline"))
                self._tally(self.deadline_expired, mt)
                expired = True
            else:
                self._tally(self.shed, (mt, "queue_timeout"))
                expired = False
        if expired:
            raise QueryDeadlineExceededError(
                "query deadline expired in the admission queue")
        raise QueryQueueTimeoutError(
            f"no execution slot within the {cfg.queue_timeout_s:g}s "
            "queue-time SLO; the instance is saturated")

    def _release(self, tenant: str):
        if not self.config.enable:
            return
        wake = None
        with self._lock:
            self._running_total = max(0, self._running_total - 1)
            n = self._running_tenant.get(tenant, 0) - 1
            if n > 0:
                self._running_tenant[tenant] = n
            else:
                self._running_tenant.pop(tenant, None)
            # hand the freed slot to the best eligible waiter; waiters
            # whose tenant is at its own cap stay queued, abandoned ones
            # are dropped
            stash = []
            while self._heap:
                prio, seq, w = heapq.heappop(self._heap)
                if w.abandoned:
                    continue
                if self._can_run_locked(w.tenant, w.limits):
                    self._start_locked(w.tenant)
                    w.admitted = True
                    self._queued -= 1
                    wake = w
                    break
                stash.append((prio, seq, w))
            for item in stash:
                heapq.heappush(self._heap, item)
        if wake is not None:
            wake.event.set()


class _Admission:
    """Context manager for one admitted statement: resolves the tenant
    and deadline, takes (or queues for) an execution slot, binds the
    deadline for the cooperative checks, and releases on exit."""

    __slots__ = ("_c", "_ctx", "_tenant", "_timeout_s", "_noop",
                 "_dl_token", "_active_token", "deadline")

    def __init__(self, controller: AdmissionController, ctx,
                 tenant: str | None, timeout_s: float | None):
        self._c = controller
        self._ctx = ctx
        self._tenant = tenant
        self._timeout_s = timeout_s
        self._noop = False
        self._dl_token = None
        self._active_token = None
        self.deadline: _deadline.Deadline | None = None

    def _resolve_timeout(self) -> float | None:
        if self._timeout_s is not None:
            return self._timeout_s
        ctx = self._ctx
        if ctx is not None:
            hint = getattr(ctx, "extensions", {}).get("deadline_s")
            if hint is not None:
                return float(hint)
            # the MySQL session knob: SET max_execution_time = <ms>
            ms = getattr(ctx, "variables", {}).get("max_execution_time")
            try:
                if ms is not None and float(ms) > 0:
                    return float(ms) / 1000.0
            except (TypeError, ValueError):
                pass
        return self._c.config.default_deadline_s

    def __enter__(self) -> "_Admission":
        if _active.get():
            self._noop = True   # nested statement: ride the parent slot
            return self
        self._tenant = self._tenant or tenant_of(self._ctx)
        self.deadline = _deadline.Deadline.from_timeout(
            self._resolve_timeout())
        self._dl_token = _deadline.bind(self.deadline)
        try:
            self._c._acquire(self._tenant, self.deadline)
        except BaseException:
            _deadline.reset(self._dl_token)
            self._dl_token = None
            raise
        self._active_token = _active.set(True)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._noop:
            return False
        _active.reset(self._active_token)
        self._c._release(self._tenant)
        _deadline.reset(self._dl_token)
        if exc_type is not None and issubclass(
                exc_type, QueryDeadlineExceededError):
            c = self._c
            with c._lock:
                c._tally(c.deadline_expired, c._label(self._tenant))
        return False
