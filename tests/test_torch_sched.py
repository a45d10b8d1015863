"""Admission control, deadlines and basic auth against the JAX package, on
the CPU.

Every standalone case of tests/test_sched.py (the two distributed ones
wait for ROADMAP A10) and the basic-auth case of
tests/test_aux_subsystems.py run on each package (`pkg`): the same
controller scenarios with the same assertions, and the observable
outcomes (which statement was admitted, queued, shed and with which typed
error class, in which order) must be equal. The instance and HTTP cases
run both Standalones and compare answers, status codes and bodies. The
port's gtpu_sched_* families count admissions and sheds as the JAX
package's do. Every sleep and join is bounded.
"""

import base64
import json
import threading
import time
import types
import urllib.error
import urllib.parse
import urllib.request

import pytest

import greptimedb_tpu.auth as jax_auth
import greptimedb_tpu.cancellation as jax_cancellation
import greptimedb_tpu.errors as jax_errors
import greptimedb_tpu.sched as jax_sched
import greptimedb_tpu.sched.admission as jax_admission
import greptimedb_tpu.sched.deadline as jax_deadline
import greptimedb_tpu_torch.auth as port_auth
import greptimedb_tpu_torch.cancellation as port_cancellation
import greptimedb_tpu_torch.errors as port_errors
import greptimedb_tpu_torch.sched as port_sched
import greptimedb_tpu_torch.sched.admission as port_admission
import greptimedb_tpu_torch.sched.deadline as port_deadline
from greptimedb_tpu.instance import Standalone as JaxStandalone
from greptimedb_tpu.servers import http as jax_http
from greptimedb_tpu.session import QueryContext as JaxCtx
from greptimedb_tpu_torch.instance import Standalone
from greptimedb_tpu_torch.servers import http as port_http
from greptimedb_tpu_torch.session import QueryContext

PKGS = {
    "port": types.SimpleNamespace(
        sched=port_sched, admission=port_admission, deadline=port_deadline,
        cancellation=port_cancellation, errors=port_errors, auth=port_auth,
        http=port_http, Ctx=QueryContext,
        Standalone=lambda root: Standalone(root, device="cpu", x64=True,
                                           prefer_device=False,
                                           warm_start=False)),
    "jax": types.SimpleNamespace(
        sched=jax_sched, admission=jax_admission, deadline=jax_deadline,
        cancellation=jax_cancellation, errors=jax_errors, auth=jax_auth,
        http=jax_http, Ctx=JaxCtx,
        Standalone=lambda root: JaxStandalone(root, prefer_device=False,
                                              warm_start=False)),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _controller(p, **cfg):
    return p.sched.AdmissionController(p.sched.SchedulerConfig(**cfg))


# ---------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------

def test_tenant_identity(pkg):
    tenant_of, Ctx = pkg.sched.tenant_of, pkg.Ctx
    assert tenant_of(None) == "public"
    assert tenant_of(Ctx()) == "public"
    assert tenant_of(Ctx(database="metrics")) == "metrics"
    assert tenant_of(Ctx(username="alice", database="metrics")) == "alice"


def test_qps_quota_sheds_typed(pkg):
    c = _controller(pkg, tenant_qps=1.0, tenant_burst=1.0)
    ctx = pkg.Ctx(username="noisy")
    with c.admit(ctx):
        pass
    with pytest.raises(pkg.errors.QueryOverloadedError) as ei:
        with c.admit(ctx):
            pass
    assert "over its rate quota (1 qps)" in str(ei.value)
    # tokens refill at qps: after a second one passes again
    time.sleep(1.05)
    with c.admit(ctx):
        pass


def test_per_tenant_quota_isolation(pkg):
    c = _controller(pkg, tenants={"noisy": {"qps": 1.0, "burst": 1.0}})
    with c.admit(pkg.Ctx(username="noisy")):
        pass
    with pytest.raises(pkg.errors.QueryOverloadedError):
        with c.admit(pkg.Ctx(username="noisy")):
            pass
    for _ in range(5):      # an unlimited tenant is never shed
        with c.admit(pkg.Ctx(username="quiet")):
            pass


def test_queue_timeout_and_queue_full_shed_typed(pkg):
    c = _controller(pkg, max_concurrency=1, queue_depth=1,
                    queue_timeout_s=0.2)
    hold = c.admit(pkg.Ctx())
    hold.__enter__()
    try:
        results = {}

        def attempt(name, delay):
            time.sleep(delay)
            try:
                with c.admit(pkg.Ctx(username=name)):
                    results[name] = "admitted"
            except Exception as e:  # noqa: BLE001 - recorded
                results[name] = type(e).__name__

        ts = [threading.Thread(target=attempt, args=("waiter", 0.0)),
              threading.Thread(target=attempt, args=("spill", 0.05))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(5)
        # the first queues, then times out (503); the second finds the
        # bounded queue full and is shed at once (429)
        assert results == {"waiter": "QueryQueueTimeoutError",
                           "spill": "QueryOverloadedError"}
        assert c.snapshot() == {"running": 1, "queued": 0,
                                "tenants": {"public": 1}}
    finally:
        hold.__exit__(None, None, None)
    assert c.snapshot()["running"] == 0


def test_queue_knobs_zero_mean_unlimited(pkg):
    c = _controller(pkg, max_concurrency=1, queue_depth=0,
                    queue_timeout_s=0.0)
    hold = c.admit(pkg.Ctx())
    hold.__enter__()
    outcomes = []
    lock = threading.Lock()

    def attempt():
        try:
            with c.admit(pkg.Ctx()):
                with lock:
                    outcomes.append("admitted")
        except Exception as e:  # noqa: BLE001 - recorded
            with lock:
                outcomes.append(type(e).__name__)

    ts = [threading.Thread(target=attempt) for _ in range(3)]
    for t in ts:
        t.start()
    time.sleep(0.3)     # past a 0-valued SLO misread as 0 seconds
    assert outcomes == [] and c.snapshot()["queued"] == 3
    hold.__exit__(None, None, None)
    for t in ts:
        t.join(10)
    assert outcomes == ["admitted"] * 3


def test_tenant_state_stays_bounded_under_name_rotation(pkg):
    c = _controller(pkg, tenant_qps=100.0, tenant_burst=100.0)
    n = pkg.admission._TENANT_STATE_MAX + 64
    for i in range(n):
        with c.admit(tenant=f"t{i}"):
            pass
    assert len(c._buckets) <= pkg.admission._TENANT_STATE_MAX
    # unconfigured tenants share one limits object (nothing cached)
    assert c.config._limits_cache == {}
    assert c.config.limits("t0") is c.config.limits("t999999")


def test_slot_handover_wakes_waiter(pkg):
    c = _controller(pkg, max_concurrency=1, queue_timeout_s=5.0)
    hold = c.admit(pkg.Ctx())
    hold.__enter__()
    admitted = threading.Event()

    def waiter():
        with c.admit(pkg.Ctx()):
            admitted.set()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    assert not admitted.is_set()
    hold.__exit__(None, None, None)
    t.join(5)
    assert admitted.is_set()
    assert c.snapshot() == {"running": 0, "queued": 0, "tenants": {}}


def test_priority_orders_the_queue(pkg):
    c = _controller(pkg, max_concurrency=1, queue_timeout_s=5.0,
                    tenants={"fast": {"priority": 1},
                             "slow": {"priority": 200}})
    hold = c.admit(pkg.Ctx())
    hold.__enter__()
    order = []
    lock = threading.Lock()

    def run(name):
        with c.admit(pkg.Ctx(username=name)):
            with lock:
                order.append(name)
            time.sleep(0.05)

    t_slow = threading.Thread(target=run, args=("slow",))
    t_slow.start()
    time.sleep(0.05)    # slow queues first
    t_fast = threading.Thread(target=run, args=("fast",))
    t_fast.start()
    time.sleep(0.05)
    hold.__exit__(None, None, None)
    t_slow.join(5)
    t_fast.join(5)
    assert order == ["fast", "slow"]


def test_nested_admission_rides_parent_slot(pkg):
    c = _controller(pkg, max_concurrency=1, queue_timeout_s=0.1)
    with c.admit(pkg.Ctx()):
        with c.admit(pkg.Ctx()):    # would deadlock if counted
            assert c.snapshot()["running"] == 1
    assert c.snapshot()["running"] == 0


def test_deadline_expires_in_queue(pkg):
    c = _controller(pkg, max_concurrency=1, queue_timeout_s=10.0)
    hold = c.admit(pkg.Ctx())
    hold.__enter__()
    try:
        result = {}

        def attempt():
            # another thread: in this one the re-entrancy guard would
            # take it for a nested statement
            t0 = time.monotonic()
            try:
                with c.admit(pkg.Ctx(), timeout_s=0.2):
                    result["outcome"] = "admitted"
            except Exception as e:  # noqa: BLE001 - recorded
                result["outcome"] = type(e).__name__
                result["text"] = str(e)
            result["elapsed"] = time.monotonic() - t0

        t = threading.Thread(target=attempt)
        t.start()
        t.join(10)
        assert result["outcome"] == "QueryDeadlineExceededError"
        assert result["text"] == ("query deadline expired in the "
                                  "admission queue")
        assert 0.2 <= result["elapsed"] < 5.0
        # the waiter left no slot and no queue entry behind
        assert c.snapshot() == {"running": 1, "queued": 0,
                                "tenants": {"public": 1}}
    finally:
        hold.__exit__(None, None, None)
    assert c.snapshot()["running"] == 0


def test_deadline_checkpoint_raises_typed(pkg):
    dl = pkg.deadline
    token = dl.bind(dl.Deadline(0.01))
    try:
        time.sleep(0.02)
        with pytest.raises(pkg.errors.QueryDeadlineExceededError):
            pkg.cancellation.checkpoint()
    finally:
        dl.reset(token)
    pkg.cancellation.checkpoint()   # unbound again: nothing


def test_call_timeout_caps_remaining(pkg):
    dl = pkg.deadline
    assert dl.call_timeout() is None
    assert dl.call_timeout(5.0) == 5.0
    token = dl.bind(dl.Deadline(100.0))
    try:
        assert dl.call_timeout(5.0) == 5.0
        assert 99.0 < dl.call_timeout() <= 100.0
    finally:
        dl.reset(token)


@pytest.mark.parametrize("t", [None, 0, -1.0, float("nan"), float("inf"),
                               0.5])
def test_deadline_from_timeout(pkg, t):
    d = pkg.deadline.Deadline.from_timeout(t)
    assert (d is None) == (t != 0.5)
    if d is not None:
        assert 0.0 < d.remaining() <= 0.5 and not d.expired()


def test_scheduler_config_from_options(pkg):
    cfg = pkg.sched.SchedulerConfig.from_options({
        "max_concurrency": 2, "queue_depth": 8, "queue_timeout_s": 1.5,
        "tenant_qps": 3.0, "tenants": {"a": {"qps": 1.0}, "bad": 7}})
    assert (cfg.max_concurrency, cfg.queue_depth, cfg.queue_timeout_s,
            cfg.tenant_qps) == (2, 8, 1.5, 3.0)
    assert sorted(cfg.tenants) == ["a"] and cfg.configured("a")
    lim = cfg.limits("a")
    assert (lim.qps, lim.burst, lim.concurrency, lim.priority) == (
        1.0, 2.0, 0, 100)
    assert cfg.limits("a") is lim
    assert cfg.limits("zzz").qps == 3.0


def test_disabled_controller_never_sheds(pkg):
    c = _controller(pkg, enable=False, max_concurrency=1, tenant_qps=1.0,
                    tenant_burst=1.0)
    for _ in range(3):
        with c.admit(pkg.Ctx()):
            with c.admit(pkg.Ctx(username="x")):
                pass


def _family(name: str) -> dict:
    """label values -> value of a port metric family."""
    from greptimedb_tpu_torch.telemetry import global_registry

    return {k: c.value for k, c in global_registry.get(name)._snapshot()}


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def test_port_tallies_sheds_by_reason():
    """The port's gtpu_sched_* series count admissions, sheds by reason
    and expired deadlines per tenant."""
    names = ("gtpu_sched_admitted_total", "gtpu_sched_shed_total",
             "gtpu_sched_deadline_expired_total")
    c = _controller(PKGS["port"], tenants={"noisy": {"qps": 1.0,
                                                     "burst": 1.0}})
    before = {n: _family(n) for n in names}
    ctx = QueryContext(username="noisy")
    with c.admit(ctx):
        pass
    with pytest.raises(port_errors.QueryOverloadedError):
        with c.admit(ctx):
            pass
    with pytest.raises(port_errors.QueryDeadlineExceededError):
        with c.admit(QueryContext(username="late"), timeout_s=1e-9):
            pass
    d = {n: _delta(before[n], _family(n)) for n in names}
    assert d["gtpu_sched_admitted_total"] == {("noisy",): 1}
    assert d["gtpu_sched_shed_total"] == {("noisy", "qps"): 1,
                                          ("late", "deadline"): 1}
    assert d["gtpu_sched_deadline_expired_total"] == {("late",): 1}


# ---------------------------------------------------------------------
# the instance
# ---------------------------------------------------------------------

def _seed(inst, rows=64):
    inst.sql("create table cpu (ts timestamp time index, host string "
             "primary key, v double)")
    vals = ", ".join(f"('h{i % 8}', {1_700_000_000_000 + i * 1000}, "
                     f"{float(i)})" for i in range(rows))
    inst.execute_sql(f"insert into cpu (host, ts, v) values {vals}")


@pytest.fixture()
def inst(pkg, tmp_path):
    inst = pkg.Standalone(str(tmp_path / "data"))
    yield inst
    inst.close()


def test_over_quota_tenant_shed_while_in_quota_completes(pkg, inst):
    _seed(inst)
    inst.scheduler = _controller(pkg, tenants={"noisy": {"qps": 1.0,
                                                         "burst": 1.0}})
    noisy = pkg.Ctx(username="noisy")
    quiet = pkg.Ctx(username="quiet")
    assert inst.sql("select count(*) from cpu",
                    noisy).cols[0].values[0] == 64
    with pytest.raises(pkg.errors.QueryOverloadedError):
        inst.sql("select count(*) from cpu", noisy)
    for _ in range(3):
        assert inst.sql("select count(*) from cpu",
                        quiet).cols[0].values[0] == 64


def test_statement_deadline_bounds_query(pkg, inst):
    _seed(inst)
    ctx = pkg.Ctx()
    ctx.extensions["deadline_s"] = 1e-9     # lapses before any scan
    with pytest.raises(pkg.errors.QueryDeadlineExceededError):
        inst.sql("select count(*) from cpu", ctx)
    # control-plane statements bypass admission even with the hint
    assert inst.sql("show tables", ctx).num_rows == 1


def test_deadline_raises_at_a_checkpoint(pkg, inst, monkeypatch):
    """A deadline that lapses after admission raises at the statement's
    next checkpoint (the table scan)."""
    _seed(inst)
    real = pkg.deadline.Deadline.from_timeout

    def short(t):
        d = real(t)
        if d is not None:
            d.at = time.monotonic() + 0.05
        return d

    monkeypatch.setattr(pkg.deadline.Deadline, "from_timeout",
                        staticmethod(short))
    ctx = pkg.Ctx()
    ctx.extensions["deadline_s"] = 60.0
    real_check = pkg.cancellation.checkpoint

    def slow_checkpoint():
        time.sleep(0.1)
        real_check()

    monkeypatch.setattr(pkg.cancellation, "checkpoint", slow_checkpoint)
    with pytest.raises(pkg.errors.QueryDeadlineExceededError) as ei:
        inst.sql("select count(*) from cpu", ctx)
    assert str(ei.value) == "query deadline exceeded"


def test_max_execution_time_session_variable(pkg, inst):
    ctx = pkg.Ctx()
    inst.execute_sql("set max_execution_time = 250", ctx)
    adm = inst.scheduler.admit(ctx)
    assert adm._resolve_timeout() == pytest.approx(0.25)
    # an explicit per-request hint (HTTP ?timeout=) wins over it
    ctx.extensions["deadline_s"] = 2.0
    assert inst.scheduler.admit(ctx)._resolve_timeout() == 2.0
    # and the default deadline applies without either
    assert inst.scheduler.admit(pkg.Ctx())._resolve_timeout() == 0.0


def test_show_processlist_has_state_column(pkg, inst):
    res = inst.sql("SHOW PROCESSLIST")
    assert "State" in res.names
    assert "Running" in list(res.column("State").values)


def test_queued_statement_shows_in_processlist(pkg, inst):
    """Under a concurrency limit of one, a second SELECT waits "Queued"
    in SHOW PROCESSLIST until the first releases its slot; both answer."""
    _seed(inst)
    inst.scheduler = _controller(pkg, max_concurrency=1,
                                 queue_timeout_s=10.0)
    hold = inst.scheduler.admit(pkg.Ctx())
    hold.__enter__()
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "rows", inst.sql("select count(*) from cpu", pkg.Ctx()).rows()))
    t.start()
    try:
        states = []
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and "Queued" not in states:
            res = inst.sql("SHOW PROCESSLIST")
            states = [s for s, info in zip(res.column("State").values,
                                           res.column("Info").values)
                      if info == "Select"]
            time.sleep(0.01)
        assert states == ["Queued"]
    finally:
        hold.__exit__(None, None, None)
    t.join(10)
    assert out["rows"] == [[64]]


def test_instance_answers_match_under_admission(tmp_path):
    """The same statements, quotas and deadlines through both
    Standalones: equal answers and equal error classes."""
    got = {}
    for name, p in PKGS.items():
        inst = p.Standalone(str(tmp_path / name))
        try:
            _seed(inst)
            inst.scheduler = _controller(
                p, tenants={"noisy": {"qps": 1.0, "burst": 2.0}})
            seen = []
            for user, deadline in (("noisy", None), ("noisy", None),
                                   ("noisy", None), ("quiet", 1e-9),
                                   ("quiet", None)):
                ctx = p.Ctx(username=user)
                if deadline is not None:
                    ctx.extensions["deadline_s"] = deadline
                try:
                    seen.append(inst.sql("select host, count(*) from cpu "
                                         "group by host order by host",
                                         ctx).rows())
                except p.errors.GreptimeError as e:
                    seen.append((type(e).__name__, str(e),
                                 int(e.status_code)))
            got[name] = seen
        finally:
            inst.close()
    assert got["port"] == got["jax"]
    assert [type(x) for x in got["port"]] == [list, list, tuple, tuple,
                                             list]


# ---------------------------------------------------------------------
# HTTP: 429, 503, 400 and 401
# ---------------------------------------------------------------------

def _call(srv, q, extra="", headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/sql?sql={urllib.parse.quote(q)}"
        f"{extra}", data=b"", headers=headers or {}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            doc = json.loads(r.read())
            doc.pop("execution_time_ms", None)
            return r.status, doc
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_maps_shed_to_429_and_deadline_to_503(tmp_path):
    got = {}
    for name, p in PKGS.items():
        inst = p.Standalone(str(tmp_path / name))
        srv = None
        try:
            _seed(inst, rows=8)
            inst.scheduler = _controller(
                p, tenants={"public": {"qps": 1.0, "burst": 1.0}})
            srv = p.http.HttpServer(inst, port=0).start()
            seen = [_call(srv, "select count(*) from cpu")]
            shed = _call(srv, "select count(*) from cpu")
            assert shed[0] == 429 and "quota" in shed[1]["error"]
            seen.append(shed)
            time.sleep(1.1)     # the bucket refills
            late = _call(srv, "select count(*) from cpu",
                         "&timeout=0.000000001")
            assert late[0] == 503
            seen.append(late)
            time.sleep(1.1)
            for bad in ("nan", "inf", "-1", "0", "bogus"):
                seen.append(_call(srv, "select 1", f"&timeout={bad}"))
                assert seen[-1][0] == 400, bad
            got[name] = seen
        finally:
            if srv is not None:
                srv.stop()
            inst.close()
    assert got["port"] == got["jax"]


def test_http_basic_auth(tmp_path):
    """No credentials or wrong ones answer 401 with a Basic challenge;
    good ones 200; /health stays open; the user is the tenant."""
    got = {}
    for name, p in PKGS.items():
        inst = p.Standalone(str(tmp_path / name))
        provider = p.auth.StaticUserProvider({"admin": "secret",
                                              "alice": "pw"})
        inst.scheduler = _controller(
            p, tenants={"alice": {"qps": 1.0, "burst": 1.0}})
        srv = p.http.HttpServer(inst, port=0,
                                user_provider=provider).start()
        try:
            def auth(user, pwd):
                tok = base64.b64encode(f"{user}:{pwd}".encode()).decode()
                return {"Authorization": f"Basic {tok}"}

            seen = [_call(srv, "select 1"),
                    _call(srv, "select 1", headers=auth("admin", "nope")),
                    _call(srv, "select 1", headers={
                        "Authorization": "Bearer x"}),
                    _call(srv, "select 1", headers=auth("admin", "secret")),
                    _call(srv, "select 1", headers=auth("alice", "pw")),
                    _call(srv, "select 1", headers=auth("alice", "pw")),
                    _call(srv, "select 1", headers=auth("admin", "secret"))]
            assert [s for s, _ in seen] == [401, 401, 401, 200, 200, 429,
                                            200]
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/sql?sql=select%201",
                data=b"", method="POST")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=30)
            assert ei.value.headers["WWW-Authenticate"] == \
                'Basic realm="greptime"'
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/health",
                    timeout=30) as r:
                assert r.status == 200
            got[name] = seen
        finally:
            srv.stop()
            inst.close()
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------
# auth providers
# ---------------------------------------------------------------------

def test_static_user_provider(pkg):
    import hashlib

    h = hashlib.sha256(b"s3").hexdigest()
    p = pkg.auth.StaticUserProvider({"a": "pw", "b": f"sha256:{h}",
                                     "c": ""})
    assert p.authenticate("a", "pw") and not p.authenticate("a", "PW")
    assert p.authenticate("b", "s3") and not p.authenticate("b", h)
    assert p.authenticate("c", "") and not p.authenticate("c", "x")
    assert not p.authenticate("nobody", "")


def test_watch_file_user_provider_reloads(pkg, tmp_path):
    import os

    path = tmp_path / "users"
    path.write_text("# users\nalice = one\n")
    p = pkg.auth.WatchFileUserProvider(str(path))
    assert p.authenticate("alice", "one") and not p.authenticate("bob", "2")
    path.write_text("bob=2\n")
    st = os.stat(path)
    os.utime(path, (st.st_atime, st.st_mtime + 5))
    assert p.authenticate("bob", "2") and not p.authenticate("alice", "one")
    missing = pkg.auth.WatchFileUserProvider(str(tmp_path / "nope"))
    assert not missing.authenticate("bob", "2")


@pytest.mark.parametrize("header,outcome", [
    (None, "missing Authorization header"),
    ("Bearer abc", "missing Authorization header"),
    ("Basic YQ", "malformed Authorization header"),
    ("Basic !!!", "invalid credentials for ''"),
    ("Basic " + base64.b64encode(b"admin:bad").decode(),
     "invalid credentials for 'admin'"),
    ("Basic " + base64.b64encode(b"admin:secret").decode(), "admin"),
])
def test_check_basic_auth(pkg, header, outcome):
    provider = pkg.auth.StaticUserProvider({"admin": "secret"})
    assert pkg.auth.check_basic_auth(header, None) is None
    try:
        got = pkg.auth.check_basic_auth(header, provider)
    except pkg.auth.AccessDeniedError as e:
        got = str(e)
    assert got == outcome
