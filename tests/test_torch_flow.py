"""Flows (continuous aggregation) through the port against the JAX package.

The cases of tests/test_flow.py run through
`greptimedb_tpu_torch.instance.Standalone(tmp, device="cpu")` (flow state
on the CPU: kernel G's plain version) and
`greptimedb_tpu.instance.Standalone(tmp)`, the same statements and writes
on both. The sink tables must be equal cell for cell (floats bit for bit;
the sink's `update_at` column holds the wall clock of each tick and is
left out), and so must every device flow's state: capacity, key rows,
dirty bits and each slot's bits. The port runs with x64 on, as the JAX
package's tests do (tests/conftest.py); the cases with float aggregates
run again with the port's default x64=False against the JAX package with
jax_enable_x64 switched off around each of its calls (float32 state
slots on both). Every tolerance is exact: XLA:CPU's optimized HLO of the
flow programs (the apply: scatters on materialized updates, a true
division for the batch mean; the finalize: the variance's one fnmadd,
which the port copies) leaves no reordered or contracted float op the
port does not reproduce.
"""

import contextlib
import math
import struct
import threading

import jax
import numpy as np
import pytest

from greptimedb_tpu.instance import Standalone as JaxStandalone
from greptimedb_tpu_torch.instance import Standalone

# the cases with float aggregates run in both modes
X64_MODES = pytest.mark.parametrize("x64", [True, False],
                                    ids=["x64", "f32"])


@contextlib.contextmanager
def jax_x64(on: bool):
    """jax_enable_x64 set to `on` for the block."""
    saved = bool(jax.config.read("jax_enable_x64"))
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", saved)


def _cell(v):
    """A sink cell for an exact comparison: floats by their bits."""
    if isinstance(v, (float, np.floating)):
        return ("f", struct.pack("<d", float(v)))
    if isinstance(v, np.integer):
        return int(v)
    return v


class FlowPair:
    """A port Standalone on the CPU and a JAX Standalone, each over its
    own data root, with flows enabled and ticked by hand."""

    def __init__(self, tmp_path, *, x64: bool = True, **kw):
        self.x64 = x64
        self.kw = kw
        self.roots = (str(tmp_path / "port"), str(tmp_path / "jax"))
        self.open()

    def mode(self):
        return jax_x64(self.x64)

    def open(self):
        self.port = Standalone(self.roots[0], device="cpu", x64=self.x64,
                               warm_start=False, **self.kw)
        self.port.enable_flows(tick_interval_s=3600)
        with self.mode():
            self.jax = JaxStandalone(self.roots[1], warm_start=False,
                                     **self.kw)
            self.jax.enable_flows(tick_interval_s=3600)

    def close(self):
        self.port.close()
        with self.mode():
            self.jax.close()

    def reopen(self):
        self.close()
        self.open()

    def both(self, fn):
        """(fn(port), fn(jax)), the JAX call in the pair's mode."""
        got = fn(self.port)
        with self.mode():
            want = fn(self.jax)
        return got, want

    def sql(self, text):
        return self.both(lambda inst: inst.sql(text))

    def flush(self):
        self.both(lambda inst: inst.flows.flush_all())

    def write(self, table, data, valid=None):
        """The columnar write of `_insert`, then the flows' delta."""
        valid = valid or {k: np.ones(len(v), bool) for k, v in data.items()}

        def go(inst):
            t = inst.catalog.table("public", table)
            inst._write_columns(t, data, valid)
            inst._notify_flows("public", table, t, data, valid)

        self.both(go)

    def same_sink(self, table, order):
        """The sink tables cell for cell (update_at left out); returns the
        port's rows."""
        got, want = self.sql(f"SELECT * FROM {table} ORDER BY {order}")
        assert got.names == want.names
        keep = [i for i, n in enumerate(got.names) if n != "update_at"]
        rows = [[row[i] for i in keep] for row in got.rows()]
        ref = [[row[i] for i in keep] for row in want.rows()]
        assert [[_cell(v) for v in r] for r in rows] == \
            [[_cell(v) for v in r] for r in ref], f"{table}:\n{rows}\n{ref}"
        return rows

    def same_state(self, name):
        """The two flows' device states bit for bit (or both on the host
        path); returns the port's."""
        p = self.port.flows.maybe_flow(name).device_state
        j = self.jax.flows.maybe_flow(name).device_state
        assert (p is None) == (j is None)
        if p is None:
            return None
        assert p.capacity == j.capacity
        assert p.key_rows() == j.key_rows()
        assert np.array_equal(p.dirty, j.dirty)
        assert len(p.state) == len(j.state)
        for i, (a, b) in enumerate(zip(p.state, j.state)):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype, (i, a.dtype, b.dtype)
            assert a.tobytes() == b.tobytes(), f"slot {i} of {name}"
        return p

    def no_failures(self):
        assert self.port.flows.failed_applies == 0
        assert self.port.flows.failed_ticks == 0


@pytest.fixture
def make_pair(tmp_path):
    pairs = []

    def make(x64=True, **kw):
        p = FlowPair(tmp_path / f"pair{len(pairs)}", x64=x64, **kw)
        pairs.append(p)
        return p

    yield make
    for p in pairs:
        p.close()


def _setup_source(pair):
    pair.sql(
        "CREATE TABLE requests (host STRING, status STRING, latency DOUBLE, "
        "ts TIMESTAMP TIME INDEX, PRIMARY KEY (host, status))"
    )


@X64_MODES
def test_create_flow_and_aggregate(make_pair, x64):
    pair = make_pair(x64)
    _setup_source(pair)
    pair.sql(
        "CREATE FLOW req_stats SINK TO req_summary AS "
        "SELECT date_bin('1 minute', ts) AS time_window, host, "
        "count(*) AS total, avg(latency) AS avg_latency "
        "FROM requests GROUP BY time_window, host"
    )
    assert pair.port.flows.flow_names() == ["req_stats"]
    pair.sql(
        "INSERT INTO requests VALUES "
        "('h1', '200', 10.0, 1700000000000), "
        "('h1', '200', 20.0, 1700000010000), "
        "('h2', '500', 30.0, 1700000020000), "
        "('h1', '200', 40.0, 1700000070000)"
    )
    pair.flush()
    got, want = pair.sql(
        "SELECT time_window, host, total, avg_latency FROM req_summary "
        "ORDER BY time_window, host"
    )
    assert got.rows() == want.rows() == [
        [1699999980000, "h1", 2, 15.0],
        [1699999980000, "h2", 1, 30.0],
        [1700000040000, "h1", 1, 40.0],
    ]
    pair.same_sink("req_summary", "time_window, host")
    pair.same_state("req_stats")
    pair.no_failures()


@X64_MODES
def test_flow_incremental_updates(make_pair, x64):
    pair = make_pair(x64)
    _setup_source(pair)
    pair.sql(
        "CREATE FLOW agg SINK TO sums AS "
        "SELECT date_bin('1 minute', ts) AS w, host, sum(latency) AS s "
        "FROM requests GROUP BY w, host"
    )
    pair.sql("INSERT INTO requests VALUES ('h1', '200', 5.0, 1700000000000)")
    pair.flush()
    assert pair.same_sink("sums", "w, host") == [[1699999980000, "h1", 5.0]]
    # a second insert into the SAME window updates the row
    pair.sql("INSERT INTO requests VALUES ('h1', '200', 7.0, 1700000030000)")
    pair.flush()
    assert pair.same_sink("sums", "w, host") == [[1699999980000, "h1", 12.0]]
    pair.same_state("agg")


def test_flow_with_where_filter(make_pair):
    pair = make_pair()
    _setup_source(pair)
    pair.sql(
        "CREATE FLOW errors SINK TO error_counts AS "
        "SELECT date_bin('1 minute', ts) AS w, host, count(*) AS errors "
        "FROM requests WHERE status = '500' GROUP BY w, host"
    )
    pair.sql(
        "INSERT INTO requests VALUES "
        "('h1', '200', 1.0, 1700000000000), "
        "('h1', '500', 2.0, 1700000010000), "
        "('h1', '500', 3.0, 1700000020000)"
    )
    pair.flush()
    got, want = pair.sql("SELECT host, errors FROM error_counts")
    assert got.rows() == want.rows() == [["h1", 2]]
    pair.same_sink("error_counts", "w, host")
    pair.same_state("errors")


@X64_MODES
def test_flow_min_max(make_pair, x64):
    pair = make_pair(x64)
    _setup_source(pair)
    pair.sql(
        "CREATE FLOW mm SINK TO minmax AS "
        "SELECT host, min(latency) AS lo, max(latency) AS hi "
        "FROM requests GROUP BY host"
    )
    pair.sql(
        "INSERT INTO requests VALUES ('h1', '200', 3.0, 1700000000000), "
        "('h1', '200', 9.0, 1700000010000)"
    )
    pair.flush()
    got, want = pair.sql("SELECT host, lo, hi FROM minmax")
    assert got.rows() == want.rows() == [["h1", 3.0, 9.0]]
    pair.same_state("mm")


def test_flow_show_and_drop(make_pair):
    pair = make_pair()
    _setup_source(pair)
    pair.sql("CREATE FLOW f1 SINK TO s1 AS "
             "SELECT host, count(*) AS c FROM requests GROUP BY host")
    got, want = pair.sql("SHOW FLOWS")
    assert got.rows() == want.rows() == [["f1"]]
    got, want = pair.sql("SHOW CREATE FLOW f1")
    assert got.rows() == want.rows()
    # information_schema, the JAX test's second check
    got, want = pair.sql("SELECT flow_name, source_table, sink_table, "
                         "processed_rows FROM information_schema.flows")
    assert got.names == want.names
    assert got.rows() == want.rows() == [["f1", "requests", "s1", 0]]
    pair.sql("DROP FLOW f1")
    assert pair.port.flows.flow_names() == pair.jax.flows.flow_names() == []


@X64_MODES
def test_flow_survives_restart(make_pair, x64):
    pair = make_pair(x64)
    _setup_source(pair)
    pair.sql(
        "CREATE FLOW agg SINK TO sums AS "
        "SELECT date_bin('1 minute', ts) AS w, host, sum(latency) AS s "
        "FROM requests GROUP BY w, host"
    )
    pair.sql("INSERT INTO requests VALUES ('h1', '200', 5.0, 1700000000000)")
    pair.flush()
    pair.reopen()
    assert pair.port.flows.flow_names() == ["agg"]
    # the state was re-derived from the source at load
    pair.same_state("agg")
    # new inserts keep flowing into the sink after the restart
    pair.sql("INSERT INTO requests VALUES ('h2', '200', 8.0, 1700000005000)")
    pair.flush()
    rows = pair.same_sink("sums", "w, host")
    assert [1699999980000, "h2", 8.0] in rows
    pair.same_state("agg")
    pair.no_failures()


@X64_MODES
def test_flow_through_influx_ingest(make_pair, x64):
    from greptimedb_tpu.servers.influx import write_lines as jax_lines
    from greptimedb_tpu_torch.servers.influx import write_lines

    pair = make_pair(x64)
    _setup_source(pair)
    pair.sql(
        "CREATE FLOW agg SINK TO sums AS "
        "SELECT host, sum(latency) AS s FROM requests GROUP BY host"
    )
    body = ("requests,host=h9,status=200 latency=4.5 1700000000000\n"
            "requests,host=h9,status=200 latency=5.5 1700000001000\n")
    write_lines(pair.port, body, precision="ms")
    with pair.mode():
        jax_lines(pair.jax, body, precision="ms")
    pair.flush()
    got, want = pair.sql("SELECT host, s FROM sums")
    assert got.rows() == want.rows() == [["h9", 10.0]]
    pair.same_state("agg")


def test_flow_through_remote_write(make_pair):
    """Remote write feeds flows as the JAX package's apply_series does."""
    from greptimedb_tpu.servers.prom_store import apply_series as jax_apply
    from greptimedb_tpu_torch.servers.prom_store import apply_series

    pair = make_pair()
    series = [({"__name__": "m", "job": j}, [(float(i + 1), 1000 * i)
                                             for i in range(4)])
              for j in ("a", "b")]

    def send():
        # apply_series pops __name__: each package gets its own copy
        apply_series(pair.port, [(dict(lab), list(s)) for lab, s in series])
        with pair.mode():
            jax_apply(pair.jax, [(dict(lab), list(s)) for lab, s in series])

    send()
    pair.sql("CREATE FLOW rw SINK TO rw_out AS SELECT job, "
             "sum(greptime_value) AS s, count(greptime_value) AS c "
             "FROM m GROUP BY job")
    send()
    pair.flush()
    pair.same_sink("rw_out", "job")
    got, want = pair.sql("SELECT job, s, c FROM rw_out ORDER BY job")
    assert got.rows() == want.rows() == [["a", 10.0, 4.0], ["b", 10.0, 4.0]]
    pair.same_state("rw")


@X64_MODES
def test_flow_tagless_global_aggregate(make_pair, x64):
    pair = make_pair(x64)
    _setup_source(pair)
    pair.sql(
        "CREATE FLOW tot SINK TO totals AS "
        "SELECT count(*) AS n, sum(latency) AS s FROM requests "
        "GROUP BY status"
    )
    pair.sql(
        "INSERT INTO requests VALUES ('h1', '200', 1.0, 1700000000000), "
        "('h2', '200', 2.0, 1700000000000)"
    )
    pair.flush()
    got, want = pair.sql("SELECT n, s FROM totals")
    assert got.rows() == want.rows() == [[2, 3.0]]
    pair.same_state("tot")


@X64_MODES
def test_flow_non_windowed_upserts_not_appends(make_pair, x64):
    pair = make_pair(x64)
    _setup_source(pair)
    pair.sql(
        "CREATE FLOW agg SINK TO sums AS "
        "SELECT host, sum(latency) AS s FROM requests GROUP BY host"
    )
    pair.sql("INSERT INTO requests VALUES ('h1', '200', 5.0, 1700000000000)")
    pair.flush()
    pair.sql("INSERT INTO requests VALUES ('h1', '200', 7.0, 1700000030000)")
    pair.flush()
    got, want = pair.sql("SELECT host, s FROM sums")
    # one row per group: each flush overwrites (upsert), never appends
    assert got.rows() == want.rows() == [["h1", 12.0]]


@X64_MODES
def test_backfill_recovery_tick_does_not_deadlock(make_pair, x64):
    """flush_all's restart-recovery backfill must not self-deadlock on the
    non-reentrant flow lock, and must re-derive state from the source."""
    pair = make_pair(x64, prefer_device=False)
    pair.sql("create table s (host string primary key, v double, "
             "ts timestamp time index)")
    pair.sql("create flow f sink to sums as select "
             "date_bin('1 minute', ts) as w, host, count(*) as n, "
             "sum(v) as t from s group by w, host")
    pair.sql("insert into s values ('a', 1.0, 1000), ('a', 2.0, 2000)")

    def recover(inst):
        flow = inst.flows.maybe_flow("f")
        # a restart that could not backfill at load time
        flow.state = {}
        flow.device_state = None
        flow.needs_backfill = True
        done = threading.Event()

        def run():
            with pair.mode():
                inst.flows.flush_all()
            done.set()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert done.wait(30), "flush_all deadlocked in backfill recovery"
        assert not flow.needs_backfill

    pair.both(recover)
    got, want = pair.sql("select host, n, t from sums order by host")
    assert got.rows() == want.rows() == [["a", 2, 3.0]]
    pair.same_state("f")
    pair.no_failures()


def test_flow_ddl_errors_match(make_pair):
    """Duplicate CREATE, DROP and flush of a missing flow fail alike."""
    pair = make_pair()
    _setup_source(pair)
    sql = ("CREATE FLOW d SINK TO d_out AS SELECT host, count(*) AS c "
           "FROM requests GROUP BY host")
    pair.sql(sql)

    def err(inst, text):
        try:
            inst.sql(text)
        except Exception as e:  # noqa: BLE001 - the class is compared
            return type(e).__name__
        return None

    for text in (sql, "DROP FLOW nope", "ADMIN flush_flow('nope')",
                 "SHOW CREATE FLOW nope"):
        got, want = pair.both(lambda inst: err(inst, text))
        assert got == want and got is not None, text
    pair.sql(sql.replace("CREATE FLOW", "CREATE FLOW IF NOT EXISTS"))
    pair.sql("DROP FLOW IF EXISTS nope")
    assert pair.port.flows.flow_names() == ["d"]


def test_port_flow_state_runs_on_the_engines_device(tmp_path):
    """The device state follows the query engine: its device and its x64
    mode (float32 slots by default, float64 with x64=True)."""
    import torch

    for x64, dt in ((False, torch.float32), (True, torch.float64)):
        inst = Standalone(str(tmp_path / f"d{x64}"), device="cpu", x64=x64,
                          warm_start=False)
        try:
            inst.sql("CREATE TABLE t (h STRING PRIMARY KEY, v DOUBLE, "
                     "ts TIMESTAMP TIME INDEX)")
            inst.sql("CREATE FLOW f SINK TO o AS SELECT h, max(v) AS m "
                     "FROM t GROUP BY h")
            inst.sql("INSERT INTO t VALUES ('a', 1.5, 1000)")
            ds = inst.flows.maybe_flow("f").device_state
            assert ds.state[0].dtype == dt
            assert ds.state[0].device.type == "cpu"
            assert math.isinf(float(ds.state[0][1]))
        finally:
            inst.close()


def test_writers_and_the_tick_thread_lose_no_delta(tmp_path):
    """Eight writer threads and a 1 ms tick thread on one flow (more
    threads than cores, a short switch interval): every delta lands once
    in the device state and the sink, and nothing fails."""
    import sys

    inst = Standalone(str(tmp_path / "d"), device="cpu", warm_start=False)
    inst.enable_flows(tick_interval_s=0.001)
    inst.sql("CREATE TABLE t (h STRING PRIMARY KEY, v DOUBLE, "
             "ts TIMESTAMP TIME INDEX)")
    inst.sql("CREATE FLOW f SINK TO o AS SELECT h, count(v) AS c, "
             "sum(v) AS s, max(v) AS m FROM t GROUP BY h")
    table = inst.catalog.table("public", "t")
    writers, deltas, rows = 8, 12, 50
    errors = []

    def write(w):
        try:
            for k in range(deltas):
                ts = np.arange(rows, dtype=np.int64) + 1000 * (w * deltas + k)
                data = {"h": np.asarray([f"h{i % 5}" for i in range(rows)],
                                        object),
                        "ts": ts, "v": np.ones(rows)}
                valid = {c: np.ones(rows, bool) for c in data}
                inst._write_columns(table, data, valid)
                inst._notify_flows("public", "t", table, data, valid)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=write, args=(w,))
                   for w in range(writers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    try:
        assert errors == []
        inst.flows.flush_all()
        per_group = writers * deltas * rows // 5
        rows_out = inst.sql("SELECT h, c, s, m FROM o ORDER BY h").rows()
        assert rows_out == [[f"h{i}", float(per_group), float(per_group),
                             1.0] for i in range(5)]
        assert inst.flows.ticks > 0
        assert inst.flows.failed_applies == inst.flows.failed_ticks == 0
    finally:
        inst.close()
