"""The port's durable storage against the JAX package's.

The same writes, made from a seeded numpy generator, go through the JAX
package's TsdbEngine (Parquet SSTs through pyarrow, msgpack WAL payloads)
and the port's (its own SST format and codec) on device="cpu". Parity is on
what is read back, never on file bytes: scans bit for bit (values,
validity, sequences, ops) after writes, flushes, compactions, a reopen and
a crash before flush; the compaction picker's tasks as (kind, window, input
row counts), since file ids differ; WAL replays as payload-decoded rows.
Compaction merges take the device path (device_merge_min_rows = 1, verified
against the host merge) on the CPU, where the merge runs its plain torch
program.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from greptimedb_tpu.storage import compaction as JC
from greptimedb_tpu.storage import engine as JE
from greptimedb_tpu.storage import region as JR
from greptimedb_tpu.storage import wal as JW
from greptimedb_tpu_torch.catalog.manager import CatalogManager
from greptimedb_tpu_torch.datatypes.schema import Schema
from greptimedb_tpu_torch.errors import SstRestoreError
from greptimedb_tpu_torch.instance import Instance
from greptimedb_tpu_torch.storage import codec
from greptimedb_tpu_torch.storage import compaction as TC
from greptimedb_tpu_torch.storage import engine as TE
from greptimedb_tpu_torch.storage import recovery as TRec
from greptimedb_tpu_torch.storage import region as TR
from greptimedb_tpu_torch.storage import sst as TS
from greptimedb_tpu_torch.storage import wal as TW
from greptimedb_tpu_torch.storage.manifest import RegionManifest
from greptimedb_tpu_torch.storage.memtable import OP_DELETE, OP_PUT
from greptimedb_tpu_torch.storage.object_store import (
    FsObjectStore,
    MemoryObjectStore,
    S3ObjectStore,
    object_store_from_options,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOUR = 3_600_000
U_FIELD = {"u": np.float64}
FIELDS = ["a", "b"]


def _meta(M, rid=1, **opt):
    o = dict(compaction_trigger_files=2, compaction_window_ms=HOUR,
             memtable_window_ms=HOUR)
    o.update(opt)
    return M.RegionMetadata(region_id=rid, table="t", tag_names=["h", "dc"],
                            field_names=FIELDS, ts_name="ts",
                            options=M.RegionOptions(**o))


def _cfg(M, root, **kw):
    comp = kw.pop("compaction", {})
    return M.EngineConfig(
        data_root=root, enable_background=False,
        compaction=(JC if M is JE else TC).CompactionOptions(
            device_merge_min_rows=1, verify_device_merge=True, **comp),
        **kw)


class Pair:
    """A JAX engine and a port engine over the same kind of data root."""

    def __init__(self, tmp_path, **kw):
        self.root = str(tmp_path)
        self.kw = kw
        self.open()

    def open(self, **opt):
        self.je = JE.TsdbEngine(_cfg(JE, self.root + "/jax", **self.kw))
        self.te = TE.TsdbEngine(_cfg(TE, self.root + "/port", **self.kw),
                                device="cpu")
        self.jr = self.je.open_region(_meta(JR, **opt))
        self.tr = self.te.open_region(_meta(TR, **opt))

    def close(self):
        self.je.close()
        self.te.close()

    def both(self, fn):
        fn(self.jr)
        fn(self.tr)


def _batches(seed, n, rows=400, hours=3, hosts=12):
    """Seeded writes: puts with a half-null field, overwrites of earlier
    keys, and deletes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h = rng.integers(0, hosts, rows)
        tags = {"h": np.array([f"h{x}" for x in h], object),
                "dc": np.array([f"dc{x % 3}" for x in h], object)}
        ts = rng.integers(0, hours * 360, rows).astype(np.int64) * 10_000
        if i % 3 == 2:
            out.append((OP_DELETE, tags, ts, None, None))
            continue
        fields = {"a": rng.random(rows), "b": rng.standard_normal(rows)}
        valid = {"b": rng.random(rows) > 0.5}
        out.append((OP_PUT, tags, ts, fields, valid))
    return out


def _apply(region, batch):
    op, tags, ts, fields, valid = batch
    if op == OP_DELETE:
        region.delete(tags, ts)
    else:
        region.write(tags, ts, fields, field_valid=valid)


def _same_rows(want, got, tag=""):
    if want is None or len(want) == 0:
        assert got is None or len(got) == 0, tag
        return
    assert got is not None, tag
    for k in ("sid", "ts", "seq", "op"):
        assert np.array_equal(getattr(want, k), getattr(got, k)), (tag, k)
    assert list(want.fields) == list(got.fields), tag
    for f in want.fields:
        a, b = np.asarray(want.fields[f]), np.asarray(got.fields[f])
        assert a.dtype == b.dtype, (tag, f)
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (tag, f)
    wv, gv = want.field_valid, got.field_valid
    assert (wv is None) == (gv is None), tag
    if wv is not None:
        assert wv.keys() == gv.keys(), tag
        for f in wv:
            assert np.array_equal(wv[f], gv[f]), (tag, f)


def _cmp(pair, tag, **scan):
    want = pair.jr.scan(field_names=FIELDS, **scan).rows
    got = pair.tr.scan(FIELDS, **scan)
    _same_rows(want, got, tag)
    return 0 if got is None else len(got)


def _tasks(M, region, **kw):
    return [(t.kind, t.window, t.output_level, t.drop_deletes,
             sorted(m.rows for m in t.files))
            for t in M.pick_tasks(region, M.CompactionOptions(), **kw)]


# ----------------------------------------------------------------------
# scans through the region's life
# ----------------------------------------------------------------------

@pytest.mark.parametrize("merge_mode", ["last_row", "last_non_null"])
def test_scans_match_jax_through_write_flush_compact_reopen(tmp_path,
                                                            merge_mode):
    pair = Pair(tmp_path)
    pair.close()
    pair.open(merge_mode=merge_mode)
    for i, b in enumerate(_batches(1, 9)):
        pair.both(lambda r: _apply(r, b))
        assert _cmp(pair, f"write{i}") > 0
        if i % 2:
            pair.both(lambda r: r.flush())
            _cmp(pair, f"flush{i}")
    assert _tasks(JC, pair.jr) == _tasks(TC, pair.tr)
    pair.both(lambda r: r.compact())
    _cmp(pair, "compact")
    assert set(pair.tr.merge_paths) == {"device"}
    assert _tasks(JC, pair.jr, force=True) == _tasks(TC, pair.tr,
                                                     force=True)
    pair.both(lambda r: r.compact(force=True))
    _cmp(pair, "force")
    # bounded scans and series selections
    _cmp(pair, "ts", ts_min=HOUR, ts_max=2 * HOUR - 1)
    sids = np.array([1, 4, 7], np.int32)
    _cmp(pair, "sids", sids=sids)
    pair.both(lambda r: _apply(r, _batches(2, 1)[0]))
    pair.close()
    pair.open(merge_mode=merge_mode)
    assert pair.tr.recovery_stats["replayed_entries"] == 0  # close flushed
    _cmp(pair, "reopen")
    pair.close()


def test_picker_levels_and_force_match_jax(tmp_path):
    pair = Pair(tmp_path, compaction={"l1_trigger_files": 2,
                                      "l2_trigger_files": 2})
    batches = _batches(3, 12, rows=200, hours=2)
    for i, b in enumerate(batches):
        pair.both(lambda r: _apply(r, b))
        pair.both(lambda r: r.flush())
        assert _tasks(JC, pair.jr) == _tasks(TC, pair.tr), i
        if i % 4 == 3:
            pair.both(lambda r: r.compact())
            assert (sorted((m.level, m.rows)
                           for m in pair.jr.manifest.state.ssts)
                    == sorted((m.level, m.rows)
                              for m in pair.tr.manifest.state.ssts)), i
            _cmp(pair, f"level{i}")
    assert JC.read_amplification(pair.jr) == TC.read_amplification(pair.tr)
    pair.close()


def test_crash_before_flush_replays_every_acknowledged_row(tmp_path):
    """A child process writes and exits with os._exit before any flush
    (wal_sync=False: the rows survive a process crash); a reopen reads
    every row back, and a second reopen after the recovery flush replays
    nothing."""
    pair = Pair(tmp_path)
    first = _batches(4, 2)
    for b in first:
        pair.both(lambda r: _apply(r, b))
    pair.both(lambda r: r.flush())
    pair.close()
    child = rf"""
import os, sys
sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {ROOT + '/tests'!r})
from test_torch_storage import _batches, _apply, _meta, _cfg
from greptimedb_tpu_torch.storage import engine as TE, region as TR
eng = TE.TsdbEngine(_cfg(TE, {pair.root + '/port'!r}), device="cpu")
r = eng.open_region(_meta(TR))
for b in _batches(5, 4):
    _apply(r, b)
print("ACK", flush=True)
os._exit(0)
"""
    out = subprocess.run([sys.executable, "-c", child], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0 and "ACK" in out.stdout, out.stderr
    # the JAX side: the same writes, its engine never closed either
    je = JE.TsdbEngine(_cfg(JE, pair.root + "/jax"))
    jr = je.open_region(_meta(JR))
    for b in _batches(5, 4):
        _apply(jr, b)
    je2 = JE.TsdbEngine(_cfg(JE, pair.root + "/jax"))
    pair.jr = je2.open_region(_meta(JR))
    pair.te = TE.TsdbEngine(_cfg(TE, pair.root + "/port"), device="cpu")
    pair.tr = pair.te.open_region(_meta(TR))
    assert pair.tr.recovery_stats["replayed_entries"] == 4
    assert "recovery_flush_ms" in pair.tr.recovery_stats
    _cmp(pair, "crash")
    pair.te.close()
    te3 = TE.TsdbEngine(_cfg(TE, pair.root + "/port"), device="cpu")
    tr3 = te3.open_region(_meta(TR))
    assert tr3.recovery_stats["replayed_entries"] == 0
    _same_rows(pair.jr.scan(field_names=FIELDS).rows, tr3.scan(FIELDS))
    te3.close()
    je2.close()


def test_ttl_purge_and_orphan_cleanup_match_jax(tmp_path):
    now = 10 * HOUR
    pair = Pair(tmp_path)
    pair.close()
    pair.open(ttl_ms=6 * HOUR)
    for b in _batches(6, 4, hours=10):
        pair.both(lambda r: _apply(r, b))
        pair.both(lambda r: r.flush())
    n_j = JC.purge_expired(pair.jr, now_ms=now)
    n_t = TC.purge_expired(pair.tr, now_ms=now)
    assert n_j == n_t
    _cmp(pair, "ttl", ts_min=0)
    # an orphan SST (a crash between the SST write and the manifest
    # commit) goes at the next open
    live = pair.tr.manifest.state.ssts[0]
    orphan = f"{pair.tr.prefix}/sst/orphan.sst"
    pair.tr.store.write(orphan, pair.tr.store.read(live.path))
    assert TC.cleanup_orphan_ssts(pair.tr) == 1
    assert not pair.tr.store.exists(orphan)
    assert pair.tr.store.exists(live.path)
    pair.close()


def test_append_mode_keeps_every_row(tmp_path):
    pair = Pair(tmp_path)
    pair.close()
    pair.open(append_mode=True)
    for b in _batches(7, 4):
        if b[0] == OP_PUT:
            pair.both(lambda r: _apply(r, b))
            pair.both(lambda r: r.flush())
    pair.both(lambda r: r.compact(force=True))
    assert _cmp(pair, "append") == 3 * 400
    pair.close()


# ----------------------------------------------------------------------
# WAL backends
# ----------------------------------------------------------------------

def _log_pair(kind, tmp_path):
    if kind == "fs":
        return (JW.RegionWal(str(tmp_path / "j")),
                TW.RegionWal(str(tmp_path / "t")))
    if kind == "object":
        from greptimedb_tpu.storage.object_store import (
            MemoryObjectStore as JMem,
        )

        return (JW.ObjectStoreLogStore(JMem(), "wal/r1"),
                TW.ObjectStoreLogStore(MemoryObjectStore(), "wal/r1"))
    jt = JW.SharedWalTopic(JW.RegionWal(str(tmp_path / "j")))
    tt = TW.SharedWalTopic(TW.RegionWal(str(tmp_path / "t")))
    return JW.TopicRegionLog(jt, 1), TW.TopicRegionLog(tt, 1)


@pytest.mark.parametrize("kind", ["fs", "object", "shared"])
def test_wal_append_replay_obsolete_match_jax(tmp_path, kind):
    jl, tl = _log_pair(kind, tmp_path)
    payloads = [bytes([i]) * (i + 1) for i in range(7)]
    for p in payloads[:3]:
        assert jl.append(p) == tl.append(p)
    assert jl.append_batch(payloads[3:]) == tl.append_batch(payloads[3:])
    for frm in (0, 2, 6, 9):
        assert ([(e.entry_id, e.payload) for e in jl.replay(frm)]
                == [(e.entry_id, e.payload) for e in tl.replay(frm)])
    jl.obsolete(2)
    tl.obsolete(2)
    assert ([e.entry_id for e in jl.replay(3)]
            == [e.entry_id for e in tl.replay(3)])
    assert jl.next_entry_id == tl.next_entry_id == 7


def _tear(kind, tmp_path, log, M):
    """Append a torn record to the log's newest physical unit: a header
    cut mid-write at the tail of a segment file, or a partial object."""
    torn = M._HEADER.pack(M._MAGIC, 99, 40, 0)[:12]
    if kind == "object":
        objs = sorted(m.path for m in log.store.list(log.prefix))
        log.store.write(objs[-1], log.store.read(objs[-1]) + torn)
        return
    d = log.root if kind == "fs" else log.topic.inner.root
    seg = sorted(os.listdir(d))[-1]
    with open(os.path.join(d, seg), "ab") as f:
        f.write(torn)


@pytest.mark.parametrize("kind", ["fs", "object", "shared"])
def test_wal_torn_tail_is_cut_and_later_appends_replay(tmp_path, kind):
    """A record torn mid-append ends replay cleanly on every backend, in
    both packages; a log reopened over it keeps its entry ids."""
    jl, tl = _log_pair(kind, tmp_path)
    got = {}
    for M, log in ((JW, jl), (TW, tl)):
        for i in range(3):
            log.append(b"entry%d" % i)
        _tear(kind, tmp_path / ("j" if M is JW else "t"), log, M)
        got[M] = [(e.entry_id, e.payload) for e in log.replay(0)]
    assert got[JW] == got[TW] == [(0, b"entry0"), (1, b"entry1"),
                                  (2, b"entry2")]
    if kind == "fs":
        for M, d in ((JW, tmp_path / "j"), (TW, tmp_path / "t")):
            wal = M.RegionWal(str(d))
            assert wal.next_entry_id == 3
            wal.append(b"after")
            assert [e.entry_id for e in wal.replay(0)] == [0, 1, 2, 3]
            wal.close()


def test_scan_cache_serves_a_durable_region(tmp_path, monkeypatch):
    """The merged-scan cache works over SSTs: a repeated full scan is a
    hit, a projection is served from it, and a write or a compaction
    changes its key."""
    monkeypatch.setattr(TR, "_SCAN_CACHE_MIN_ROWS", 1)
    pair = Pair(tmp_path)
    for b in _batches(13, 4):
        pair.both(lambda r: _apply(r, b))
        pair.both(lambda r: r.flush())
    tr = pair.tr
    want = tr.scan(FIELDS)
    hits = tr.scan_cache_hits
    _same_rows(want, tr.scan(FIELDS))
    _same_rows(pair.jr.scan(field_names=["a"]).rows, tr.scan(["a"]))
    assert tr.scan_cache_hits == hits + 2
    pair.both(lambda r: r.compact(force=True))
    _cmp(pair, "after compaction")
    assert tr.scan_cache_hits == hits + 2
    pair.close()


@pytest.mark.parametrize("backend", ["fs", "object", "shared"])
def test_engine_wal_backends_recover_unflushed_rows(tmp_path, backend):
    pair = Pair(tmp_path, wal_backend=backend)
    batches = _batches(8, 4)
    for b in batches[:2]:
        pair.both(lambda r: _apply(r, b))
    pair.both(lambda r: r.flush())
    for b in batches[2:]:
        pair.both(lambda r: _apply(r, b))
    # no close (a crash): a second engine over the same root replays
    pair.je = JE.TsdbEngine(_cfg(JE, pair.root + "/jax",
                                 wal_backend=backend))
    pair.te = TE.TsdbEngine(_cfg(TE, pair.root + "/port",
                                 wal_backend=backend), device="cpu")
    pair.jr = pair.je.open_region(_meta(JR))
    pair.tr = pair.te.open_region(_meta(TR))
    assert pair.tr.recovery_stats["replayed_entries"] == 2
    _cmp(pair, backend)
    pair.close()


def test_codec_round_trip():
    cols = {"f": np.array([1.5, -0.0, np.nan]), "i": np.arange(3, dtype=">i8"),
            "u": np.array([1, 2, 3], np.uint64), "s": np.array(["x", None,
                                                               "z"], object),
            "m": np.zeros((2, 3), np.float32), "b": np.array([True, False])}
    out, meta = codec.decode_columns(codec.encode_columns(
        cols, meta={"op": 1, "new_series": [[0, ["a"]]]}))
    assert meta == {"op": 1, "new_series": [[0, ["a"]]]}
    for k, v in cols.items():
        if v.dtype == object:
            assert list(out[k]) == list(v)
        else:
            assert out[k].dtype == v.dtype.newbyteorder("=")
            assert np.array_equal(out[k].view(np.uint8),
                                  v.astype(out[k].dtype).view(np.uint8))
    with pytest.raises(ValueError):
        codec.decode_columns(b"nope")


# ----------------------------------------------------------------------
# SSTs, the page cache, the manifest, restore
# ----------------------------------------------------------------------

def test_sst_prunes_row_groups_by_time_and_sid_index(tmp_path):
    from greptimedb_tpu_torch.storage.memtable import ColumnarRows
    from greptimedb_tpu_torch.storage.page_cache import global_page_cache

    n = 1000
    rng = np.random.default_rng(9)
    rows = ColumnarRows(
        sid=np.repeat(np.arange(10, dtype=np.int32), 100),
        ts=np.tile(np.arange(100, dtype=np.int64) * 1000, 10),
        seq=np.arange(n, dtype=np.uint64), op=np.zeros(n, np.uint8),
        fields={"v": rng.random(n)},
        field_valid={"v": rng.random(n) > 0.1})
    store = FsObjectStore(str(tmp_path))
    meta = TS.write_sst(store, "sst/x.sst", "x", rows, row_group_rows=128)
    f = TS.SstFile.open(store, meta.path)
    assert len(f.groups) == 8 and f.num_rows == n
    global_page_cache.clear()
    got = TS.read_sst(store, meta, sids=np.array([3], np.int32))
    assert np.array_equal(got.sid, np.full(100, 3))
    # one sid lives in two row groups: only they were decoded
    assert len({k[1] for k in global_page_cache._entries}) == 2
    whole = TS.read_sst_bytes(store.read(meta.path))
    assert np.array_equal(whole.fields["v"][whole.field_valid["v"]],
                          rows.fields["v"][rows.field_valid["v"]])
    assert (whole.fields["v"][~whole.field_valid["v"]] == 0).all()
    assert TS.read_sst(store, meta, ts_min=200_000) is None
    # a fulltext column gets its puffin sidecar beside the SST
    fmeta = TS.write_sst(store, "sst/y.sst", "y", rows,
                         fulltext_fields=["v"])
    assert fmeta.fulltext and store.exists(TS.sidecar_path("sst/y.sst"))


def test_manifest_checkpoint_and_torn_checkpoint_fallback(caplog):
    import logging

    store = MemoryObjectStore()
    man = RegionManifest(store, "m", checkpoint_distance=4)
    for i in range(6):
        man.commit({"kind": "edit", "set": {"committed_sequence": i + 1}})
    assert store.exists("m/_checkpoint.json")
    assert len([m for m in store.list("m/")
                if not m.path.endswith("_checkpoint.json")]) < 6
    assert RegionManifest(store, "m").state.committed_sequence == 6
    store.write("m/_checkpoint.json", b"{torn garbage")
    with caplog.at_level(logging.WARNING,
                         logger="greptimedb_tpu_torch.storage.manifest"):
        man2 = RegionManifest(store, "m")
    assert any("torn manifest checkpoint" in r.message
               for r in caplog.records)
    assert man2.version == man.version
    assert man2.state.committed_sequence == 6


def _flushed_region(tmp_path, store, nsst=2):
    r = TR.Region(_meta(TR), store, str(tmp_path / "wal"))
    for b in _batches(10, nsst, rows=100):
        if b[0] == OP_DELETE:
            continue
        _apply(r, b)
        r.flush()
    return r


def test_restore_warms_page_cache_serial_and_pipelined(tmp_path):
    from greptimedb_tpu_torch.storage.page_cache import global_page_cache

    store = MemoryObjectStore()
    region = _flushed_region(tmp_path, store, nsst=5)
    nfiles = len(region.manifest.state.ssts)
    for depth in (0, 4):
        global_page_cache.clear()
        st = TRec.restore_region_ssts(region, prefetch_depth=depth)
        assert st["files"] == nfiles and st["installed_cols"] > 0
    assert TRec.stage_totals()["sst_restore"] > 0
    region.close()


def test_restore_errors_on_torn_or_missing_objects(tmp_path):
    store = MemoryObjectStore()
    region = _flushed_region(tmp_path, store, nsst=2)
    victim = region.manifest.state.ssts[1]
    store.write(victim.path, store.read(victim.path)[:-7])
    with pytest.raises(SstRestoreError, match="torn") as ei:
        TRec.restore_region_ssts(region, prefetch_depth=4)
    assert victim.path in str(ei.value)
    store.delete(victim.path)
    with pytest.raises(SstRestoreError, match="missing"):
        TRec.restore_region_ssts(region, prefetch_depth=0)
    region.close()


def test_object_store_options_and_s3_refused(tmp_path):
    assert isinstance(object_store_from_options({"type": "memory"},
                                                str(tmp_path)),
                      MemoryObjectStore)
    cached = object_store_from_options(
        {"type": "memory", "cache_capacity_bytes": 1 << 20}, str(tmp_path))
    cached.write("a/b", b"xyz")
    assert cached.read_range("a/b", 1, 2) == b"yz"
    with pytest.raises(Exception, match="network"):
        S3ObjectStore(bucket="b", endpoint="e")
    with pytest.raises(Exception, match="network"):
        object_store_from_options({"type": "s3"}, str(tmp_path))


# ----------------------------------------------------------------------
# the engine: parallel and racing opens
# ----------------------------------------------------------------------

def test_parallel_and_racing_opens(tmp_path):
    cfg = _cfg(TE, str(tmp_path))
    eng = TE.TsdbEngine(cfg, device="cpu")
    metas = [_meta(TR, rid=i) for i in range(1, 5)]
    for m in metas:
        r = eng.create_region(m)
        _apply(r, _batches(11, 1)[0])
    eng.close()
    eng = TE.TsdbEngine(cfg, device="cpu")
    regions = eng.open_regions(metas, parallelism=4)
    assert [r.meta.region_id for r in regions] == [1, 2, 3, 4]
    assert all(r.recovery_stats["replayed_entries"] == 0 for r in regions)
    eng.close()
    eng = TE.TsdbEngine(cfg, device="cpu")
    got = []
    ths = [threading.Thread(target=lambda: got.append(
        eng.open_region(metas[0]))) for _ in range(6)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    assert len(got) == 6 and all(r is got[0] for r in got)
    assert eng.region(1) is got[0]
    eng.drop_region(1)
    with pytest.raises(Exception, match="not found"):
        eng.region(1)
    eng.close()


def test_maintenance_flushes_over_budget_and_compacts(tmp_path):
    cfg = _cfg(TE, str(tmp_path), global_write_buffer_bytes=1)
    eng = TE.TsdbEngine(cfg, device="cpu")
    r = eng.create_region(_meta(TR))
    for b in _batches(12, 6):
        _apply(r, b)
        eng.run_maintenance()
    assert r.memtable.is_empty
    eng.compaction.close()
    assert TC.read_amplification(r) >= 1
    eng.close()


# ----------------------------------------------------------------------
# tables, the catalog, restart snapshots
# ----------------------------------------------------------------------

def _durable_catalog(root):
    eng = TE.TsdbEngine(TE.EngineConfig(data_root=root,
                                        enable_background=False),
                        device="cpu")
    return eng, CatalogManager(eng)


def _tsbs(table, hosts=16, hours=2, seed=0):
    rng = np.random.default_rng(seed)
    names = np.array([f"host_{i}" for i in range(hosts)], object)
    region_of = np.array(["r0", "r1", "r2"], object)[np.arange(hosts) % 3]
    for h in range(hours):
        ts = np.tile(np.arange(h * 360, (h + 1) * 360) * 10_000, hosts)
        hi = np.repeat(np.arange(hosts), 360)
        table.write({"hostname": names[hi], "region": region_of[hi]},
                    ts.astype(np.int64), {"u": rng.random(len(ts))})
        table.flush()


_Q2 = ("SELECT ts, region, count(u) RANGE '2h', sum(u) RANGE '2h', "
       "max(u) RANGE '2h' FROM cpu ALIGN '1h' BY (region)")


def _bits(res):
    out = []
    for c in res.cols:
        v = np.asarray(c.values)
        out.append(list(v) if v.dtype == object else v.tobytes())
        out.append(np.asarray(c.valid_mask).tobytes())
    return out


def test_catalog_reopens_tables_and_snapshots_restore(tmp_path):
    root = str(tmp_path)
    eng, cat = _durable_catalog(root)
    t = cat.create_table("public", "cpu",
                         Schema.of("ts", ["hostname", "region"], U_FIELD),
                         options={"compaction_trigger_files": 2,
                                  "compaction_window_ms": HOUR})
    with pytest.raises(Exception, match="already exists"):
        cat.create_table("public", "cpu", Schema.of("ts", [], U_FIELD))
    _tsbs(t)
    t.compact()
    inst = Instance(device="cpu", prefer_device=True, catalog=cat)
    want = inst.sql(_Q2)
    assert inst.query_engine.last_grid == "built"
    entry = next(iter(inst.query_engine.range_cache._entries.values()))
    entry.persist_thread.join()
    eng.close()
    # a fresh process: catalog, regions and the grid come back
    eng, cat = _durable_catalog(root)
    t2 = cat.table("public", "cpu")
    assert t2.region.recovery_stats["replayed_entries"] == 0
    inst = Instance(device="cpu", prefer_device=True, catalog=cat)
    got = inst.sql(_Q2)
    assert inst.query_engine.last_grid == "restored"
    assert _bits(got) == _bits(want)
    # a write makes the snapshot stale: it is deleted when found
    t2.write({"hostname": np.array(["host_0"], object),
              "region": np.array(["r0"], object)},
             np.array([7_200_000], np.int64), {"u": np.array([1.0])})
    inst = Instance(device="cpu", prefer_device=True, catalog=cat)
    inst.sql(_Q2)
    assert inst.query_engine.last_grid == "built"
    cat.drop_table("public", "cpu")
    eng.close()
    eng, cat = _durable_catalog(root)
    assert cat.maybe_table("public", "cpu") is None
    eng.close()


def test_snapshot_warm_and_stale_file_deleted(tmp_path):
    from greptimedb_tpu_torch.query import device_range as DR

    eng, cat = _durable_catalog(str(tmp_path))
    t = cat.create_table("public", "cpu",
                         Schema.of("ts", ["hostname", "region"], U_FIELD))
    _tsbs(t, hours=1)
    inst = Instance(device="cpu", prefer_device=True, catalog=cat)
    inst.sql(_Q2)
    entry = next(iter(inst.query_engine.range_cache._entries.values()))
    entry.persist_thread.join()
    snaps = t.region.store.list(f"{t.region.prefix}/{DR._SNAP_DIRNAME}/")
    assert len(snaps) == 1
    cold = Instance(device="cpu", prefer_device=True, catalog=cat)
    assert DR.warm_from_snapshots(cold.query_engine, cat) == 1
    cold.sql(_Q2)
    assert cold.query_engine.last_grid == "hit"
    t.write({"hostname": np.array(["host_1"], object),
             "region": np.array(["r1"], object)},
            np.array([5], np.int64), {"u": np.array([2.0])})
    assert DR.load_entry_snapshot(t, 3_600_000, 0, device="cpu") is None
    assert t.region.store.list(
        f"{t.region.prefix}/{DR._SNAP_DIRNAME}/") == []
    eng.close()


def test_in_memory_table_keeps_the_memory_path():
    from greptimedb_tpu_torch.catalog.table import Table

    t = Table("m", ts_name="ts", tag_names=["h"], fields=["v"])
    assert not t.region.durable and t.flush() is None
    t.write({"h": np.array(["a", "a"], object)}, np.array([1, 2]),
            {"v": np.array([1.0, 2.0])})
    t.write({"h": np.array(["a"], object)}, np.array([1]),
            {"v": np.array([5.0])})
    assert t.compact(device="cpu") == 1
    rows = t.scan().rows
    assert list(rows.fields["v"]) == [5.0, 2.0]
    t.region.truncate()
    assert t.scan().rows is None
