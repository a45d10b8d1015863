"""Card-resident dictionary-coded label plane: device matcher masks (the
JAX package's index/device_plane.py on torch).

The PromQL device paths need an (S_pad,) bool mask per matcher set. The
host path computes it over the numpy label plane and uploads S_pad bytes
per DISTINCT matcher set. This module keeps the label plane itself
resident on the card — the (S_pad, num_tags) int32 code matrix, cut over
the series axis like every other grid (one row slice per shard, on the
shard's device) — and computes masks there: per query, only the
per-DISTINCT-VALUE ok-tables move, the gather+AND runs where the data
already lives, and the result feeds the fused programs without a host
round trip.

Padded rows (sid >= num_series) carry a per-column sentinel code whose
ok-table entry is always False, so the mask is padded-False by
construction. Ok-tables are padded to powers of two with a False tail.
The gather+AND is plain torch (`index_select` and `&`), as the JAX
package's is XLA (`jnp.take`), not a Pallas kernel. Nothing here falls
back to the host mask when a device op fails: the error propagates.

Planes are version-validated against the registry (like the postings in
tag_index.py), one per (registry, s_pad, shard devices), at most
`_MAX_PLANES`, each with at most `_MAX_MASKS` memoized masks. The JAX
package registers them as a device memory pool (ROADMAP A9); here
`pool_stats()`/`pool_buffers()` report what that pool reports and
`stats()` adds the bytes moved.
"""

from __future__ import annotations

import time
import weakref
from collections import OrderedDict

import numpy as np
import torch

from greptimedb_tpu_torch import concurrency
from greptimedb_tpu_torch.device import resolve_device
from greptimedb_tpu_torch.storage.series import missing_tag_ok, ok_codes_for

_MAX_PLANES = 8
_MAX_MASKS = 128

_LOCK = concurrency.Lock()
_PLANES: "OrderedDict[tuple, _Plane]" = OrderedDict()
_TALLY = {"hits": 0, "misses": 0, "evictions": 0, "builds": 0,
          "build_ms": 0.0, "plane_upload_bytes": 0, "mask_hits": 0,
          "mask_misses": 0, "ok_upload_bytes": 0}


class _Plane:
    __slots__ = ("registry_ref", "version", "s_pad", "num_series",
                 "dev_codes", "devices", "nbytes", "mask_cache",
                 "tag_names")

    def __init__(self, registry, version, s_pad, dev_codes, devices,
                 nbytes):
        self.registry_ref = weakref.ref(registry)
        self.version = version
        self.s_pad = s_pad
        self.num_series = registry.num_series
        # per shard (s_pad / shards, k) int32 on the shard's device
        self.dev_codes = dev_codes
        self.devices = devices
        self.nbytes = nbytes
        self.tag_names = list(registry.tag_names)
        # matcher key -> (per-shard masks, any_match): what the PromQL
        # entry's match_cache stores, computed on the card here
        self.mask_cache: OrderedDict = OrderedDict()


def _pow2(n: int) -> int:
    p = 8
    while p < n:
        p <<= 1
    return p


def _devices(devices) -> list[torch.device]:
    if not devices:
        return [resolve_device(None)]
    return [torch.device(d) for d in devices]


def _gather_and(codes: torch.Tensor, cols: list[int], oks: list):
    """One shard's mask: each referenced column's codes index its
    ok-table; the mask is the conjunction."""
    m = None
    for c, ok in zip(cols, oks):
        t = ok.index_select(0, codes[:, c])
        m = t if m is None else (m & t)
    return m


def _ok_tables(p: _Plane, registry, matchers):
    """(referenced plane columns, their host ok-tables) for a matcher set:
    each evaluated once per distinct dictionary value and padded to a
    power of two with a False tail, so padded plane rows (code == dict
    size) and codes interned since both read False. None when a matcher
    on a missing tag makes the set constant-false."""
    cols: list[int] = []
    oks: list[np.ndarray] = []
    for name, op, value in matchers:
        if name not in p.tag_names:
            if not missing_tag_ok(op, value):
                return None
            continue
        i = p.tag_names.index(name)
        vals = np.asarray(list(registry.dicts[i].values), dtype=object)
        ok = ok_codes_for(vals, op, value)
        padded = np.zeros(_pow2(len(ok) + 1), dtype=bool)
        padded[: len(ok)] = ok
        cols.append(i)
        oks.append(padded)
    return cols, oks


def _get_plane(registry, s_pad: int, devices) -> _Plane | None:
    version = registry.version
    key = (id(registry), s_pad, tuple(str(d) for d in devices))
    with _LOCK:
        p = _PLANES.get(key)
        if (p is not None and p.version == version
                and p.registry_ref() is registry):
            _PLANES.move_to_end(key)
            _TALLY["hits"] += 1
            return p
        _TALLY["misses"] += 1
    t0 = time.perf_counter()
    codes = registry.codes_matrix()
    n, k = codes.shape
    if k == 0 or s_pad < n or s_pad % len(devices):
        return None
    plane = np.empty((s_pad, k), dtype=np.int32)
    plane[:n] = codes
    # padded rows get each column's sentinel code (== dict size); the
    # ok-tables below always hold False there, so padded rows never match
    for i in range(k):
        plane[n:, i] = len(registry.dicts[i])
    per = s_pad // len(devices)
    dev = [torch.from_numpy(plane[j * per:(j + 1) * per]).to(d)
           for j, d in enumerate(devices)]
    p = _Plane(registry, version, s_pad, dev, devices, int(plane.nbytes))
    with _LOCK:
        _PLANES[key] = p
        _PLANES.move_to_end(key)
        while len(_PLANES) > _MAX_PLANES:
            _PLANES.popitem(last=False)
            _TALLY["evictions"] += 1
        _TALLY["builds"] += 1
        _TALLY["build_ms"] += (time.perf_counter() - t0) * 1000.0
        _TALLY["plane_upload_bytes"] += int(plane.nbytes)
    return p


def matcher_mask_dev(registry, matchers, s_pad: int, devices=None,
                     num_series: int | None = None):
    """(per-shard (s_pad / shards,) bool masks on the shards' devices,
    any_match) for a matcher set, or None when the device plane can't
    serve it (disabled, tagless registry, `s_pad` short of the registry,
    or a constant matcher set with no indexable column — callers take the
    host mask + upload path). `devices` are the shards' devices in shard
    order (None: the card). `num_series` is the caller's view of the
    series count: a plane built over a registry that has since grown past
    it would mark rows the caller considers padding, so the mismatch
    returns None too."""
    from greptimedb_tpu_torch.index import tag_index

    if not tag_index.device_plane_enabled():
        return None
    devices = _devices(devices)
    p = _get_plane(registry, s_pad, devices)
    if p is None:
        return None
    if num_series is not None and p.num_series != num_series:
        return None
    key = tag_index.matcher_key(matchers)
    with _LOCK:
        hit = p.mask_cache.get(key)
        if hit is not None:
            p.mask_cache.move_to_end(key)
            _TALLY["mask_hits"] += 1
            return hit
    per = s_pad // len(devices)
    tables = _ok_tables(p, registry, matchers)
    if tables is None:
        out = ([torch.zeros(per, dtype=torch.bool, device=d)
                for d in devices], False)
    else:
        cols, oks = tables
        if not cols:
            return None  # constant-true set: host path pads correctly
        # each ok-table crosses once per distinct device
        up: dict[str, list] = {}
        for d in devices:
            if str(d) not in up:
                up[str(d)] = [torch.from_numpy(ok).to(d) for ok in oks]
        masks = [_gather_and(c, cols, up[str(d)])
                 for c, d in zip(p.dev_codes, devices)]
        anys = [m.any() for m in masks]
        if len(anys) > 1:
            anys = [torch.stack([a.to(devices[0]) for a in anys]).any()]
        # the one host sync of the mask path, where the JAX package has it
        out = (masks, bool(anys[0]))
        with _LOCK:
            _TALLY["ok_upload_bytes"] += len(up) * sum(
                ok.nbytes for ok in oks)
    with _LOCK:
        _TALLY["mask_misses"] += 1
        p.mask_cache[key] = out
        p.mask_cache.move_to_end(key)
        while len(p.mask_cache) > _MAX_MASKS:
            p.mask_cache.popitem(last=False)
    return out


def invalidate() -> None:
    with _LOCK:
        _PLANES.clear()


def stats() -> dict:
    """Plane and mask tallies since start: cache hits and misses, builds
    and their host ms, and the bytes uploaded (planes, ok-tables)."""
    with _LOCK:
        out = dict(_TALLY)
        out["planes"] = len(_PLANES)
    return out


# ---------------------------------------------------------------------
# what the JAX package's device pool reports (its registration, with
# eviction under the memory accountant, waits for ROADMAP A9)
# ---------------------------------------------------------------------
def pool_buffers() -> list:
    """(tensor, owner) of every resident plane and memoized mask."""
    with _LOCK:
        out = []
        for p in _PLANES.values():
            out += [(t, "tag_index:plane") for t in p.dev_codes]
            for masks, _ in p.mask_cache.values():
                out += [(t, "tag_index:mask") for t in masks]
        return out


def pool_stats() -> dict:
    total = sum(t.numel() * t.element_size() for t, _ in pool_buffers())
    with _LOCK:
        return {"bytes": total, "entries": len(_PLANES), "budget_bytes": 0,
                "hits": _TALLY["hits"], "misses": _TALLY["misses"],
                "evictions": _TALLY["evictions"]}
