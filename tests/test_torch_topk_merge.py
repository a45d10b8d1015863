"""The topk candidate merge and its ring against the JAX package.

merge_candidates_plain (the kernel's plain version; the wrapper runs it
for CPU tensors) against the Pallas merge_candidates in interpret mode,
and the port's ring_topk_merge over per-shard lists against the JAX
package's ring_topk_merge inside a jitted shard_map on the 8 virtual CPU
devices (as tests/test_kernels.py runs it), at 2, 4 and 8 shards. Inputs
hold cross-list ties, -inf fill keys, -0.0 and +0.0 keys, NaN payloads
and -0.0 in the values, and accumulators wider than the local lists.

One merge is exact on every slot (both compute the same int32 sums). The
ring is exact on every finite-key slot — the real candidates: values,
indices, presence, tie-breaks — as the JAX package's own test holds its
ring to the all-gather reselect; the -inf fill slots are that test's
documented exception. The one-launch ring's plain version
(ring_topk_merge_fused_plain, the chain of merges in shard order) is held
to the JAX ring and to the hop ring on every slot, sorted inputs or not.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from greptimedb_tpu.parallel import mesh as JM
from greptimedb_tpu.parallel.kernels import topk_merge as jtm
from greptimedb_tpu_torch.parallel.kernels import topk_merge as ttm
from greptimedb_tpu_torch.promql.fast import _stable_topk


def _bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" else a


def _nan_payloads(rng, shape):
    bits = (rng.integers(0, 2**22, shape) | 0x7FC00000
            | (rng.integers(0, 2, shape) << 31)).astype(np.uint32)
    return bits.view(np.float32)


def _planes(rng, lead, width, *, sort=True, nan_keys=False):
    """(key, val, idx, pres) numpy planes of shape lead + (width,): keys
    from a small value set (ties within and across lists), -inf fills,
    both zeros, NaN keys with nan_keys (after any sort: a NaN key has no
    place in a descending list); values with NaN payloads and -0.0."""
    shape = lead + (width,)
    key = rng.choice(np.array([3.0, 1.5, 0.5, 0.0, -0.0, -2.0], np.float32),
                     shape)
    key[rng.random(shape) < 0.15] = -np.inf
    if sort:
        key = -np.sort(-key, axis=-1)
    if nan_keys:
        key[rng.random(shape) < 0.1] = np.nan
    val = rng.standard_normal(shape).astype(np.float32)
    r = rng.random(shape)
    val[r < 0.1] = -0.0
    val[(r >= 0.1) & (r < 0.2)] = _nan_payloads(rng, shape)[
        (r >= 0.1) & (r < 0.2)]
    idx = rng.integers(0, 1 << 20, shape).astype(np.int32)
    pres = rng.random(shape) < 0.8
    return key, val, idx, pres


def _cands(planes):
    return ttm.Candidates(*(torch.from_numpy(np.ascontiguousarray(p))
                            for p in planes))


@pytest.mark.parametrize("j,kk,kl,sort", [(6, 9, 5, True), (4, 7, 7, True),
                                          (8, 100, 100, True),
                                          (5, 6, 9, True), (3, 8, 4, False)])
def test_merge_plain_matches_pallas(j, kk, kl, sort):
    """Every slot of every plane bit for bit, sorted or not (the plain
    version and the Pallas body compute the same one-hot int32 sums)."""
    rng = np.random.default_rng(j * 100 + kk + kl)
    acc = _planes(rng, (j,), kk, sort=sort)
    loc = _planes(rng, (j,), kl, sort=sort)
    want = jtm.merge_candidates(tuple(jnp.asarray(p) for p in acc),
                                tuple(jnp.asarray(p) for p in loc),
                                interpret=True)
    got = ttm.merge_candidates(_cands(acc), _cands(loc))
    for w, g in zip(want, got):
        assert np.array_equal(_bits(np.asarray(w)), _bits(g.numpy()))


def test_merge_is_the_stable_reselect():
    """On sorted inputs one merge is the stable top-kk of the
    concatenation [acc, loc]: equal keys keep the accumulator first."""
    rng = np.random.default_rng(5)
    acc = _planes(rng, (7,), 12)
    loc = _planes(rng, (7,), 12)
    got = ttm.merge_candidates(_cands(acc), _cands(loc))
    cat = [np.concatenate([a, b], axis=1) for a, b in zip(acc, loc)]
    key, pos = _stable_topk(torch.from_numpy(cat[0]), 12)
    assert np.array_equal(_bits(key.numpy()), _bits(got.key.numpy()))
    fin = np.isfinite(key.numpy())
    for plane, g in zip(cat[1:], got[1:]):
        want = np.take_along_axis(plane, pos.numpy(), axis=1)
        assert np.array_equal(_bits(want[fin]), _bits(g.numpy()[fin]))


_JAX_RING = {}


def _jax_ring(ns, k):
    """JAX ring_topk_merge inside one jitted shard_map over ns devices."""
    if (ns, k) not in _JAX_RING:
        mesh = JM.make_mesh(jax.devices()[:ns])
        spec = P(JM.AXIS_SHARD, None, None)

        def body(ks, vs, is_, ps):
            out = jtm.ring_topk_merge(
                ks[0], vs[0], is_[0], ps[0], k=k, ns=ns, interpret=True)
            return tuple(o[None] for o in out)

        prog = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,) * 4,
                                 out_specs=(spec,) * 4, check_rep=False))

        def run(*planes):
            return prog(*(jax.device_put(jnp.asarray(p),
                                         NamedSharding(mesh, spec))
                          for p in planes))

        _JAX_RING[ns, k] = run
    return _JAX_RING[ns, k]


@pytest.mark.parametrize("ns", [2, 4, 8])
@pytest.mark.parametrize("kl,k", [(5, 9), (6, 6)])
def test_ring_matches_jax_ring(ns, kl, k):
    rng = np.random.default_rng(ns * 10 + kl)
    j = 6
    planes = _planes(rng, (ns, j), kl)
    want = [np.asarray(x) for x in _jax_ring(ns, k)(*planes)]
    local = [_cands([p[s] for p in planes]) for s in range(ns)]
    out = ttm.ring_topk_merge(local, k)
    assert len(out) == ns
    for s in range(ns):
        got = out[s]
        assert all(np.array_equal(_bits(a.numpy()), _bits(b.numpy()))
                   for a, b in zip(got, out[0]))
        fin = np.isfinite(want[0][s])
        assert np.array_equal(fin, np.isfinite(got.key.numpy()))
        pres = got.pres.numpy() & np.isfinite(got.key.numpy())
        for w, g in zip(want[:3], (got.key, got.val, got.idx)):
            assert np.array_equal(_bits(w[s][fin]), _bits(g.numpy()[fin]))
        assert np.array_equal(want[3][s][fin], pres[fin])


@pytest.mark.parametrize("ns", [2, 4, 8])
def test_ring_matches_gather_reselect(ns):
    """The ring against the gather twin's stable reselect over the
    shard-order concatenation, on the finite-key slots."""
    rng = np.random.default_rng(ns)
    k, kl, j = 10, 7, 5
    planes = _planes(rng, (ns, j), kl)
    local = [_cands([p[s] for p in planes]) for s in range(ns)]
    ring = ttm.ring_topk_merge(local, k)[0]
    cat = [np.concatenate(list(p), axis=1) for p in planes]
    key, pos = _stable_topk(torch.from_numpy(cat[0]), k)
    fin = np.isfinite(key.numpy())
    assert np.array_equal(fin, np.isfinite(ring.key.numpy()))
    for plane, g in zip(cat, ring):
        want = np.take_along_axis(plane, pos.numpy(), axis=1)
        assert np.array_equal(_bits(want[fin]), _bits(g.numpy()[fin]))


def test_wrapper_checks_and_counts():
    rng = np.random.default_rng(0)
    acc = _cands(_planes(rng, (3,), 4))
    loc = _cands(_planes(rng, (3,), 4))
    before = ttm.merge_candidates.launches
    ttm.merge_candidates(acc, loc)
    # a CPU tensor runs the plain version: no launch is counted
    assert ttm.merge_candidates.launches == before
    bad = acc._replace(idx=acc.idx.to(torch.int64))
    with pytest.raises(TypeError):
        ttm.merge_candidates(bad, loc)
    with pytest.raises(ValueError):
        ttm.merge_candidates(acc, loc._replace(key=loc.key[:2]))
    with pytest.raises(ValueError):
        ttm.merge_candidates(acc._replace(val=acc.val.t()), loc)


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("ns", [2, 4, 8])
@pytest.mark.parametrize("kl,k", [(5, 9), (6, 6)])
def test_fused_ring_plain_matches_jax_ring_and_hop_ring(ns, kl, k, sort):
    """The one-launch ring's plain version against the JAX ring_topk_merge
    (interpret mode, jitted shard_map) and the port's hop ring, every slot
    of every plane bit for bit: sorted inputs with cross-list ties, -inf
    and -0.0 keys, or unsorted ones with NaN keys too; NaN payloads and
    -0.0 in the values; kl < k (the padded seed) and kl == k."""
    rng = np.random.default_rng(ns * 100 + kl * 10 + sort)
    j = 6
    planes = _planes(rng, (ns, j), kl, sort=sort, nan_keys=not sort)
    want = [np.asarray(x) for x in _jax_ring(ns, k)(*planes)]
    local = [_cands([p[s] for p in planes]) for s in range(ns)]
    got = ttm.ring_topk_merge_fused_plain(local, k)
    hops = ttm.ring_topk_merge_hops(local, k)
    assert len(got) == ns and all(c is got[0] for c in got)
    for s in range(ns):
        for w, g, h in zip(want, got[s], hops[s]):
            assert np.array_equal(_bits(w[s]), _bits(g.numpy()))
            assert np.array_equal(_bits(g.numpy()), _bits(h.numpy()))
    # the edges reach the winners: -0.0 and NaN payloads in the values
    v = got[0].val.numpy()
    assert np.isnan(v).any() and (np.signbit(v) & (v == 0)).any()


def test_ring_routes_by_the_devices(monkeypatch):
    """ring_topk_merge takes the one-launch ring exactly when every shard
    lies on one device (base.ring_form, as RingFoldCtx.form), the hop ring
    for shards on several devices."""
    seen = []
    monkeypatch.setattr(ttm, "ring_topk_merge_fused",
                        lambda local, k: seen.append("fused") or local)
    monkeypatch.setattr(ttm, "ring_topk_merge_hops",
                        lambda local, k: seen.append("hops") or local)

    def shards(*devs):
        return [types.SimpleNamespace(device=torch.device(d)) for d in devs]

    ttm.ring_topk_merge(shards("cpu", "cpu", "cpu"), 5)
    ttm.ring_topk_merge(shards("cuda:0", "cuda:0"), 5)
    ttm.ring_topk_merge(shards("cuda:0", "cuda:1"), 5)
    ttm.ring_topk_merge(shards("cuda:1", "cuda:0", "cuda:1"), 5)
    assert seen == ["fused", "fused", "hops", "hops"]


def test_fused_ring_checks_and_counts():
    rng = np.random.default_rng(4)
    planes = _planes(rng, (4, 3), 5)
    local = [_cands([p[s] for p in planes]) for s in range(4)]
    before = (ttm.ring_topk_merge_fused.launches,
              ttm.merge_candidates.launches)
    out = ttm.ring_topk_merge(local, 8)
    # a CPU tensor runs the plain version: no launch is counted
    assert (ttm.ring_topk_merge_fused.launches,
            ttm.merge_candidates.launches) == before
    assert out[0].key.shape == (3, 8)
    one = ttm.ring_topk_merge_fused(local[:1], 8)[0]   # one shard: the seed
    assert torch.equal(one.idx[:, 5:], torch.full((3, 3), 2**31 - 1,
                                                  dtype=torch.int32))
    assert not one.pres[:, 5:].any() and torch.isneginf(one.key[:, 5:]).all()
    with pytest.raises(TypeError):
        ttm.ring_topk_merge_fused(
            [local[0]._replace(idx=local[0].idx.long())] + local[1:], 8)
    with pytest.raises(ValueError):                     # kl > k
        ttm.ring_topk_merge_fused(local, 4)
    with pytest.raises(ValueError):                     # past 1024 threads
        ttm.ring_topk_merge_fused(local, 1020)
    with pytest.raises(ValueError):                     # widths differ
        ttm.ring_topk_merge_fused(local[:3] + [_cands(
            [p[3][:, :4] for p in planes])], 8)
    with pytest.raises(ValueError):                     # nine shards
        ttm.ring_topk_merge_fused(local * 2 + local[:1], 8)
    with pytest.raises(ValueError):
        ttm.ring_topk_merge_fused([], 8)
    with pytest.raises(ValueError):                     # not contiguous
        ttm.ring_topk_merge_fused(
            [local[0]._replace(val=local[0].val.t().contiguous().t())]
            + local[1:], 8)
    assert (ttm.ring_topk_merge_fused.launches,
            ttm.merge_candidates.launches) == before


@pytest.mark.parametrize("ns,j,k", [(1, 8, 100), (4, 8, 100), (8, 3, 5)])
def test_comm_bytes_match_jax(ns, j, k):
    assert ttm.topk_comm_bytes(ns, j, k) == jtm.topk_comm_bytes(ns, j, k)


def test_stable_topk_lower_index_wins():
    """Ties keep ascending index order, as jax.lax.top_k does."""
    rng = np.random.default_rng(3)
    key = rng.choice(np.array([1.0, 0.0, -np.inf], np.float32), (4, 300))
    want_v, want_i = jax.lax.top_k(jnp.asarray(key), 50)
    got_v, got_i = _stable_topk(torch.from_numpy(key), 50)
    assert np.array_equal(np.asarray(want_i), got_i.numpy())
    assert np.array_equal(_bits(np.asarray(want_v)), _bits(got_v.numpy()))

