"""Rows 4 and 5 as one launch per ring: ring_pext_fused and
ring_psum_onehot_fused (parallel/kernels/ring_fold.py) on the CPU.

Their plain versions chain the hop ring's combines in shard order, so at
every shard count from 1 to 8 they must equal, bit for bit, with NaN
payloads of either sign, ±0.0, ±inf and int32 extremes, the hop ring
(ring_pext, ring_psum_onehot) and the gather twin (ShardFoldCtx). The
JAX package's RingFoldCtx in shard_map is held to them in
tests/test_torch_mesh.py; the kernels themselves run in
tests/test_torch_cuda.py. Also: RingFoldCtx routes pext/psum to the ring
forms exactly when form() says "fused", and the wrappers refuse what the
kernels do not take.
"""

import numpy as np
import pytest
import torch

from greptimedb_tpu_torch.parallel.dist import ShardFoldCtx
from greptimedb_tpu_torch.parallel.kernels import ring_fold as trf

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _edge_f32(rng, shape):
    """float32 with wide magnitudes, ±0.0, ±inf and quiet NaNs whose
    payloads and signs are random."""
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4, shape)
         ).astype(np.float32)
    r = rng.random(shape)
    x[r < 0.1] = 0.0
    x[(r >= 0.1) & (r < 0.2)] = -0.0
    x[(r >= 0.2) & (r < 0.25)] = np.inf
    x[(r >= 0.25) & (r < 0.3)] = -np.inf
    nan = (r >= 0.3) & (r < 0.45)
    bits = (rng.integers(0, 2**22, shape) | 0x7FC00000
            | (rng.integers(0, 2, shape) << 31)).astype(np.uint32)
    x[nan] = bits.view(np.float32)[nan]
    return x


def _edge_i32(rng, shape):
    x = rng.integers(-50, 50, shape).astype(np.int32)
    r = rng.random(shape)
    x[r < 0.15] = I32_MIN
    x[(r >= 0.15) & (r < 0.3)] = I32_MAX
    return x


def _shards(x):
    return [torch.from_numpy(np.ascontiguousarray(x[k]))
            for k in range(x.shape[0])]


@pytest.mark.parametrize("ns", range(1, 9))
def test_ring_forms_equal_the_hop_ring(ns):
    rng = np.random.default_rng(40 + ns)
    g, nb = 3, 37                       # n = 111: not a multiple of 4
    gather = ShardFoldCtx(ns)
    for x in (_edge_f32(rng, (ns, g, nb)), _edge_i32(rng, (ns, g, nb))):
        xs = _shards(x)
        for take_max in (True, False):
            hops = trf.ring_pext(xs, take_max)
            plain = trf.ring_pext_fused_plain(xs, take_max)
            assert _same(plain, hops), (x.dtype, take_max)
            assert _same(trf.ring_pext_fused(xs, take_max), hops)
            assert _same(gather.pext(xs, take_max), hops)
    # one-hot payloads (one winner shard per element, +0.0 elsewhere; a
    # -0.0 winner comes out +0.0) and general summands: the same chain
    win = rng.integers(0, ns, (g, nb))
    oh = np.zeros((ns, g, nb), np.float32)
    vals = _edge_f32(rng, (g, nb))
    oh[win, np.arange(g)[:, None], np.arange(nb)[None, :]] = vals
    for x in (oh, _edge_f32(rng, (ns, g, nb))):
        xs = _shards(x)
        hops = trf.ring_psum_onehot(xs)
        plain = trf.ring_psum_onehot_fused_plain(xs)
        assert _same(plain, hops)
        assert _same(trf.ring_psum_onehot_fused(xs), hops)
        assert _same(gather.psum(xs), hops)
    if ns > 1:
        total = trf.ring_psum_onehot_fused(_shards(oh))[0]
        assert not torch.signbit(total[torch.from_numpy(vals == 0)]).any()
    # one shard comes back as it is; the totals are one tensor for all
    xs = _shards(_edge_f32(rng, (ns, g, nb)))
    out = trf.ring_pext_fused(xs, True)
    assert all(o is out[0] for o in out)
    if ns == 1:
        assert out[0] is xs[0]
    assert (trf.ring_pext_fused.launches,
            trf.ring_psum_onehot_fused.launches) == (0, 0)   # CPU: plain


def test_ring_ctx_routes_pext_and_psum_by_form(monkeypatch):
    """RingFoldCtx.pext/psum take the ring forms exactly when form() says
    "fused" (every shard on one device, fused not False), else the hop
    ring. Shards on two devices are cpu and meta tensors here (the hooks
    are stubbed, so nothing computes on them)."""
    ns = 4
    seen = []
    for name in ("ring_pext_fused", "ring_pext"):
        monkeypatch.setattr(trf, name,
                            lambda xs, tm, _n=name: seen.append(_n) or xs)
    for name in ("ring_psum_onehot_fused", "ring_psum_onehot"):
        monkeypatch.setattr(trf, name,
                            lambda xs, _n=name: seen.append(_n) or xs)
    one = [torch.zeros(2, 3) for _ in range(ns)]
    two = [torch.zeros(2, 3, device="cpu" if k % 2 else "meta")
           for k in range(ns)]
    for fused, xs, want in ((None, one, "fused"), (True, one, "fused"),
                            (False, one, "hops"), (None, two, "hops"),
                            (True, two, "hops")):
        ctx = trf.RingFoldCtx(ns, fused=fused)
        assert ctx.form([x.device for x in xs]) == want
        seen.clear()
        ctx.pext(xs, True)
        ctx.psum(xs)
        suffix = "_fused" if want == "fused" else ""
        assert seen == [f"ring_pext{suffix}", f"ring_psum_onehot{suffix}"], (
            fused, want)


@pytest.mark.parametrize("case", ["nine_shards", "no_shards", "mixed_dtypes",
                                  "float64", "mixed_shapes", "mixed_devices",
                                  "non_contiguous"])
def test_ring_form_wrappers_check_their_inputs(case):
    x = torch.zeros(3, 4)
    bad = {
        "nine_shards": ([x] * 9, ValueError),
        "no_shards": ([], ValueError),
        "mixed_dtypes": ([x, x.to(torch.int32)], TypeError),
        "float64": ([x.double()] * 2, TypeError),
        "mixed_shapes": ([x, torch.zeros(3, 5)], ValueError),
        "mixed_devices": ([x, torch.zeros(3, 4, device="meta")], ValueError),
        "non_contiguous": ([x, torch.zeros(4, 3).t()], ValueError),
    }
    xs, err = bad[case]
    with pytest.raises(err):
        trf.ring_pext_fused(xs, True)
    with pytest.raises(err):
        trf.ring_psum_onehot_fused(xs)
    # psum takes float32 only
    with pytest.raises(TypeError):
        trf.ring_psum_onehot_fused([x.to(torch.int32)] * 2)
