"""K2 (blocked group fold) of the PyTorch port against the JAX package.

The port's blocked_fold_sum (plain version on CPU tensors) must be
bit-identical to the JAX package's device_range._fold_groups n/s/s2 folds
under LocalFoldCtx (segment_sum per series block + the left fold), and
its left-fold stage bit-identical to the Pallas _fold_seed_kernel run in
interpret mode — including a -0.0 first block, which a fold starting from
0 would turn into +0.0. The port's whole _fold_groups (min/max and the
first/last staged selection too) must match exactly. fold_cont_plain and
block_partials_plain, the contract the member walk's kCont and kPartials
forms are held to on the card, must equal the Pallas _fold_cont_kernel
(interpret mode) and a per-block jax.ops.segment_sum on edge shapes.
"""

import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.ops import promql as JK
from greptimedb_tpu.parallel.dist import LocalFoldCtx as JLocalFoldCtx
from greptimedb_tpu.parallel.kernels import ring_fold as jrf
from greptimedb_tpu.query import device_range as jdr
from greptimedb_tpu_torch.ops import promql as TK
from greptimedb_tpu_torch.parallel.dist import LocalFoldCtx, left_fold_sum
from greptimedb_tpu_torch.parallel.kernels import ring_fold as trf
from greptimedb_tpu_torch.promql import fast as TF
from greptimedb_tpu_torch.query import device_range as tdr


def _bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def _state(rng, s, nb):
    """Per-series cell states as the range program hands them to the
    fold: f32 sums with signed zeros and wide magnitudes (so the add
    order shows in the bits), int32 counts, extremes and ts offsets."""
    x = (rng.standard_normal((s, nb)) * 10.0 ** rng.integers(
        -3, 4, (s, nb))).astype(np.float32)
    x[rng.random((s, nb)) < 0.05] = -0.0
    n = rng.integers(0, 4, (s, nb)).astype(np.int32)
    return {
        "n": n,
        "s": x,
        "s2": (x * x).astype(np.float32),
        "m": rng.standard_normal((s, nb)).astype(np.float32),
        "vl": rng.standard_normal((s, nb)).astype(np.float32),
        "il": rng.integers(0, 5, (s, nb)).astype(np.int32),
        "vf": rng.standard_normal((s, nb)).astype(np.float32),
        "if": rng.integers(0, 5, (s, nb)).astype(np.int32),
    }


def _gid(rng, s, g, inactive_frac, layout="random"):
    """Group ids: "random" over g groups; "dc" PromQL's dc = i % 32 (with
    g = 33 group 32 is empty, as the grid's padding group is once it is
    left out of the lists); "skewed" dc with 70 % of the series in
    group 0."""
    if layout == "random":
        gid = rng.integers(0, g, s).astype(np.int32)
    else:
        gid = (np.arange(s) % 32).astype(np.int32)
        if layout == "skewed":
            gid[rng.random(s) < 0.7] = 0
    gid[rng.random(s) < inactive_frac] = g   # inactive: routed past g
    return gid


CASES = {
    # (S, nb, g, inactive fraction[, layout]); S % 8 != 0 makes fb = 1
    "blocks8": (64, 40, 5, 0.2),
    "one_group": (48, 33, 1, 0.1),
    "fb1_unaligned": (60, 24, 4, 0.2),
    "many_groups": (96, 16, 40, 0.3),
    # few groups, long lists: PromQL's max by (dc) count at 65,536 series
    "dc_nb8": (65536, 8, 32, 0.05, "dc"),
    "dc_nb9_empty_group": (65536, 9, 33, 0.05, "dc"),
    "dc_nb8_fb1": (65533, 8, 33, 0.05, "dc"),
    "dc_nb9_fb1_skewed": (65533, 9, 33, 0.05, "skewed"),
    "dc_nb8_skewed": (65536, 8, 33, 0.05, "skewed"),
}


def _jax_fold(op, st, gid, g):
    keys = {"sum": ("n", "s"), "var_samp": ("n", "s", "s2"),
            "min": ("n", "m"), "max": ("n", "m"),
            "first_value": ("n", "vl", "il", "vf", "if")}[op]
    fn = jax.jit(lambda stt, gg: jdr._fold_groups(op, stt, gg, g, jnp,
                                                  JLocalFoldCtx()))
    out = fn({k: jnp.asarray(st[k]) for k in keys}, jnp.asarray(gid))
    return {k: np.asarray(v) for k, v in out.items()}, keys


@pytest.mark.parametrize("case", sorted(CASES))
def test_blocked_fold_sum_bit_identical_to_jax_fold_groups(case):
    s, nb, g, frac, *layout = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    st = _state(rng, s, nb)
    gid = _gid(rng, s, g, frac, *layout)
    want, _ = _jax_fold("var_samp", st, gid, g)
    fb = tdr._fold_blocks(g, nb, s)
    assert fb == jdr._fold_blocks(g, nb, s) == (8 if s % 8 == 0 else 1)
    fm = trf.fold_members(gid, g, fb, "cpu")
    for key in ("n", "s", "s2"):
        got = trf.blocked_fold_sum(torch.from_numpy(st[key]), fm).numpy()
        assert got.dtype == want[key].dtype
        assert np.array_equal(_bits(got), _bits(want[key])), key


@pytest.mark.parametrize("op", ["sum", "var_samp", "min", "max",
                                "first_value"])
def test_port_fold_groups_matches_jax(op):
    s, nb, g = 64, 24, 6
    rng = np.random.default_rng(17)
    st = _state(rng, s, nb)
    gid = _gid(rng, s, g, 0.2)
    # inactive sids carry no rows, as the range program guarantees
    st["n"][gid >= g] = 0
    want, keys = _jax_fold(op, st, gid, g)
    # one shard: the per-shard lists hold one entry each
    q = {"gid": [torch.from_numpy(gid)],
         "fold_members": [trf.fold_members(gid, g, tdr._fold_blocks(g, nb, s),
                                           "cpu")]}
    got = tdr._fold_groups(op, [{k: torch.from_numpy(st[k]) for k in keys}],
                           q, g, LocalFoldCtx())
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(_bits(got[k].numpy()), _bits(want[k])), k


@pytest.mark.parametrize("op", ["max", "count"])
@pytest.mark.parametrize("steps", [8, 9])
def test_blocked_aggregation_scatter_branch_matches_jax(op, steps,
                                                        monkeypatch):
    """PromQL's `max by (dc)` / `count by (dc)` over 60,000 series padded
    to 65,536 (dc = i % 32; the padded series in group 32, dropped after
    the aggregation): the port's aggregate_across_series_blocked through
    K2 over the fast path's member lists (_fold_members: padded series not
    listed) against the JAX package's, scatter branch, bit for bit on all
    33 groups (group 32's sums are +0.0 on both sides)."""
    s, n, g = 65536, 60000, 32
    rng = np.random.default_rng(steps * 7 + len(op))
    vals = (rng.standard_normal((s, steps))
            * 10.0 ** rng.integers(-3, 4, (s, steps))).astype(np.float32)
    vals[rng.random((s, steps)) < 0.05] = -0.0
    present = rng.random((s, steps)) < 0.8
    present[n:] = False
    gid = np.where(np.arange(s) < n, np.arange(s) % 32, g).astype(np.int32)
    # count is linear: keep it off the matrix-product branch on both sides
    monkeypatch.setattr(JK, "_MATMUL_MIN_SERIES", 1 << 30)
    monkeypatch.setattr(TK, "_MATMUL_MIN_SERIES", 1 << 30)
    assert not TK.uses_matmul(op, g + 1, s)
    want = JK.aggregate_across_series_blocked(
        jnp.asarray(vals), jnp.asarray(present), jnp.asarray(gid), g + 1,
        op, total_series=s)
    entry = types.SimpleNamespace(s_pad=s, shards=1,
                                  devices=[torch.device("cpu")])
    fms = TF._fold_members(entry, TF._Grouping([], [torch.from_numpy(gid)],
                                               gid, g))
    assert len(fms[0].member) == n
    got = TK.aggregate_across_series_blocked(
        [torch.from_numpy(vals)], [torch.from_numpy(present)],
        [torch.from_numpy(gid)], g + 1, op, total_series=s,
        ctx=LocalFoldCtx(), fms=fms)
    for w, t in zip(want, got):
        w, t = np.asarray(w), t.numpy()
        assert w.dtype == t.dtype and w.shape == t.shape == (g + 1, steps)
        assert np.array_equal(_bits(t), _bits(w))


@pytest.mark.parametrize("g,nb,members,form", [
    (9, 2160, 4000, "cells"),         # the one-device Q2 shape
    (33, 8, 1_000_000, "staged"),     # PromQL's max by (dc) count
    (8, 2048, 8192, "cells"),         # the switch point: g * nb = 16384
    (8, 2047, 8192, "staged"),
    (8, 2048, 8193, "staged"),        # m = 1024 g + 1
    (9, 2160, 1_000_000, "staged"),   # Q2's cells over a million series
])
def test_blocked_fold_form_rule(g, nb, members, form):
    """K2's shape rule: one thread per (group, cell) where g * nb fills
    the card and each thread's walk is short, the staged walk else."""
    assert trf.blocked_fold_form(g, nb, members) == form


def test_left_fold_stage_bit_identical_to_pallas_seed_kernel():
    rng = np.random.default_rng(23)
    fb, g, nb = 8, 5, 128
    parts = (rng.standard_normal((fb, g, nb))
             * 10.0 ** rng.integers(-4, 5, (fb, g, nb))).astype(np.float32)
    parts[0, :, :16] = -0.0          # -0.0 first block: must stay -0.0 ...
    parts[1:, :, :8] = -0.0          # ... where every later block is -0.0
    want = np.asarray(jrf._call1(jrf._fold_seed_kernel, jnp.asarray(parts),
                                 interpret=True))
    got = left_fold_sum(torch.from_numpy(parts)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    assert np.signbit(got[:, :8]).all()


def test_block_partials_match_jax_segment_sum():
    s, nb, g, fb = 64, 20, 4, 8
    rng = np.random.default_rng(29)
    x = _state(rng, s, nb)["s"]
    gid = _gid(rng, s, g, 0.25)
    per = s // fb
    seg = np.where(gid < g, (np.arange(s) // per) * g + gid, fb * g)
    want = np.asarray(jax.ops.segment_sum(
        jnp.asarray(x), jnp.asarray(seg, jnp.int32),
        num_segments=fb * g + 1))[:-1].reshape(fb, g, nb)
    fm = trf.fold_members(gid, g, fb, "cpu")
    got = trf.block_partials_plain(torch.from_numpy(x), fm).numpy()
    assert np.array_equal(_bits(got), _bits(want))


def test_fold_members_csr_lists_active_sids_ascending():
    gid = np.array([0, 2, 1, 0, 3, 3, 1, 2, 2, 0, 1, 3, 0, 0, 2, 1], np.int32)
    g, fb = 3, 4                         # gid 3 == g: inactive
    fm = trf.fold_members(gid, g, fb, "cpu")
    ptr = fm.ptr.numpy()
    member = fm.member.numpy()
    per = len(gid) // fb
    for b in range(fb):
        for grp in range(g):
            got = member[ptr[b * g + grp]:ptr[b * g + grp + 1]]
            want = [sid for sid in range(b * per, (b + 1) * per)
                    if gid[sid] == grp]
            assert list(got) == want
    assert (gid[member] < g).all() and len(member) == (gid < g).sum()
    with pytest.raises(ValueError):
        trf.fold_members(gid[:15], g, fb, "cpu")


def test_blocked_fold_sum_checks_inputs():
    fm = trf.fold_members(np.zeros(16, np.int32), 1, 8, "cpu")
    with pytest.raises(TypeError):
        trf.blocked_fold_sum(torch.zeros((16, 4), dtype=torch.float64), fm)
    with pytest.raises(ValueError):
        trf.blocked_fold_sum(torch.zeros((8, 4)), fm)
    out = trf.blocked_fold_sum(torch.ones((16, 4), dtype=torch.int32), fm)
    assert out.tolist() == [[16] * 4]
    assert trf.blocked_fold_sum.launches == 0   # the CPU never launches


def _edge_rows(rng, s, nb, dtype, nan=True):
    """(s, nb) states with edge bits: float32 with wide magnitudes, -0.0,
    ±inf in two cells of three and (nan=True) one NaN payload in each
    third cell (two payloads that meet in a sum keep the first operand's
    on the CPU, and XLA's scatter and the port order that pair
    differently, so a chain holds one); int32 with extremes whose sums
    wrap."""
    if dtype == "i32":
        x = rng.integers(-1000, 1000, (s, nb)).astype(np.int32)
        r = rng.random(x.shape)
        x[r < 0.05] = 2**31 - 1
        x[(r >= 0.05) & (r < 0.1)] = -(2**31)
        return x
    x = (rng.standard_normal((s, nb))
         * 10.0 ** rng.integers(-4, 5, (s, nb))).astype(np.float32)
    r = rng.random(x.shape)
    x[r < 0.1] = -0.0
    inf_cell = np.arange(nb) % 3 != 0
    x[(r >= 0.1) & (r < 0.12) & inf_cell] = np.inf
    x[(r >= 0.12) & (r < 0.14) & inf_cell] = -np.inf
    for c in range(0, nb, 3) if nan else ():
        bits = np.uint32(int(rng.integers(0, 2**22)) | 0x7FC00000)
        x[rng.integers(s), c] = bits.view(np.float32)
    return x


WALK_CASES = {
    # (S, nb, g, fb, offset): the card tests' edge shapes; offset 1 cuts
    # the rows one element into a larger buffer
    "q2_cells_fb2": (256, 2160, 9, 2, 0),
    "q2_cells_fb1": (64, 2160, 9, 1, 0),
    "q2_cells_fb8_misaligned": (256, 2160, 9, 8, 1),
    "nb257_fb2": (256, 257, 5, 2, 0),
    "nb257_fb8_misaligned": (256, 257, 5, 8, 1),
    "nb6_fb8": (64, 6, 3, 8, 0),
    "nb6_fb1_misaligned": (64, 6, 3, 1, 1),
    "long_list_fb1": (3000, 40, 3, 1, 0),
    # few groups, long lists (PromQL's max by (dc) count)
    "dc_nb8_fb8": (65536, 8, 33, 8, 0),
    "dc_nb9_fb1_misaligned": (65536, 9, 33, 1, 1),
}


@pytest.mark.parametrize("dtype", ["f32", "i32"])
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_walk_plain_versions_bit_identical_to_jax(case, dtype):
    """block_partials_plain against a per-block jax.ops.segment_sum, and
    fold_cont_plain against the Pallas _fold_cont_kernel (interpret mode)
    over those partials, bit for bit: group 0 holds more than 1024
    members of one block where the shape allows, group g - 1 none, and
    acc is -0.0 over that empty group (acc + +0.0 partials is +0.0)."""
    s, nb, g, fb, offset = WALK_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)) + len(dtype))
    flat = _edge_rows(rng, s + 1, nb, dtype).ravel()
    x = flat[offset:offset + s * nb].reshape(s, nb)
    gid = rng.integers(0, g - 1, s).astype(np.int32)
    gid[rng.random(s) < 0.1] = g
    per = s // fb
    if per > 1100:
        gid[:1100] = 0
        assert (gid[:per] == 0).sum() > 1024
    acc = _edge_rows(rng, g, nb, dtype, nan=False)
    if dtype == "f32":
        acc[g - 1] = -0.0
        acc[:, ::5] = -0.0
    seg = np.where(gid < g, (np.arange(s) // per) * g + gid, fb * g)
    want_parts = jax.ops.segment_sum(
        jnp.asarray(x), jnp.asarray(seg, jnp.int32),
        num_segments=fb * g + 1)[:-1].reshape(fb, g, nb)
    want_cont = np.asarray(jrf._call2(jrf._fold_cont_kernel,
                                      jnp.asarray(acc), want_parts,
                                      interpret=True))
    fm = trf.fold_members(gid, g, fb, "cpu")
    xt = torch.from_numpy(flat)[offset:offset + s * nb].view(s, nb)
    parts = trf.block_partials(xt, fm).numpy()
    cont = trf.fold_cont(torch.from_numpy(acc), xt, fm).numpy()
    assert np.array_equal(_bits(parts), _bits(np.asarray(want_parts)))
    assert np.array_equal(_bits(cont), _bits(want_cont))
    assert not parts[:, g - 1].any()
    if dtype == "f32":
        assert (_bits(cont[g - 1]) == 0).all()       # +0.0, not -0.0
    assert trf.fold_cont.launches == trf.block_partials.launches == 0


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_matchers",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_profiler_matchers_catch_their_own_rows_only():
    """chip_smoke.py reads each row's device time per launch from the
    profiler's kernel names: the seed, the three forms of the member walk
    (one kernel, the form its last template argument) and the ring
    combines each match their own names and no other row's."""
    cs = _chip_smoke()
    matchers = {"blocked_fold_sum": cs.is_seed_kernel,
                **{row: cs.walk(row) for row in cs.WALK_FORMS},
                "ring_pext_fused": cs.ring_combine(0, 1, 2, 3),
                "ring_psum_onehot_fused": cs.ring_combine(4)}
    assert set(cs.WALK_FORMS) == {"ring_fold_fused", "fold_cont",
                                  "block_partials"}
    names = {
        "fold_kernel<float>": "blocked_fold_sum",
        "fold_kernel<int>": "blocked_fold_sum",
        "fold_staged_kernel<float>": "blocked_fold_sum",
        "fold_staged_kernel<int>": "blocked_fold_sum",
        "group_fold_kernel<float, true>": None,
        "ring_fold_fused_kernel<float, true, 0>": "ring_fold_fused",
        "ring_fold_fused_kernel<int, false, 0>": "ring_fold_fused",
        "ring_fold_fused_kernel<float, true, 1>": "fold_cont",
        "ring_fold_fused_kernel<int, false, 1>": "fold_cont",
        "ring_fold_fused_kernel<float, false, 2>": "block_partials",
        "ring_fold_fused_kernel<int, true, 2>": "block_partials",
        "ring_combine_kernel<float, 0, true>": "ring_pext_fused",
        "ring_combine_kernel<int, 3, false>": "ring_pext_fused",
        "ring_combine_kernel<float, 4, true>": "ring_psum_onehot_fused",
        "extreme_f32_kernel<true>": None,
        "onehot_add_kernel": None,
        "gather_planes_kernel": None,
        "merge_topk_kernel<false>": None,
    }
    for name, row in names.items():
        hits = [r for r, match in matchers.items() if match(name)]
        assert hits == ([row] if row else []), name
