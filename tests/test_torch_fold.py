"""K2 (blocked group fold) of the PyTorch port against the JAX package.

The port's blocked_fold_sum (plain version on CPU tensors) must be
bit-identical to the JAX package's device_range._fold_groups n/s/s2 folds
under LocalFoldCtx (segment_sum per series block + the left fold), and
its left-fold stage bit-identical to the Pallas _fold_seed_kernel run in
interpret mode — including a -0.0 first block, which a fold starting from
0 would turn into +0.0. The port's whole _fold_groups (min/max and the
first/last staged selection too) must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.parallel.dist import LocalFoldCtx as JLocalFoldCtx
from greptimedb_tpu.parallel.kernels import ring_fold as jrf
from greptimedb_tpu.query import device_range as jdr
from greptimedb_tpu_torch.parallel.dist import LocalFoldCtx, left_fold_sum
from greptimedb_tpu_torch.parallel.kernels import ring_fold as trf
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


def _gid(rng, s, g, inactive_frac):
    gid = rng.integers(0, g, s).astype(np.int32)
    gid[rng.random(s) < inactive_frac] = g   # inactive: routed past g
    return gid


CASES = {
    # (S, nb, g, inactive fraction); S % 8 != 0 makes fb = 1
    "blocks8": (64, 40, 5, 0.2),
    "one_group": (48, 33, 1, 0.1),
    "fb1_unaligned": (60, 24, 4, 0.2),
    "many_groups": (96, 16, 40, 0.3),
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
    s, nb, g, frac = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    st = _state(rng, s, nb)
    gid = _gid(rng, s, g, frac)
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
