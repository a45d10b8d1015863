"""G and Gt's plain versions on the row layouts users have, against the
JAX package's XLA:CPU segment ops.

Region.scan returns rows in (series, ts) order, so a GROUP BY over a tag
of the series sees each group's rows as long contiguous runs, not the
uniform random ids of tests/test_torch_groupby.py. The layouts come from
tests/test_torch_cuda.py (which holds the kernels to these plain versions
on a card): "runs" (series order: runs of 1, 31, 32, 33, 64, 65 and
4096+ rows crossing row-block boundaries, padding rows after the live
ones, empty blocks at the end), "mixed" (chosen segment lengths around the
walk's threshold among random ids) and "random". The same numpy inputs go
through jax.ops.segment_sum / segment_max / segment_min and jnp.sum(axis=0)
under JAX_PLATFORMS=cpu, as the JAX fused GROUP BY builds them
(greptimedb_tpu/query/reduce.py _fused_program), and through the port's
plain versions: bit for bit. The summed values carry one NaN payload and
no -inf (two NaN payloads meeting in one add come out in an order the
compiler picks, ROADMAP C2); the extremes carry NaN of both signs, +-0 and
+-inf.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu_torch.parallel.kernels import grouped_reduce as gr
from test_torch_cuda import _layout_input

CSRC = (Path(gr.__file__).parent / "csrc" / "grouped_reduce.cu").read_text()
LAYOUTS = [("runs", 1 << 16, 16, 64), ("runs", 100_003, 256, 32),
           ("runs", 1 << 15, 8, 8), ("runs", 1 << 17, 64, 4),
           ("mixed", 1 << 18, 256, 64), ("random", 1 << 16, 1024, 16)]


def _case(layout, n, blocks, gb):
    rng = np.random.default_rng(n + blocks + gb)
    v, mask, gid = _layout_input(rng, n, blocks, gb, layout)
    members = gr.group_members(torch.from_numpy(gid), torch.from_numpy(mask),
                               blocks, gb)
    return v, mask, gid, members


def _segments(mask, gid, n, blocks, gb):
    """The JAX program's segment ids: g * blocks + block for live rows, the
    trash segment gb * blocks for the rest."""
    block = jnp.arange(n, dtype=jnp.int32) // -(-n // blocks)
    return jnp.where(jnp.asarray(mask), jnp.asarray(gid) * blocks + block,
                     gb * blocks)


def _sum_values(v):
    """v with one NaN payload and -inf turned to +inf (see the module
    docstring)."""
    x = v.copy()
    x[np.isnan(x)] = np.float32(np.nan)
    x[x == -np.inf] = np.inf
    return x


@pytest.mark.parametrize("layout,n,blocks,gb", LAYOUTS)
def test_layout_is_what_it_claims(layout, n, blocks, gb):
    v, mask, gid, members = _case(layout, n, blocks, gb)
    lens = np.diff(members.ptr.numpy())
    per_block = np.diff(np.searchsorted(
        members.perm.numpy()[:int(mask.sum())] // -(-n // blocks),
        np.arange(blocks + 1)))
    assert lens.sum() == mask.sum()
    assert not mask[gid == 1].any()
    assert (lens.reshape(gb, blocks)[-2:] == 0).all()   # empty groups
    if layout == "runs":
        live = np.flatnonzero(mask)
        assert not mask[live[-1] + 1:].any() and live[-1] < n - n // 8
        assert per_block[-1] == 0
        # rows in series order: the live rows' ids come in runs, some of
        # them a series long (4096+ rows less the masked ones)
        ids = gid[mask]
        edges = np.flatnonzero(np.diff(ids)) + 1
        runs = np.diff(np.concatenate([[0], edges, [len(ids)]]))
        assert runs.max() >= 3000 and len(runs) < len(ids) // 50
    elif layout == "mixed":
        assert gr._WARP_ROWS in lens and gr._WARP_ROWS - 1 in lens
        assert (lens >= 600).sum() >= 3 and lens.max() < 2 * 600
    else:
        assert lens.max() < gr._WARP_ROWS


@pytest.mark.parametrize("layout,n,blocks,gb", LAYOUTS)
def test_sum_form_matches_jax_segment_sum(layout, n, blocks, gb):
    v, mask, gid, members = _case(layout, n, blocks, gb)
    x = _sum_values(v)
    p = jax.ops.segment_sum(jnp.where(jnp.asarray(mask), jnp.asarray(x), 0.0),
                            _segments(mask, gid, n, blocks, gb),
                            num_segments=gb * blocks + 1)
    want = np.asarray(p[:-1].reshape(gb, blocks).T)
    got = gr.grouped_block_reduce(torch.from_numpy(x), members, "sum")
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("form", ["max", "min"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("layout,n,blocks,gb", LAYOUTS)
def test_extreme_forms_match_jax_segment_ops(layout, n, blocks, gb, dtype,
                                             form):
    v, mask, gid, members = _case(layout, n, blocks, gb)
    if dtype == "int32":   # the winner stages' keys
        v = np.random.default_rng(n).integers(-1, 2**31 - 1, n).astype(
            np.int32)
        ident = np.iinfo(np.int32).min if form == "max" else np.iinfo(
            np.int32).max
    else:
        ident = -np.inf if form == "max" else np.inf
    ext = jax.ops.segment_max if form == "max" else jax.ops.segment_min
    sg = jnp.where(jnp.asarray(mask), jnp.asarray(gid), gb)
    want = np.asarray(ext(jnp.where(jnp.asarray(mask), jnp.asarray(v),
                                    ident), sg, num_segments=gb + 1)[:-1])
    got = gr.grouped_block_reduce(torch.from_numpy(v), members, form)
    assert got.dtype == getattr(torch, dtype)
    assert np.array_equal(got.numpy().view(np.uint32),
                          want.view(np.uint32)), form


@pytest.mark.parametrize("layout,n,blocks,gb", LAYOUTS)
def test_column_tree_sum_of_the_layout_matches_xla_sum(layout, n, blocks,
                                                       gb):
    """Gt over the layout's (blocks, gb) sums, as the var/stddev mean takes
    it, against jnp.sum(axis=0) on XLA:CPU."""
    v, mask, gid, members = _case(layout, n, blocks, gb)
    sp = gr.grouped_block_reduce(torch.from_numpy(_sum_values(v)), members,
                                 "sum")
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=0))(sp.numpy()))
    got = gr.column_tree_sum(sp).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_int16_member_keys_give_the_int32_permutation(monkeypatch):
    """group_members sorts int16 keys when gb fits (the masked key gb too,
    so up to gb = 32767) and int32 keys past it: either way the same
    permutation and pointers as a stable sort of the int32 keys."""
    sorted_keys = []
    real_sort = torch.sort

    def sort(key, **kw):
        sorted_keys.append(key.dtype)
        return real_sort(key, **kw)

    monkeypatch.setattr(torch, "sort", sort)
    # the layouts' gb, then either side of the int16 limit
    for layout, n, blocks, gb in LAYOUTS + [
            ("random", 1 << 14, 4, gr._INT16_KEYS),
            ("random", 1 << 14, 4, gr._INT16_KEYS + 1)]:
        _, mask, gid, members = _case(layout, n, blocks, gb)
        assert sorted_keys.pop() == (torch.int16 if gb <= 32767
                                     else torch.int32)
        key = np.where(mask, gid, gb).astype(np.int32)
        perm = np.argsort(key, kind="stable")
        assert np.array_equal(members.perm.numpy(), perm)
        seg = key[perm].astype(np.int64) * blocks + perm // -(-n // blocks)
        assert np.array_equal(members.ptr.numpy(), np.searchsorted(
            seg, np.arange(gb * blocks + 1)))


def test_python_constants_match_the_kernel_source():
    """The wrappers size scratch and the tests plant segments by constants
    the CUDA source defines."""
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", CSRC)[1])

    assert const("kWarpRows") == gr._WARP_ROWS
    assert const("kTree") == gr._TREE
    assert "kSlab = kTree * kTree;" in CSRC and gr._SLAB == gr._TREE ** 2
