"""The memory ledger (telemetry/memory.py) of the port against the JAX
package's, on the CPU.

The same pools (plain host objects with a seeded byte count, entry count
and tallies) register with a fresh accountant of each package: the
snapshots, the hbm_report pool rows and the gtpu_mem_* publication agree
exactly, and the global device watermark evicts the same bytes from the
same pools in the same order. The census differs by design: the JAX
package reconciles against `jax.live_arrays()`, the port against the CUDA
caching allocator (`torch.cuda.memory_allocated`, storages rounded to its
512-byte blocks), which on a process that never touched a card is empty;
its card side is `tests/test_torch_cuda.py`'s.
"""

import numpy as np
import pytest
import torch

from greptimedb_tpu.telemetry import memory as jax_mem
from greptimedb_tpu_torch.telemetry import memory as mem


class _Pool:
    def __init__(self, nbytes, entries, hits, evictable):
        self.nbytes = nbytes
        self.entries = entries
        self.hits = hits
        self.evicted = []
        self.evictable = evictable

    def stats(self):
        return {"bytes": self.nbytes, "entries": self.entries,
                "budget_bytes": 4 * self.nbytes, "hits": self.hits,
                "misses": 1, "evictions": len(self.evicted)}

    def evict(self, target):
        freed = min(self.nbytes, target)
        self.nbytes -= freed
        self.evicted.append(freed)
        return freed


def _ledger(module, seed):
    acct = module.MemoryAccountant()
    rng = np.random.default_rng(seed)
    pools = []
    for i in range(6):
        tier = ("device", "host")[int(rng.integers(2))]
        p = _Pool(int(rng.integers(1, 10_000)), int(rng.integers(100)),
                  int(rng.integers(50)), bool(rng.integers(2)))
        acct.register_pool(f"pool{i % 4}", tier, p, stats=_Pool.stats,
                           evict=_Pool.evict if p.evictable else None)
        pools.append(p)
    return acct, pools


@pytest.mark.parametrize("seed", range(4))
def test_snapshots_match(seed):
    # the pools stay referenced: the ledger holds them weakly
    (pa, pp), (ja, jp) = _ledger(mem, seed), _ledger(jax_mem, seed)
    assert pp and jp
    assert [s.to_doc() for s in pa.snapshot()] == \
        [s.to_doc() for s in ja.snapshot()]
    assert pa.device_bytes() == ja.device_bytes()


@pytest.mark.parametrize("seed", range(4))
def test_watermark_evicts_alike(seed):
    (pa, pp), (ja, jp) = _ledger(mem, seed), _ledger(jax_mem, seed)
    budget = pa.device_bytes() // 3
    pa.device_budget_bytes = ja.device_budget_bytes = budget
    assert pa.enforce_device_budget() == ja.enforce_device_budget()
    assert [p.evicted for p in pp] == [p.evicted for p in jp]
    assert pa.device_bytes() == ja.device_bytes()


def test_a_collected_pool_leaves_the_ledger():
    for module in (mem, jax_mem):
        acct = module.MemoryAccountant()
        p = _Pool(10, 1, 0, False)
        acct.register_pool("gone", "host", p, stats=_Pool.stats)
        assert [s.name for s in acct.snapshot()] == ["gone"]
        del p
        assert acct.snapshot() == []


def test_bad_tier_raises_alike():
    for module in (mem, jax_mem):
        with pytest.raises(ValueError, match="tier must be device|host"):
            module.MemoryAccountant().register_pool(
                "x", "disk", _Pool(1, 1, 0, False), stats=_Pool.stats)


def test_hbm_text_renders_the_pools():
    acct, pools = _ledger(mem, 0)
    assert pools
    doc = {"pools": [s.to_doc() for s in acct.snapshot()],
           "device_budget_bytes": 0,
           "census": {"live_bytes": 0, "accounted_bytes": 0,
                      "unaccounted_bytes": 0, "unaccounted_count": 0},
           "top_buffers": []}
    assert mem.render_hbm_text(doc) == jax_mem.render_hbm_text(doc)


def test_cpu_census_is_empty_and_walks_only_cuda_tensors():
    acct = mem.MemoryAccountant()

    class _Dev:
        bufs = [torch.zeros(100), (torch.ones(3), "x")]

    pool = _Dev()
    acct.register_pool("d", "device", pool, stats=lambda p: {"bytes": 400},
                       buffers=lambda p: p.bufs)
    c = acct.census(top=3)
    assert c["live_bytes"] == c["accounted_bytes"] == 0
    assert c["unaccounted_bytes"] == 0 and c["top"] == []
    nested = {"a": [torch.zeros(2), (torch.zeros(1),)], "b": None}
    assert list(mem.iter_device_arrays(nested)) == []


@pytest.mark.parametrize("n,want", [(0, 0), (1, 512), (512, 512),
                                    (513, 1024), (4096, 4096)])
def test_allocator_block_rounding(n, want):
    assert mem._block_bytes(n) == want


def test_configure_applies_the_watermark():
    try:
        mem.configure({"device_budget_bytes": 1 << 40,
                       "census_on_scrape": False})
        acct = mem.global_accountant
        assert acct.device_budget_bytes == 1 << 40
        assert acct.census_on_scrape is False
    finally:
        mem.configure(None)
    assert mem.global_accountant.device_budget_bytes == 0
