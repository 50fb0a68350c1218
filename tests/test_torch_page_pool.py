"""The port's standalone page pool == the JAX package's
``repro.tiering.page_pool.TieredPagePool``, exactly, over seeded sequences
of placements, accesses, interval ends and size changes: tiers, the fast
index's order (which the KV cache's unstable victim sort reads), heat,
stats and the occupancy counters."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.tiering.page_pool import Tier as JTier
from repro.tiering.page_pool import TieredPagePool as JaxPool
from repro_torch.tiering.page_pool import Tier, TieredPagePool


def _assert_same(ref, port):
    assert np.array_equal(np.asarray(ref.tier), np.asarray(port.tier))
    assert np.array_equal(ref.fast_pages(), port.fast_pages())
    every = np.arange(ref.num_pages)
    assert np.array_equal(ref.heat_of(every), port.heat_of(every))
    assert ref.stats.snapshot() == port.stats.snapshot()
    assert ref.rss_pages == port.rss_pages
    assert ref.fast_used == port.fast_used
    assert ref.effective_fm_size == port.effective_fm_size
    assert ref.watermarks.__dict__ == port.watermarks.__dict__


def _replay(seed, num_pages, cap, n_ops):
    rng = np.random.default_rng(seed)
    ref = JaxPool(num_pages=num_pages, hw_capacity=cap, page_bytes=512, seed=seed)
    port = TieredPagePool(num_pages=num_pages, hw_capacity=cap, page_bytes=512,
                          seed=seed)
    for _ in range(n_ops):
        op = rng.integers(0, 4)
        if op == 0:  # accesses, duplicates and first touches included
            n = int(rng.integers(1, num_pages))
            pages = rng.integers(0, num_pages, size=n)
            counts = rng.integers(1, 6, size=n)
            touches = rng.integers(0, 4, size=n)
            cap_t = None if rng.random() < 0.5 else int(rng.integers(1, 5))
            assert ref.apply_accesses(pages, counts, touches, cap_t) == \
                port.apply_accesses(pages, counts, touches, cap_t)
        elif op == 1:  # explicit moves, as the KV cache promotes and demotes
            pages = rng.choice(num_pages, size=int(rng.integers(0, min(12, num_pages))),
                               replace=False)
            tier = int(rng.integers(-1, 2))
            ref.place(pages, JTier(tier))
            port.place(pages, Tier(tier))
        elif op == 2:
            ref.end_interval()
            port.end_interval()
        else:
            fm = int(rng.integers(1, cap + 1))
            ref.set_fm_size(fm)
            port.set_fm_size(fm)
        _assert_same(ref, port)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n_ops=st.integers(1, 60))
def test_standalone_pool_matches_jax(seed, n_ops):
    rng = np.random.default_rng(seed)
    num_pages = int(rng.integers(8, 300))
    cap = int(rng.integers(1, num_pages + 1))
    _replay(seed, num_pages, cap, n_ops)


@pytest.mark.parametrize("num_pages,cap", [(64, 16), (2_000, 500)])
def test_dense_and_sparse_interval_folds(num_pages, cap):
    # long runs cross both fold paths (an eighth of the pool touched or not)
    # and leave pages stale for several intervals before they are read
    _replay(num_pages, num_pages, cap, 200)


def test_slice_pool_keeps_the_sweep_constructor():
    row = np.full(10, -1, dtype=np.int8)
    pool = TieredPagePool.for_slice(row, hw_capacity=4, page_bytes=4096)
    pool.place(np.array([1, 2, 3]), Tier.FAST)
    pool.place(np.array([2]), Tier.SLOW)
    assert (pool.fast_used, pool.rss_pages) == (2, 3)
    assert row[2] == int(Tier.SLOW)
    with pytest.raises(ValueError):
        TieredPagePool.for_slice(np.zeros(4, np.int64), hw_capacity=2)
