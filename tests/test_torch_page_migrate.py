"""The port's migrate_pages, CPU path, == ``ref.migrate_pages`` == the
Pallas kernel in interpreter mode, exactly, on the cases of the JAX lane's
property test (``tests/test_kernels.py``), plus the port's own contract:
bfloat16 bits, ragged page shapes, untouched pages, index checks. The card
kernel's work plan (``copy_plan``: pages cut into chunks, items spread over
a persistent grid) covers every byte of every named page exactly once, and
run in plain PyTorch (``migrate_pages_planned_plain``) equals the same
three."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref
from repro.kernels.page_migrate import migrate_pages as pallas_migrate
from repro_torch import convert
from repro_torch.kernels.page_migrate import (
    CHUNK_BYTES,
    copy_plan,
    migrate_pages,
    migrate_pages_plain,
    migrate_pages_planned_plain,
)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_matches_ref_and_pallas(seed):
    g = np.random.default_rng(seed)
    Pd, Ps = int(g.integers(4, 12)), int(g.integers(4, 12))
    shape = (int(g.integers(2, 6)), int(g.integers(8, 24)))
    n = int(g.integers(1, min(Pd, Ps)))
    dst = g.normal(size=(Pd,) + shape).astype(np.float32)
    src = g.normal(size=(Ps,) + shape).astype(np.float32)
    di = g.choice(Pd, n, replace=False).astype(np.int32)
    si = g.choice(Ps, n, replace=False).astype(np.int32)
    want = np.asarray(ref.migrate_pages(jnp.asarray(dst), jnp.asarray(src),
                                        jnp.asarray(di), jnp.asarray(si)))
    pallas = np.asarray(pallas_migrate(jnp.asarray(dst), jnp.asarray(src),
                                       jnp.asarray(di), jnp.asarray(si),
                                       interpret=True))
    before = migrate_pages.launches
    got = migrate_pages(torch.from_numpy(dst.copy()), torch.from_numpy(src), di, si)
    assert migrate_pages.launches == before  # the CPU path launches nothing
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("page", [(3, 7), (5,), (2, 2, 3)])
def test_bfloat16_bits_and_untouched_pages(page):
    g = np.random.default_rng(len(page))
    dst = np.asarray(g.normal(size=(9,) + page), dtype=jnp.bfloat16)
    src = np.asarray(g.normal(size=(6,) + page), dtype=jnp.bfloat16)
    di, si = np.array([8, 0, 4]), np.array([1, 5, 0])
    want = np.asarray(ref.migrate_pages(jnp.asarray(dst), jnp.asarray(src),
                                        jnp.asarray(di), jnp.asarray(si)))
    d = convert.pool_from_numpy(dst)
    migrate_pages(d, convert.pool_from_numpy(src), torch.from_numpy(di), si)
    assert np.array_equal(convert.pool_bits(d), want.view(np.uint16))
    keep = np.setdiff1d(np.arange(9), di)
    assert np.array_equal(convert.pool_bits(d)[keep], dst.view(np.uint16)[keep])


def test_all_pages_and_empty_batch():
    g = torch.Generator().manual_seed(3)
    src = torch.randn((5, 4, 3), generator=g)
    dst = torch.zeros((5, 4, 3))
    perm = torch.randperm(5, generator=g)
    assert torch.equal(migrate_pages(dst, src, perm, torch.arange(5))[perm], src)
    assert migrate_pages(dst, src, [], []) is dst
    plain = migrate_pages_plain(torch.zeros_like(dst), src, perm, torch.arange(5))
    assert torch.equal(plain, dst)


def test_rejects_bad_indices():
    pool = torch.zeros((4, 8))
    with pytest.raises(IndexError):
        migrate_pages(pool, pool.clone(), [4], [0])
    with pytest.raises(IndexError):
        migrate_pages(pool, pool.clone(), [0], [-1])


def _coverage(plan, n, page_bytes):
    hits = np.zeros((n, page_bytes), dtype=np.uint8)
    for block in plan:
        for i, begin, end in block:
            assert 0 <= i < n and 0 <= begin < end <= page_bytes
            hits[i, begin:end] += 1
    return hits


@pytest.mark.parametrize("n", [1, 2, 17, 300])
@pytest.mark.parametrize("page_bytes", [1, 7, 16, 30, 8192, 8193, 1_835_008])
@pytest.mark.parametrize("sm_count", [1, 3, 132])
def test_copy_plan_covers_every_byte_once(n, page_bytes, sm_count):
    if n * page_bytes > 4_000_000:
        n = 2  # the full Qwen3-1.7B page: at most two pages
    plan = copy_plan(n, page_bytes, sm_count)
    items = n * -(-page_bytes // CHUNK_BYTES)
    assert len(plan) == min(items, 6 * sm_count)
    assert all(plan)  # no block without work
    assert np.all(_coverage(plan, n, page_bytes) == 1)


@pytest.mark.parametrize("chunk_bytes,blocks_per_sm", [(16, 1), (24, 2), (5, 3), (64, 1)])
def test_copy_plan_more_items_than_blocks(chunk_bytes, blocks_per_sm):
    n, page_bytes, sm = 9, 100, 2  # 100 is a multiple of neither 16 nor the chunk
    plan = copy_plan(n, page_bytes, sm, chunk_bytes, blocks_per_sm)
    items = n * -(-page_bytes // chunk_bytes)
    assert len(plan) == blocks_per_sm * sm < items
    # block b takes items b, b + grid, ...: the counts differ by at most one
    sizes = [len(b) for b in plan]
    assert max(sizes) - min(sizes) <= 1 and sum(sizes) == items
    assert np.all(_coverage(plan, n, page_bytes) == 1)


def test_copy_plan_one_page_spreads_over_the_card():
    # a one-page promotion of Qwen3-1.7B's KV page: 224 chunks, 224 blocks
    plan = copy_plan(1, 1_835_008, 132)
    assert len(plan) == 224 and all(len(b) == 1 for b in plan)


def test_copy_plan_rejects_empty_chunks():
    with pytest.raises(ValueError):
        copy_plan(1, 10, 1, chunk_bytes=0)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), chunk=st.integers(1, 40), bps=st.integers(1, 3))
def test_planned_plain_matches_ref_and_pallas(seed, chunk, bps):
    g = np.random.default_rng(seed)
    Pd, Ps = int(g.integers(4, 12)), int(g.integers(4, 12))
    shape = (int(g.integers(1, 4)), int(g.integers(1, 9)))  # pages of 4 to 128 bytes
    n = int(g.integers(1, min(Pd, Ps)))
    dst = g.normal(size=(Pd,) + shape).astype(np.float32)
    src = g.normal(size=(Ps,) + shape).astype(np.float32)
    di = g.choice(Pd, n, replace=False).astype(np.int32)
    si = g.choice(Ps, n, replace=False).astype(np.int32)
    want = np.asarray(ref.migrate_pages(jnp.asarray(dst), jnp.asarray(src),
                                        jnp.asarray(di), jnp.asarray(si)))
    pallas = np.asarray(pallas_migrate(jnp.asarray(dst), jnp.asarray(src),
                                       jnp.asarray(di), jnp.asarray(si),
                                       interpret=True))
    got = migrate_pages_planned_plain(torch.from_numpy(dst.copy()), torch.from_numpy(src),
                                      di, si, sm_count=2, chunk_bytes=chunk,
                                      blocks_per_sm=bps)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("page", [(7,), (3, 5), (917_504,)])
def test_planned_plain_bfloat16_matches_plain(page):
    # bf16 pages of 14 and 30 bytes (not a multiple of 16), and the full
    # Qwen3-1.7B KV page (224 chunks)
    g = torch.Generator().manual_seed(len(page))
    P = 4 if page[0] > 1000 else 12
    src = torch.randn((P,) + page, generator=g).to(torch.bfloat16)
    dst = torch.randn((P,) + page, generator=g).to(torch.bfloat16)
    for n in (1, 3):
        di, si = torch.randperm(P, generator=g)[:n], torch.randperm(P, generator=g)[:n]
        want = migrate_pages_plain(dst.clone(), src, di, si)
        got = migrate_pages_planned_plain(dst.clone(), src, di, si, sm_count=132)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
