"""The port's migrate_pages, CPU path, == ``ref.migrate_pages`` == the
Pallas kernel in interpreter mode, exactly, on the cases of the JAX lane's
property test (``tests/test_kernels.py``), plus the port's own contract:
bfloat16 bits, ragged page shapes, untouched pages, index checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref
from repro.kernels.page_migrate import migrate_pages as pallas_migrate
from repro_torch import convert
from repro_torch.kernels.page_migrate import migrate_pages, migrate_pages_plain


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
