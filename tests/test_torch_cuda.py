"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided inside a
fixture, never at import). Run them on a machine with an H100:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
``victim_partition`` and ``migrate_pages`` must be exact; ``strided_probe``
is held to a float64 version within its rounding bound and
``paged_decode_attention`` to its plain version within 2e-4 (float32) or
2e-2 (bfloat16).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.page_migrate import migrate_pages, migrate_pages_plain
from repro_torch.kernels.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from repro_torch.kernels.strided_probe import strided_probe, strided_probe_plain
from repro_torch.kernels.victim_partition import (
    victim_partition,
    victim_partition_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(rng, shape, density, tight):
    s, r = shape
    fast = (rng.random((s, r)) < density).astype(np.int32)
    hi = fast.sum(axis=1) + 1 if tight else np.full(s, r + 2)
    demand = rng.integers(0, hi + 1).astype(np.int64)
    return fast, demand


@pytest.mark.parametrize(
    "shape", [(1, 1), (3, 7), (4, 4096), (2, 4097), (5, 100_003)]
)
@pytest.mark.parametrize("tight", [True, False])
def test_victim_partition_matches_plain(cuda, shape, tight):
    rng = np.random.default_rng(shape[1] + tight)
    for density in (0.0, 0.3, 1.0):
        fast, demand = _rows(rng, shape, density, tight)
        f = torch.from_numpy(fast).to(cuda)
        d = torch.from_numpy(demand).to(cuda)
        before = victim_partition.launches
        got = victim_partition(f, d)
        torch.cuda.synchronize()
        assert victim_partition.launches == before + 1
        want = victim_partition_plain(f, d)
        assert torch.equal(got, want)


def test_victim_partition_strided_rows(cuda):
    # a row stride that is not a multiple of 4 takes the scalar path
    rng = np.random.default_rng(5)
    base = torch.from_numpy((rng.random((6, 9001)) < 0.5).astype(np.int32))
    f = base.to(cuda)[:, 3:8999]
    d = torch.tensor([0, 1, 17, 2000, 4500, 10_000], device=cuda)
    assert torch.equal(victim_partition(f, d), victim_partition_plain(f, d))


def test_victim_partition_main_path_shape(cuda):
    rng = np.random.default_rng(11)
    f = torch.from_numpy(
        (rng.random((20, 3_250_585)) < 0.6).astype(np.int32)
    ).to(cuda)
    d = torch.from_numpy(
        rng.integers(0, 2_500_000, size=20).astype(np.int64)
    ).to(cuda)
    assert torch.equal(victim_partition(f, d), victim_partition_plain(f, d))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("page", [(7,), (3, 5), (64, 33)])
@pytest.mark.parametrize("direction", ["d2d", "h2d", "d2h"])
def test_migrate_pages_matches_plain(cuda, dtype, page, direction):
    g = torch.Generator().manual_seed(len(page))
    src = torch.randn((9,) + page, generator=g).to(dtype)
    dst = torch.randn((6,) + page, generator=g).to(dtype)
    di, si = torch.tensor([5, 0, 2]), torch.tensor([8, 1, 3])
    want = migrate_pages_plain(dst.clone(), src, di, si)
    host = {"d2d": (), "h2d": ("src",), "d2h": ("dst",)}[direction]
    s = src.pin_memory() if "src" in host else src.to(cuda)
    d = dst.pin_memory() if "dst" in host else dst.to(cuda)
    before = migrate_pages.launches
    migrate_pages(d, s, di, si)
    torch.cuda.synchronize()
    assert migrate_pages.launches == before + 1
    assert torch.equal(d.cpu(), want)


def test_migrate_pages_refuses_pageable_host_memory(cuda):
    with pytest.raises(ValueError, match="pinned"):
        migrate_pages(torch.zeros((2, 8), device=cuda), torch.ones((2, 8)), [0], [1])


@pytest.mark.parametrize("ai_iters", [0, 1, 7, 64])
@pytest.mark.parametrize("nf,ns", [(40, 30), (0, 9), (9, 0), (3000, 1000)])
def test_strided_probe_matches_float64(cuda, ai_iters, nf, ns):
    g = torch.Generator().manual_seed(nf + ns)
    fast = torch.randn((64, 1024), generator=g).to(cuda)
    slow = torch.randn((64, 1024), generator=g).pin_memory()
    fi = torch.randint(0, 64, (nf,), generator=g)
    si = torch.randint(0, 64, (ns,), generator=g)
    got = strided_probe(fast, slow, fi, si, ai_iters)
    torch.cuda.synchronize()
    want = strided_probe_plain(fast, slow, fi, si, ai_iters, dtype=torch.float64)
    # each term takes ai_iters roundings, the sum at most nf + ns more
    terms = strided_probe_plain(fast.abs(), slow.abs(), fi, si, ai_iters,
                                dtype=torch.float64)
    tol = (ai_iters + nf + ns + 2) * 2.0**-24 * terms
    assert bool(((got.double() - want).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep,hd", [(1, 64), (2, 128), (4, 64)])
def test_paged_attention_matches_plain(cuda, dtype, rep, hd):
    g = torch.Generator().manual_seed(rep * hd)
    B, KV, P, ps, ppseq = 5, 2, 24, 16, 6
    q = torch.randn((B, KV * rep, hd), generator=g).to(dtype).to(cuda)
    k = torch.randn((P, ps, KV, hd), generator=g).to(dtype).to(cuda)
    v = torch.randn((P, ps, KV, hd), generator=g).to(dtype).to(cuda)
    tbl = torch.randperm(P, generator=g)[: B * ppseq].view(B, ppseq).to(torch.int32)
    tbl[1, 2] = -1  # a hole
    lens = torch.tensor([1, 50, 96, 0, 77], dtype=torch.int32)  # row 3 masked
    got = paged_decode_attention(q, k, v, tbl, lens)
    torch.cuda.synchronize()
    want = paged_decode_attention_plain(q, k, v, tbl.to(cuda), lens.to(cuda))
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    assert not bool(got[3].any())
