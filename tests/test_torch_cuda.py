"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided inside a
fixture, never at import). Run them on a machine with an H100:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
``victim_partition`` and ``migrate_pages`` must be exact (also at the main
path's shape 20 times over, and at Qwen3-1.7B's KV page); ``strided_probe``
is held to a float64 version within its rounding bound and
``paged_decode_attention`` (also to the plain version of its
split-and-merge) and ``flash_attention`` to their plain versions within
2e-4 (float32) or 2e-2 (bfloat16), ``wkv6`` to its plain version
within 3e-4 (float32 r, k, v; the float32 state always) or 2e-2 (bfloat16
r, k, v beside float32 w).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.page_migrate import migrate_pages, migrate_pages_plain
from repro_torch.kernels.paged_attention import (
    card_pages_per_split,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_decode_attention_split_plain,
)
from repro_torch.kernels import _build
from repro_torch.kernels.strided_probe import (
    bulk_reads,
    chain_length,
    grid_blocks,
    strided_probe,
    strided_probe_plain,
)
from repro_torch.kernels.victim_partition import (
    TILE,
    victim_partition,
    victim_partition_plain,
    victim_partition_tiled_plain,
)
from repro_torch.kernels.wkv6 import wkv6, wkv6_grid, wkv6_plain

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
    want = victim_partition_plain(f, d)
    # the look-back reads status words while other blocks write them: a
    # race would show as a difference in some of 20 runs
    for _ in range(20):
        assert torch.equal(victim_partition(f, d), want)


@pytest.mark.parametrize("tiles", [1, 2, 3])
@pytest.mark.parametrize("ragged", [0, 5])
def test_victim_partition_one_to_three_tiles_demand_on_a_boundary(cuda, tiles, ragged):
    rng = np.random.default_rng(tiles * 10 + ragged)
    n_cols = tiles * TILE - ragged
    fast = (rng.random((4, n_cols)) < 0.5).astype(np.int32)
    cum = np.cumsum(fast, axis=1)
    ends = [min(k * TILE, n_cols) - 1 for k in range(1, tiles + 1)]
    # the count through the first tile, through the last, one past the
    # first tile's, and past the supply
    demand = np.array([cum[0, ends[0]], cum[1, ends[-1]], cum[2, ends[0]] + 1,
                       cum[3, -1] + 3], dtype=np.int64)
    f, d = torch.from_numpy(fast).to(cuda), torch.from_numpy(demand).to(cuda)
    got = victim_partition(f, d)
    assert torch.equal(got, victim_partition_plain(f, d))
    assert torch.equal(got, victim_partition_tiled_plain(f, d))


def test_victim_partition_thousand_short_rows(cuda):
    rng = np.random.default_rng(1000)
    f = torch.from_numpy((rng.random((1000, 37)) < 0.5).astype(np.int32)).to(cuda)
    d = torch.from_numpy(rng.integers(-2, 40, size=1000)).to(cuda)
    before = victim_partition.launches
    got = victim_partition(f, d)
    assert victim_partition.launches == before + 1
    assert torch.equal(got, victim_partition_plain(f, d))


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


@pytest.mark.parametrize("n", [1, 17])
@pytest.mark.parametrize("direction", ["d2d", "h2d", "d2h"])
def test_migrate_pages_full_qwen3_page(cuda, n, direction):
    # Qwen3-1.7B's KV page: 28 layers x K/V x 16 tokens x 8 heads x 128, bf16
    g = torch.Generator().manual_seed(n)
    page = (28, 2, 16, 8, 128)
    src = torch.randn((20,) + page, generator=g).to(torch.bfloat16)
    dst = torch.randn((20,) + page, generator=g).to(torch.bfloat16)
    di, si = torch.randperm(20, generator=g)[:n], torch.randperm(20, generator=g)[:n]
    want = migrate_pages_plain(dst.clone(), src, di, si)
    s = src.pin_memory() if direction == "h2d" else src.to(cuda)
    d = dst.pin_memory() if direction == "d2h" else dst.to(cuda)
    migrate_pages(d, s, di.numpy(), si.numpy())
    torch.cuda.synchronize()
    assert torch.equal(d.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("width", [1024, 1029])
@pytest.mark.parametrize("ids_on_card", [False, True])
def test_migrate_pages_batch_larger_than_the_grid(cuda, width, ids_on_card):
    # 1,000 pages: more than the persistent grid's blocks and more host ids
    # than the kernel parameter holds; 4,096-byte pages take the TMA path,
    # 4,116-byte ones the threads
    g = torch.Generator().manual_seed(width)
    src = torch.randn((1200, width), generator=g)
    dst = torch.randn((1200, width), generator=g)
    di = torch.randperm(1200, generator=g)[:1000]
    si = torch.randperm(1200, generator=g)[:1000]
    want = migrate_pages_plain(dst.clone(), src, di, si)
    for direction in ("d2d", "h2d", "d2h"):
        s = src.pin_memory() if direction == "h2d" else src.to(cuda)
        d = dst.pin_memory() if direction == "d2h" else dst.to(cuda)
        ids = (di.to(cuda), si.to(cuda)) if ids_on_card else (di, si)
        migrate_pages(d, s, *ids)
        torch.cuda.synchronize()
        assert torch.equal(d.cpu(), want), direction


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
    _probe_within_bound(got, fast, slow, fi, si, ai_iters)


def _probe_within_bound(got, fast, slow, fi, si, ai_iters):
    # each term takes ai_iters roundings, the sum at most chain_length more
    # (a block's pages in order, then the blocks' partial rows)
    want = strided_probe_plain(fast, slow, fi, si, ai_iters, dtype=torch.float64)
    terms = strided_probe_plain(fast.abs(), slow.abs(), fi, si, ai_iters,
                                dtype=torch.float64)
    chain = chain_length(fi.numel() + si.numel(), fast.shape[1],
                         _build.sm_count(torch.cuda.current_device()))
    tol = (ai_iters + chain + 2) * 2.0**-24 * terms
    assert got.shape == (1, fast.shape[1])
    assert bool(((got.double() - want).abs() <= tol).all())


def _probe_pools(cuda, width, seed, rows=64):
    g = torch.Generator().manual_seed(seed)
    fast = torch.randn((rows, width), generator=g).to(cuda)
    slow = torch.randn((rows, width), generator=g).pin_memory()
    return g, fast, slow


@pytest.mark.parametrize("ai_iters", [1, 64])
@pytest.mark.parametrize("width,shift,bulk", [
    (1000, 0, True),    # 4,000-byte rows: TMA
    (1001, 0, False),   # 4,004-byte rows: the plain-load branch
    (1024, 1, False),   # a fast pool one float past alignment (a sliced view)
])
def test_strided_probe_row_widths_and_alignment(cuda, ai_iters, width, shift, bulk):
    g, fast, slow = _probe_pools(cuda, width, width + shift)
    if shift:
        flat = torch.randn(64 * width + shift, generator=g).to(cuda)
        fast = flat[shift:].view(64, width)
    addresses = [_build.device_address("strided_probe", p) for p in (fast, slow)]
    assert bulk_reads(addresses, [fast.stride(0), slow.stride(0)], width) is bulk
    fi = torch.randint(0, 64, (400,), generator=g)
    si = torch.randint(0, 64, (300,), generator=g)
    got = strided_probe(fast, slow, fi, si, ai_iters)
    torch.cuda.synchronize()
    _probe_within_bound(got, fast, slow, fi, si, ai_iters)


@pytest.mark.parametrize("where", ["one_below_grid", "one_above_grid",
                                   "one_fast_page", "one_slow_page"])
def test_strided_probe_page_counts_around_the_grid(cuda, where):
    g, fast, slow = _probe_pools(cuda, 1024, 7)
    grid = grid_blocks(10**6, 1024, _build.sm_count(torch.cuda.current_device()))
    nf, ns = {"one_below_grid": ((grid - 1) // 2, grid - 1 - (grid - 1) // 2),
              "one_above_grid": ((grid + 1) // 2, grid + 1 - (grid + 1) // 2),
              "one_fast_page": (1, 0), "one_slow_page": (0, 1)}[where]
    fi = torch.randint(0, 64, (nf,), generator=g)
    si = torch.randint(0, 64, (ns,), generator=g)
    got = strided_probe(fast, slow, fi, si, 7)
    torch.cuda.synchronize()
    _probe_within_bound(got, fast, slow, fi, si, 7)


def test_strided_probe_repeats_bit_identical(cuda):
    # a wrong mbarrier phase reads a stale ring stage only now and then
    g, fast, slow = _probe_pools(cuda, 1024, 11, rows=512)
    fi = torch.randint(0, 512, (2000,), generator=g).to(cuda)
    si = torch.randint(0, 512, (2000,), generator=g).to(cuda)
    first = strided_probe(fast, slow, fi, si, 64)
    torch.cuda.synchronize()
    _probe_within_bound(first, fast, slow, fi.cpu(), si.cpu(), 64)
    for _ in range(20):
        assert torch.equal(strided_probe(fast, slow, fi, si, 64), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep,hd", [(1, 64), (2, 128), (4, 64)])
def test_paged_attention_matches_plain(cuda, dtype, rep, hd):
    g = torch.Generator().manual_seed(rep * hd)
    B, KV, P, ps, ppseq = 5, 2, 32, 16, 6  # P >= B * ppseq distinct pages
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep,hd", [(2, 128), (4, 64)])
def test_paged_attention_long_sequences_match_plain_and_split_plain(cuda, dtype, rep, hd):
    # 40 pages of 16 a sequence: several splits, lengths that end mid-page in
    # the last split, a hole, a sequence with no valid token
    g = torch.Generator().manual_seed(rep + hd)
    B, KV, P, ps, ppseq = 4, 8, 200, 16, 40
    q = torch.randn((B, KV * rep, hd), generator=g).to(dtype).to(cuda)
    k = torch.randn((P, ps, KV, hd), generator=g).to(dtype).to(cuda)
    v = torch.randn((P, ps, KV, hd), generator=g).to(dtype).to(cuda)
    tbl = torch.randperm(P, generator=g)[: B * ppseq].view(B, ppseq).to(torch.int32)
    tbl[0, 5] = -1
    lens = torch.tensor([633, 0, 250, 639], dtype=torch.int32)
    tbl_d, lens_d = tbl.to(cuda), lens.to(cuda)
    pps = card_pages_per_split(q, k, tbl_d)
    assert -(-ppseq // pps) >= 3
    got = paged_decode_attention(q, k, v, tbl_d, lens_d)
    torch.cuda.synchronize()
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    for want in (paged_decode_attention_plain(q, k, v, tbl_d, lens_d),
                 paged_decode_attention_split_plain(q, k, v, tbl_d, lens_d, pps)):
        assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    assert not bool(got[1].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_unaligned_pool_matches_plain(cuda, dtype):
    # pools that start one element past a 16-byte boundary take the
    # kernel's plain-load path instead of cp.async
    g = torch.Generator().manual_seed(7)
    B, KV, P, ps, ppseq, hd = 3, 2, 24, 16, 6, 64
    flat = torch.randn((2, P * ps * KV * hd + 1), generator=g).to(dtype).to(cuda)
    k, v = (flat[i, 1:].view(P, ps, KV, hd) for i in (0, 1))
    assert k.data_ptr() % 16 and v.data_ptr() % 16
    q = torch.randn((B, KV * 2, hd), generator=g).to(dtype).to(cuda)
    tbl = torch.randperm(P, generator=g)[: B * ppseq].view(B, ppseq).to(torch.int32)
    tbl[0, 1] = -1
    lens = torch.tensor([90, 0, 41], dtype=torch.int32)
    got = paged_decode_attention(q, k, v, tbl, lens)
    torch.cuda.synchronize()
    want = paged_decode_attention_plain(q, k, v, tbl.to(cuda), lens.to(cuda))
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    assert not bool(got[1].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal", [
    (1, 1000, 1000, 16, 8, 128, True),  # multi-tile causal: the K/V ring
    (1, 2047, 2047, 16, 8, 128, True),
    (1, 128, 128, 4, 2, 64, True),
    (2, 100, 100, 16, 8, 128, True),  # ragged tail, Qwen3's head layout
    (1, 64, 192, 8, 2, 128, False),
    (1, 33, 65, 2, 1, 64, True),  # T > S: right-aligned causal queries
    (2, 48, 20, 4, 2, 16, True),  # S > T: the first rows see no key
    (1, 40, 40, 4, 4, 32, False),
])
def test_flash_attention_matches_plain(cuda, dtype, B, S, T, H, KV, hd, causal):
    g = torch.Generator().manual_seed(S * T + hd)
    q = torch.randn((B, S, H, hd), generator=g).to(dtype).to(cuda)
    k = torch.randn((B, T, KV, hd), generator=g).to(dtype).to(cuda)
    v = torch.randn((B, T, KV, hd), generator=g).to(dtype).to(cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    if causal and S > T:
        assert not bool(got[:, : S - T].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd", [(2, 64, 2, 32), (1, 100, 4, 64), (2, 32, 2, 16),
                                      (1, 19, 2, 128), (2, 300, 8, 64)])
def test_wkv6_matches_plain(cuda, dtype, B, S, H, hd):
    _wkv6_matches_plain(cuda, dtype, B, S, H, hd)


def _wkv6_inputs(cuda, dtype, B, S, H, hd, strong=False):
    g = torch.Generator().manual_seed(S * H + hd + strong)
    r, k, v = ((torch.randn((B, S, H, hd), generator=g) * 0.5).to(dtype).to(cuda)
               for _ in range(3))
    x = torch.randn((B, S, H, hd), generator=g)
    # strong decays: exp(-exp(x + 2)), many under 1e-3
    w = torch.exp(-torch.exp(x + 2.0 if strong else x * 0.5 - 4.0)).to(cuda)
    u = (torch.randn((H, hd), generator=g) * 0.3).to(cuda)
    return r, k, v, w, u


def _wkv6_matches_plain(cuda, dtype, B, S, H, hd, strong=False):
    r, k, v, w, u = _wkv6_inputs(cuda, dtype, B, S, H, hd, strong)
    before = wkv6.launches
    o, state = wkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    o_want, state_want = wkv6_plain(r, k, v, w, u)
    tol = 3e-4 if dtype == torch.float32 else 2e-2
    assert o.dtype == dtype and state.dtype == torch.float32
    assert torch.allclose(o.float(), o_want.float(), rtol=tol, atol=tol)
    assert torch.allclose(state, state_want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_wkv6_strong_decays(cuda, dtype, hd):
    _wkv6_matches_plain(cuda, dtype, 2, 45, 3, hd, strong=True)


@pytest.mark.parametrize("S", [1, 15, 17, 2048])
def test_wkv6_sequence_lengths_at_rwkv6_3b_heads(cuda, S):
    _wkv6_matches_plain(cuda, torch.bfloat16, 1, S, 40, 64)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_wkv6_every_head_size_with_its_columns_split(cuda, hd):
    B, H = 2, 3
    assert wkv6_grid(hd, B * H, _build.sm_count(torch.cuda.current_device()))[1] > 1
    _wkv6_matches_plain(cuda, torch.bfloat16, B, 70, H, hd)


def test_wkv6_repeats_bit_identical(cuda):
    args = _wkv6_inputs(cuda, torch.bfloat16, 2, 300, 40, 64, strong=True)
    o1, s1 = wkv6(*args)
    for _ in range(10):
        o, s = wkv6(*args)
        assert torch.equal(o, o1) and torch.equal(s, s1)


def test_wkv6_refuses_a_bf16_decay(cuda):
    x = torch.zeros((1, 4, 2, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        wkv6(x, x, x, x, torch.zeros((2, 16), device=cuda))


def _runs_plain(rs):
    from dataclasses import asdict

    return [
        (r.scenario, r.policy, r.fm_frac, r.backend, r.result.stats,
         r.result.interval_times.tolist(), r.result.fm_sizes.tolist(),
         [asdict(c) for c in r.result.configs],
         None if r.decisions is None else [
             {**d.__dict__, "config": asdict(d.config)} for d in r.decisions],
         None if r.watermark_log is None else [e.__dict__ for e in r.watermark_log],
         r.fault_events, r.arbiter_log)
        for r in rs.runs
    ]


def _small_db():
    from repro_torch import convert

    grid = np.round(np.arange(1.0, 0.19, -0.05), 3)
    return convert.perfdb_from_records([{
        "config": dict(pacc_f=10_000, pacc_s=500, pm_de=20, pm_pr=20, ai=6.0,
                       rss_pages=4_000, hot_thr=4, num_threads=1),
        "fm_fracs": grid, "times": 1.0 + np.linspace(0.0, 0.4, grid.size),
    }])


HARSH = dict(seed=7, promote_fail_rate=0.2, max_retries=2, backoff_base=1,
             demote_fail_rate=0.1, kswapd_stall_rate=0.05, kswapd_stall_len=2,
             telemetry_drop_rate=0.15, telemetry_noise_rate=0.2,
             telemetry_noise_scale=0.5, db_outage_rate=0.15, db_outage_len=2,
             actuation_lag=1)


def test_harsh_fault_sweep_on_the_card_equals_the_cpu_lane(cuda):
    from repro_torch.sim import api
    from repro_torch.sim.faults import FaultSpec
    from repro_torch.sim.workloads import thrash_trace

    tr = thrash_trace(rss_pages=3_000, n_intervals=10)
    db = _small_db()
    out = {}
    for device in ("cpu", cuda):
        before = victim_partition.launches
        out[str(device)] = _runs_plain(api.run(api.Experiment(
            scenarios=[api.Scenario(trace=tr, faults=FaultSpec(**HARSH))],
            fm_fracs=(0.8, 0.45, 0.2),
            policies=[api.PolicySpec(label="tpp"), api.PolicySpec(
                label="tuna", fm_frac=1.0, tuner=api.TunerSpec(tune_every=2))],
        ), db=db, device=device))
        launched = victim_partition.launches - before
    assert out["cpu"] == out["cuda"]
    assert launched > 0
    assert all(run[10] for run in out["cuda"])  # fault events on every slice


def test_two_tenant_fleet_on_the_card_equals_the_cpu_lane(cuda):
    from repro_torch.fleet import ArbiterSpec, FleetScenario, TenantSpec
    from repro_torch.sim import api
    from repro_torch.sim.faults import FaultSpec
    from repro_torch.sim.workloads import thrash_trace

    tenants = (
        TenantSpec(trace=thrash_trace(rss_pages=3_000, n_intervals=10, seed=1), name="a"),
        TenantSpec(trace=thrash_trace(rss_pages=2_000, n_intervals=8, seed=2),
                   name="b", ceil_frac=0.4),
    )
    db = _small_db()
    out = {}
    for device in ("cpu", cuda):
        before = victim_partition.launches
        out[str(device)] = _runs_plain(api.run(api.Experiment(
            scenarios=[FleetScenario(tenants=tenants, budget_frac=0.5,
                                     arbiter=ArbiterSpec(every=2),
                                     faults=FaultSpec(**HARSH))],
            fm_fracs=(1.0,),
            policies=[api.PolicySpec(label="static"), api.PolicySpec(
                label="tuna", tuner=api.TunerSpec(target_loss=0.1, tune_every=2))],
        ), db=db, device=device))
        launched = victim_partition.launches - before
    assert out["cpu"] == out["cuda"]
    assert launched > 0
    assert all(run[11] for run in out["cuda"] if run[1] == "tuna")  # arbiter log


# ------------------------------------------------------------ timing replay
def _streams(dev, seed=0):
    """Seeded replays built by the engine on ``dev``: random pages, one page
    hammered, pages twice in a window, writes, one-event windows."""
    import dataclasses

    from repro_torch.sim.costmodel import OPTANE_LIKE
    from repro_torch.timing import AddressTimingEngine, TimingParams

    rng = np.random.default_rng(seed)
    base = TimingParams.from_profile(OPTANE_LIKE, max_events=20_000)
    w1 = dataclasses.replace(base, window=1.0)
    cases = [
        (base, 4, dict(counts=rng.integers(1, 80, size=3_000),
                       tiers=rng.integers(0, 2, size=3_000), rand_frac=0.7)),
        (base, 2, dict(counts=np.array([70_000]), tiers=np.array([1]))),
        (base, 8, dict(counts=np.array([9_000, 7_000, 3]), tiers=np.array([0, 1, 1]))),
        (base, 4, dict(counts=rng.integers(1, 300, size=1_000),
                       tiers=rng.integers(0, 2, size=1_000), rand_frac=0.5,
                       writes=rng.integers(0, 150, size=1_000), pm_pr=50, pm_de=70)),
        (w1, 1, dict(counts=rng.integers(1, 30, size=500),
                     tiers=rng.integers(0, 2, size=500))),
    ]
    out = []
    for i, (params, threads, kw) in enumerate(cases):
        eng = AddressTimingEngine(params, seed=seed, device=dev)
        counts = np.asarray(kw.pop("counts"), dtype=np.int64)
        _, (ev, w, chan) = eng._prepare(
            index=i, pages=np.arange(counts.size), counts=counts,
            tiers=np.asarray(kw.pop("tiers"), dtype=np.int8), ops=0.0,
            num_threads=threads, **kw)
        out.append((ev, w, chan))
    return out


def _launch_args(streams, dev):
    sizes = [ev.page.numel() for ev, _, _ in streams]
    off = np.concatenate([[0], np.cumsum(sizes)])
    return (torch.cat([ev.page for ev, _, _ in streams]),
            torch.cat([ev.tier for ev, _, _ in streams]),
            torch.cat([ev.occ for ev, _, _ in streams]),
            torch.cat([ev.lat for ev, _, _ in streams]),
            torch.from_numpy(off).to(dev),
            torch.tensor([w for _, w, _ in streams], dtype=torch.int64, device=dev),
            torch.tensor([c for _, _, c in streams], dtype=torch.float64, device=dev),
            torch.tensor([ev.n_pages for ev, _, _ in streams], dtype=torch.int64,
                         device=dev))


def test_timing_replay_matches_plain(cuda):
    from repro_torch.kernels.timing_replay import timing_replay

    card = _streams(cuda)
    host = _streams("cpu")
    for (a, wa, ca), (b, wb, cb) in zip(card, host):
        assert (wa, ca, a.scale) == (wb, cb, b.scale)
        for f in ("page", "tier", "occ", "lat"):
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f))
    assert card[-1][1] == 1
    args = _launch_args(card, cuda)
    before = timing_replay.launches
    got = timing_replay(*args)
    torch.cuda.synchronize()
    assert timing_replay.launches == before + 1
    want = timing_replay(*[x.cpu() for x in args])
    assert got.cpu().tolist() == want.tolist()
    for _ in range(5):
        assert torch.equal(timing_replay(*args), got)


def test_timing_replay_empty_replay_ends_at_its_preload(cuda):
    from repro_torch.kernels.timing_replay import timing_replay

    (ev, w, chan), = _streams(cuda)[:1]
    args = _launch_args([(ev, w, chan), (ev.__class__(
        page=ev.page[:0], tier=ev.tier[:0], occ=ev.occ[:0], lat=ev.lat[:0],
        scale=1.0, n_pages=1), 3, (4e-6, 2e-6)), (ev, w, chan)], cuda)
    got = timing_replay(*args).cpu().tolist()
    assert got[1] == 4e-6 and got[0] == got[2]
    assert got == timing_replay(*[x.cpu() for x in args]).tolist()


def test_timing_replay_spans_blocks(cuda):
    """300 replays, three blocks of the kernel: each replay's row of
    ``page_done`` and of ready times at its own offset, equal to the plain
    version replay by replay."""
    from repro_torch.kernels.timing_replay import timing_replay

    base = _streams(cuda)
    streams = []
    for k in range(300):
        ev, w, chan = base[k % 5]
        n = 100 + 3 * k
        streams.append((ev.__class__(page=ev.page[:n], tier=ev.tier[:n], occ=ev.occ[:n],
                                     lat=ev.lat[:n], scale=ev.scale, n_pages=ev.n_pages),
                        w, chan))
    args = _launch_args(streams, cuda)
    got = timing_replay(*args).cpu().tolist()
    assert got == timing_replay(*[x.cpu() for x in args]).tolist()


def test_chain_latency_is_measured(cuda):
    from repro_torch.kernels.timing_replay import chain_latency_ns

    for n in (4_096, 3_250_585):
        links = chain_latency_ns(n, cuda)
        assert set(links) == {"load_ns", "f64_add_ns"}
        assert 0.0 < links["f64_add_ns"] < links["load_ns"] < 1e5


def test_timing_runner_on_the_card_equals_the_cpu(cuda):
    import functools

    from repro_torch.kernels.timing_replay import timing_replay
    from repro_torch.sim import api
    from repro_torch.sim.costmodel import OPTANE_LIKE
    from repro_torch.sim.workloads import thrash_trace
    from repro_torch.timing import calibrate, timing_runner

    cal = calibrate(OPTANE_LIKE, device=cuda)
    assert cal.to_dict() == calibrate(OPTANE_LIKE, device="cpu").to_dict()
    tr = thrash_trace(rss_pages=4_000, n_intervals=8)
    out = {}
    for device in ("cpu", cuda):
        before = timing_replay.launches
        runner = functools.partial(timing_runner, calibration=cal.to_dict(), device=device)
        rs = api.run(api.Experiment(
            scenarios=[api.Scenario(trace=tr, name="t", runner=runner)],
            fm_fracs=(1.0, 0.5)), device=device)
        out[str(device)] = [r.result for r in rs.runs]
        launched = timing_replay.launches - before
    assert out["cpu"] == out["cuda"]
    assert launched == 2  # one launch a (spec, size): every interval at once


def test_first_touch_sweep_on_the_card_equals_the_cpu(cuda):
    from repro_torch.sim import api
    from repro_torch.sim.faults import FaultSpec
    from repro_torch.sim.workloads import thrash_trace

    tr = thrash_trace(rss_pages=5_000, n_intervals=10)
    out = {}
    for device in ("cpu", cuda):
        before = victim_partition.launches
        out[str(device)] = _runs_plain(api.run(api.Experiment(
            scenarios=[api.Scenario(trace=tr, faults=FaultSpec(**HARSH))],
            fm_fracs=(1.0, 0.895, 0.5, 0.266),
            policies=[api.PolicySpec(kind="first_touch")]), device=device))
        launched = victim_partition.launches - before
    assert out["cpu"] == out["cuda"]
    assert launched == 0  # first touch selects no victims
