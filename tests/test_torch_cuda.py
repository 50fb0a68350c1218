"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided inside a
fixture, never at import). Run them on a machine with an H100:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
``victim_partition`` and ``migrate_pages`` must be exact (also at the main
path's shape 20 times over, and at Qwen3-1.7B's KV page); ``strided_probe``
is held to a float64 version within its rounding bound and
``paged_decode_attention`` (also to the plain version of its
split-and-merge) and ``flash_attention`` to their plain versions within
2e-4 (float32) or 2e-2 (bfloat16), ``ops.decode_attention`` (the same
kernel over a model's decode cache in place) to its plain version within
1e-4 (float32) or 1e-2 (bfloat16) of the output's largest element,
``wkv6`` to its plain version within 3e-4 (float32 r, k, v; the float32
state always) or 2e-2 (bfloat16 r, k, v beside float32 w). The backward kernels ``flash_attention_bwd``
and ``wkv6_bwd`` are held to autograd of the plain versions within 1e-4
(float32) or 1e-2 (bfloat16) of each gradient's largest value, and repeat
bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels import ops
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
    pps = card_pages_per_split(q, k, tbl_d.shape[1], k.shape[1])
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


def _decode_case(cuda, dtype, B, S_max, KV, rep, hd, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, 1, KV * rep, hd), generator=g).to(dtype).to(cuda)
    kc = torch.randn((B, S_max, KV, hd), generator=g).to(dtype).to(cuda)
    vc = torch.randn((B, S_max, KV, hd), generator=g).to(dtype).to(cuda)
    return q, kc, vc


# The decode kernel's limit, as a share of the output's largest element. With
# random q, K and V an output element is a mean of ~valid_len rows of V,
# about sqrt(e / valid_len) (0.036 at 2,048 positions), so an absolute
# limit would grow loose with the length. Both versions compute in float32
# in another order; in bfloat16 they round that float32 value apart by at
# most one step, 2^-7 of the element.
DECODE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _decode_err(got, want) -> float:
    """max |got - want| as a share of max |want|."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def _decode_close(cuda, q, kc, vc, valid_len):
    """The kernel (one launch) against the plain version in the working
    type, within ``DECODE_TOL``."""
    before = ops.decode_attention.launches
    got = ops.decode_attention(q, kc, vc, valid_len)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    want = ops.decode_attention_plain(q, kc, vc, valid_len)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _decode_err(got, want) <= DECODE_TOL[q.dtype]
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 2, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("valid_len", [1, 1021, 2048])
def test_decode_attention_matches_plain(cuda, dtype, rep, hd, valid_len):
    # one position; 1,021 ends inside a tile of every dtype and head size
    # and inside a split; 2,048 is the whole cache
    q, kc, vc = _decode_case(cuda, dtype, 3, 2048, 2, rep, hd, rep * hd + valid_len)
    _decode_close(cuda, q, kc, vc, valid_len)


@pytest.mark.parametrize("H,KV", [(14, 2), (32, 2)])
def test_decode_attention_at_other_archs_heads(cuda, H, KV):
    # InternVL2-1B's 7 query heads a KV head (a block of 8, one idle) and
    # ChatGLM3-6B's 16 (two blocks of 8 a KV head), bfloat16
    q, kc, vc = _decode_case(cuda, torch.bfloat16, 2, 1500, KV, H // KV, 128, H)
    _decode_close(cuda, q, kc, vc, 1333)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_over_a_state_group(cuda, dtype):
    # the cache as the decode state holds it: state[name][g] of (G, B, S, KV,
    # hd), and a head slice whose token stride is not KV * hd
    g = torch.Generator().manual_seed(3)
    state = torch.randn((3, 2, 700, 4, 64), generator=g).to(dtype).to(cuda)
    q = torch.randn((2, 1, 8, 64), generator=g).to(dtype).to(cuda)
    _decode_close(cuda, q, state[1], state[2], 650)
    wide = torch.randn((2, 700, 7, 64), generator=g).to(dtype).to(cuda)
    _decode_close(cuda, q, wide[:, :, 1:5], wide[:, :, 3:7], 333)


def test_decode_attention_int8_cache_operands(cuda):
    # the int8 path: the first n positions quantized and dequantized to
    # contiguous (B, n, KV, hd) bfloat16 keys and values, n = valid_len
    from repro_torch.models.layers import dequantize_kv, quantize_kv

    q, kc, vc = _decode_case(cuda, torch.bfloat16, 2, 900, 2, 4, 128, 5)
    keys = dequantize_kv(*quantize_kv(kc[:, :517]))
    values = dequantize_kv(*quantize_kv(vc[:, :517]))
    _decode_close(cuda, q, keys, values, 517)


def test_decode_attention_at_the_decode_cells_layout(cuda):
    # 16 sequences, 16 query heads over 8 KV heads of 128, bfloat16, as the
    # decode cell has them, at a shorter cache
    q, kc, vc = _decode_case(cuda, torch.bfloat16, 16, 4096, 8, 2, 128, 9)
    got = _decode_close(cuda, q, kc, vc, 4000)
    assert not torch.equal(got, ops.decode_attention(q, kc, vc, 3999))
    # the limit sees a kernel that skipped a sixteenth of the positions
    n = 4000 // 16
    short = ops.decode_attention_plain(q, kc[:, n:], vc[:, n:], 4000 - n)
    assert _decode_err(got, short) > 10 * DECODE_TOL[torch.bfloat16]


def test_decode_attention_raises_on_what_it_does_not_take(cuda):
    q, kc, vc = _decode_case(cuda, torch.bfloat16, 2, 64, 2, 2, 64, 1)
    with pytest.raises(ValueError):
        ops.decode_attention(q, kc, vc, 65)  # past the cache
    with pytest.raises(ValueError):
        ops.decode_attention(q, kc.float(), vc.float(), 10)  # mixed dtypes
    with pytest.raises(ValueError):
        ops.decode_attention(q.expand(2, 2, 4, 64), kc, vc, 10)  # two positions


def test_qwen3_decode_step_launches_the_kernel_once_a_layer(cuda):
    from repro_torch import models as pm
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-1.7b").scaled(num_layers=28)
    params = pm.init_model(cfg, generator=torch.Generator(device=cuda).manual_seed(8),
                           device=cuda)
    state = pm.init_decode_state(cfg, 2, 32, device=cuda)
    tok = torch.zeros((2, 1), dtype=torch.long, device=cuda)
    before = ops.decode_attention.launches
    logits, _ = pm.decode_step(params, cfg, state, tok, 5)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches - before == 28 == cfg.num_layers
    assert bool(torch.isfinite(logits).all())


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
    """300 replays, more than the card's SMs: one warp (one block) a
    replay, each replay's events and per-event done times at their own
    offsets, equal to the plain version replay by replay."""
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
    assert args[5].numel() > torch.cuda.get_device_properties(cuda).multi_processor_count
    got = timing_replay(*args).cpu().tolist()
    assert got == timing_replay(*[x.cpu() for x in args]).tolist()


def _adversarial(dev, seed=0):
    """One launch of seeded streams (numpy): windows of 1, 2, 31, 32, 33,
    80 and 1,000 events, pages repeated at every distance from 1 to 100
    events (writers within and beyond the walker's prefetch distance), both
    tiers, write-sized occupancies, and an empty replay last."""
    rng = np.random.default_rng(seed)
    reps, windows = [], []
    for w, n, n_pages in ((1, 4_000, 3), (1, 6_000, 50), (1, 3_000, 2_000), (2, 3_000, 40),
                          (31, 4_000, 300), (32, 4_000, 64), (33, 4_000, 1_000),
                          (80, 8_000, 600), (1_000, 5_000, 900), (7, 0, 1)):
        page = rng.integers(0, n_pages, size=n)
        near = rng.random(n) < 0.3  # a third of the events repeat a page 1-100 back
        back = rng.integers(1, 101, size=n)
        for j in np.flatnonzero(near & (np.arange(n) >= back)):
            page[j] = page[j - back[j]]
        reps.append((page.astype(np.int32), rng.integers(0, 2, size=n).astype(np.int8),
                     rng.random(n) * rng.choice([1e-9, 5e-8], size=n), rng.random(n) * 3e-7,
                     n_pages, rng.random(2) * 1e-6))
        windows.append(w)
    sizes = [r[0].size for r in reps]
    return (torch.from_numpy(np.concatenate([r[0] for r in reps])).to(dev),
            torch.from_numpy(np.concatenate([r[1] for r in reps])).to(dev),
            torch.from_numpy(np.concatenate([r[2] for r in reps])).to(dev),
            torch.from_numpy(np.concatenate([r[3] for r in reps])).to(dev),
            torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int64, device=dev),
            torch.tensor(windows, dtype=torch.int64, device=dev),
            torch.tensor(np.array([r[5] for r in reps]), dtype=torch.float64, device=dev),
            torch.tensor([r[4] for r in reps], dtype=torch.int64, device=dev))


def test_timing_prepass_matches_plain(cuda):
    """The pre-pass on the card (writer index, window prefix sums) equals
    its plain version bit for bit, on the engine's streams and the
    adversarial ones."""
    from repro_torch.kernels.timing_replay import replay_prepass

    for args in (_launch_args(_streams(cuda), cuda), _adversarial(cuda)):
        page, tier, occ, lat, ev_off, w_slots, chan, n_pages = args
        got = replay_prepass(page, tier, occ, ev_off, w_slots, n_pages)
        want = replay_prepass(*[x.cpu() for x in (page, tier, occ, ev_off, w_slots, n_pages)])
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


def test_timing_replay_adversarial_windows(cuda):
    """Windows of every width class and writers at every distance from 1 to
    100 events: the kernel equals the plain version bit for bit, repeats
    bit for bit, and the empty replay ends at its preload."""
    from repro_torch.kernels.timing_replay import replay_prepass, timing_replay

    args = _adversarial(cuda, seed=1)
    page, tier, occ, lat, ev_off, w_slots, chan, n_pages = args
    writer = replay_prepass(page, tier, occ, ev_off, w_slots, n_pages)[0].cpu()
    back = torch.arange(writer.numel()) - writer
    # writers in the event's chunk of 32 or the one before (near), and
    # more than three chunks back (beyond the walker's prefetch distance)
    assert ((writer >= 0) & (back <= 32)).any() and ((writer >= 0) & (back > 96)).any()
    got = timing_replay(*args)
    want = timing_replay(*[x.cpu() for x in args])
    assert got.cpu().tolist() == want.tolist()
    assert got[-1].item() == chan[-1].max().item()
    for _ in range(3):
        assert torch.equal(timing_replay(*args), got)


def test_chain_latency_is_measured(cuda):
    """The chain's links, among them the walker's one-event window (two
    dependent float64 adds and a max) and a shuffle step."""
    from repro_torch.kernels.timing_replay import chain_latency_ns

    for n in (4_096, 3_250_585):
        links = chain_latency_ns(n, cuda)
        assert set(links) == {"load_ns", "f64_add_ns", "window_chain_ns", "shfl_step_ns"}
        assert 0.0 < links["f64_add_ns"] < links["load_ns"] < 1e5
        assert 2 * links["f64_add_ns"] < links["window_chain_ns"] < 1e3
        assert 0.0 < links["shfl_step_ns"] < 1e3
    assert links["window_chain_ns"] < links["load_ns"]  # the load left the chain


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


# ------------------------------------------------------------ backward kernels
# Each backward kernel against autograd of its plain version on the same
# inputs, per gradient by the largest difference relative to the largest
# gradient: 1e-4 in float32 (other summation orders), 1e-2 in bfloat16 (the
# kernels compute in float32 and round once; the plain version's gradients
# round at other points, each a few 2^-8 ulps of the gradient's scale).
def _close(got, want, tol, name):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    scale = float(want.float().abs().max())
    diff = float((got.float() - want.float()).abs().max())
    assert diff <= tol * max(scale, 1e-30), f"{name}: max |diff| {diff}, scale {scale}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal", [
    (1, 1000, 1000, 16, 8, 128, True),
    (1, 2047, 2047, 16, 8, 128, True),
    (2, 100, 100, 16, 8, 128, True),  # GQA 2, Qwen3's head layout, ragged tail
    (1, 128, 128, 8, 2, 64, True),  # GQA 4
    (1, 64, 192, 8, 2, 128, False),
    (1, 33, 65, 2, 1, 64, True),  # T > S
    (2, 48, 20, 4, 2, 16, True),  # S > T: the first rows see no key
    (1, 40, 40, 4, 4, 32, False),  # GQA 1
    (1, 300, 300, 16, 2, 128, True),  # GQA 8
    (1, 77, 77, 16, 2, 16, True),  # GQA 8 at hd 16, ragged tiles
    (1, 130, 200, 4, 2, 32, True),  # hd 32, T > S, neither a multiple of a tile
    (1, 150, 90, 4, 1, 32, True),  # hd 32, S > T, neither a multiple of a tile
    (1, 1500, 1500, 12, 12, 64, False),  # Whisper-small's encoder
    (1, 448, 1500, 12, 12, 64, False),  # its cross-attention over the 448-token context
    (1, 2304, 2304, 14, 2, 64, True),  # InternVL2-1B: GQA 7, 256 patches + 2,048 tokens
    (1, 512, 512, 16, 8, 64, True),  # Granite-MoE-1B
    (1, 512, 512, 32, 2, 128, True),  # ChatGLM3-6B: GQA 16
    (1, 512, 512, 64, 8, 128, True),  # Qwen2-72B and Jamba-1.5-Large
])
def test_flash_attention_bwd_matches_plain(cuda, dtype, B, S, T, H, KV, hd, causal):
    from repro_torch.kernels.flash_attention import (
        FlashAttention, flash_attention_bwd, flash_attention_bwd_plain)

    g = torch.Generator().manual_seed(S * T + hd + 1)
    q, k, v = (torch.randn(shape, generator=g).to(dtype).to(cuda).requires_grad_(True)
               for shape in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)))
    do = torch.randn((B, S, H, hd), generator=g).to(dtype).to(cuda)
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(q, k, v, causal=causal)
    assert out.grad_fn is not None and out.grad_fn.name().startswith(FlashAttention.__name__)
    out.backward(do)
    torch.cuda.synchronize()
    assert (flash_attention.launches - fwd, flash_attention_bwd.launches - bwd) == (1, 1)
    want = flash_attention_bwd_plain(q, k, v, do, causal=causal)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for name, a, b in zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad), want):
        _close(a, b, tol, name)
    if causal and S > T:
        assert not bool(q.grad[:, : S - T].any())


@pytest.mark.parametrize("dtype,ran,not_ran", [
    (torch.float32, "_fma_kernel", "_mma_kernel"),
    (torch.bfloat16, "_mma_kernel", "_fma_kernel"),
])
def test_flash_attention_bwd_dispatches_by_dtype(cuda, dtype, ran, not_ran):
    """float32 runs the FMA kernels, bfloat16 the tensor-core kernels: one
    pair of kernels a dtype, both launched, no other."""
    from repro_torch.kernels.flash_attention import (
        _launch, flash_attention_bwd, flash_bwd_kernel_launches)

    g = torch.Generator().manual_seed(8)
    q = torch.randn((1, 100, 4, 64), generator=g).to(dtype).to(cuda)
    k, v = (torch.randn((1, 100, 2, 64), generator=g).to(dtype).to(cuda) for _ in range(2))
    out, lse = _launch(q, k, v, True, with_lse=True)
    before = flash_bwd_kernel_launches()
    flash_attention_bwd(q, k, v, out, lse, q)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in flash_bwd_kernel_launches().items()}
    for kernel in ("flash_bwd_dq", "flash_bwd_dkdv"):
        assert launched[kernel + ran] == 1, launched
        assert launched[kernel + not_ran] == 0, launched


def test_flash_attention_bwd_repeats_bit_identical(cuda):
    from repro_torch.kernels.flash_attention import _launch, flash_attention_bwd

    g = torch.Generator().manual_seed(5)
    q = torch.randn((2, 2048, 16, 128), generator=g).to(torch.bfloat16).to(cuda)
    k, v = (torch.randn((2, 2048, 8, 128), generator=g).to(torch.bfloat16).to(cuda)
            for _ in range(2))
    do = torch.randn_like(q.float()).to(torch.bfloat16)
    out, lse = _launch(q, k, v, True, with_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, do)
    for _ in range(10):
        again = flash_attention_bwd(q, k, v, out, lse, do)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd,strong", [
    (2, 45, 3, 16, True), (2, 45, 3, 32, False), (2, 45, 3, 64, True),
    (1, 19, 2, 128, True), (1, 1, 40, 64, False), (1, 33, 40, 64, False),
    (1, 2048, 4, 64, False),
    (1, 33, 5, 128, True),  # 5 heads: not a multiple of the 8-block cluster
])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_bwd_matches_plain(cuda, dtype, B, S, H, hd, strong, with_state):
    from repro_torch.kernels.wkv6 import WKV6, wkv6_bwd, wkv6_bwd_plain

    inputs = [t.requires_grad_(True) for t in _wkv6_inputs(cuda, dtype, B, S, H, hd, strong)]
    g = torch.Generator().manual_seed(S + hd)
    do = torch.randn((B, S, H, hd), generator=g).to(dtype).to(cuda)
    ds = torch.randn((B, H, hd, hd), generator=g).to(cuda) if with_state else None
    fwd, bwd = wkv6.launches, wkv6_bwd.launches
    o, state = wkv6(*inputs)
    assert o.grad_fn is not None and o.grad_fn.name().startswith(WKV6.__name__)
    torch.autograd.backward([o, state] if with_state else [o],
                            [do, ds] if with_state else [do])
    torch.cuda.synchronize()
    assert (wkv6.launches - fwd, wkv6_bwd.launches - bwd) == (1, 1)
    want = wkv6_bwd_plain(*inputs, do, ds)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for name, t, b in zip(("dr", "dk", "dv", "dw", "du"), inputs, want):
        _close(t.grad, b, tol, name)


def test_wkv6_bwd_repeats_bit_identical(cuda):
    from repro_torch.kernels.wkv6 import wkv6_bwd

    args = _wkv6_inputs(cuda, torch.bfloat16, 2, 300, 40, 64, strong=True)
    do = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(6)).to(
        torch.bfloat16).to(cuda)
    ds = torch.randn((2, 40, 64, 64), generator=torch.Generator().manual_seed(7)).to(cuda)
    first = wkv6_bwd(*args, do, ds)
    for _ in range(10):
        again = wkv6_bwd(*args, do, ds)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


# ------------------------------------------------ the MoE, MLA and dense archs
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,hd", [(16, 16, 128), (16, 8, 64), (32, 2, 128), (64, 8, 128)])
def test_flash_attention_at_the_new_archs_heads(cuda, dtype, H, KV, hd):
    """DeepSeekMoE-16B, Granite-MoE-1B, ChatGLM3-6B and Qwen2-72B's (query
    heads, KV heads, head size), causal over a ragged 300 tokens."""
    g = torch.Generator().manual_seed(H * KV + hd)
    q = torch.randn((2, 300, H, hd), generator=g).to(dtype).to(cuda)
    k = torch.randn((2, 300, KV, hd), generator=g).to(dtype).to(cuda)
    v = torch.randn((2, 300, KV, hd), generator=g).to(dtype).to(cuda)
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q, k, v, causal=True)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal", [
    (4, 1, 1500, 12, 12, 64, False),  # Whisper-small's decode cross-attention
    (4, 1500, 1500, 12, 12, 64, False),  # its encoder: 1,500 = 23 x 64 + 28
    (4, 416, 1500, 12, 12, 64, False),  # its prefill cross-attention
    (2, 2304, 2304, 14, 2, 64, True),  # InternVL2-1B: GQA ratio 7 over 256 + 2,048
])
def test_flash_attention_at_whisper_and_internvl2_layouts(cuda, dtype, B, S, T, H, KV, hd,
                                                           causal):
    g = torch.Generator().manual_seed(S + T + H)
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


@pytest.mark.parametrize("case", ["normal", "small_integers", "zero"])
def test_moe_routing_on_the_card_equals_the_cpu(cuda, case):
    """moe_route at DeepSeekMoE-16B's E = 64, K = 6 over 8,192 tokens: the
    top-k experts, slots and kept mask equal on both devices; small
    integer logits tie in most rows, a zero router ties everywhere."""
    from repro_torch.models.layers import moe_route

    g = torch.Generator().manual_seed(41)
    N, E, K = 8192, 64, 6
    logits = {"normal": torch.randn((1, N, E), generator=g),
              "small_integers": torch.randint(0, 4, (1, N, E), generator=g).float(),
              "zero": torch.zeros((1, N, E))}[case]
    C = max(1, int(1.25 * N * K / E))
    cpu = moe_route(logits, K, C)
    card = moe_route(logits.to(cuda), K, C)
    for name, a, b in zip(("picks", "pos", "keep"), cpu[2:], card[2:]):
        assert torch.equal(a, b.cpu()), name
    if case == "zero":
        assert bool((card[2] == torch.arange(K, device=cuda)).all())
        assert bool(card[4][0, :C].all()) and not bool(card[4][0, C:].any())


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "granite-moe-1b-a400m"])
def test_moe_layer_on_the_card_equals_the_cpu(cuda, name):
    """moe_apply in float32 at the arch's .scaled() size, over all tokens
    and per position: output and aux loss within 1e-4 of the CPU's (a pick
    routed otherwise would move its token's output by order 1)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = get_config(name).scaled(param_dtype="float32", compute_dtype="float32")
    p = L.moe_init(cfg, torch.Generator().manual_seed(42), "cpu")
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator().manual_seed(43))
    pc = {k: (v.to(cuda) if isinstance(v, torch.Tensor) else {n: w.to(cuda) for n, w in v.items()})
          for k, v in p.items()}
    for per_position in (False, True):
        got, aux = L.moe_apply(pc, x.to(cuda), cfg, per_position=per_position)
        want, aux_cpu = L.moe_apply(p, x, cfg, per_position=per_position)
        assert torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)
        assert torch.allclose(aux.cpu(), aux_cpu, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ Mamba and Jamba
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_on_the_card_in_chunks(cuda, dtype):
    """mamba_apply over a 1,000-token sequence at Jamba's d_state (16) and a
    narrower d_inner (2,048): chunks of 128 (the default; the last one
    ragged) against one chunk of the whole sequence on the card and against
    the CPU, within 1e-4 (float32) or 2e-2 (bfloat16) of the output's
    scale; the returned conv and SSM states too. The chunked run's peak
    memory above its inputs stays below one (B, S, d_inner, d_state)
    float32 array."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    dt = str(dtype).removeprefix("torch.")
    cfg = replace(get_config("jamba-1.5-large-398b"), d_model=1024, param_dtype=dt,
                  compute_dtype=dt)
    p = L.mamba_init(cfg, torch.Generator().manual_seed(44), "cpu")
    x = torch.randn((2, 1000, cfg.d_model), generator=torch.Generator().manual_seed(45)).to(dtype)
    pc = {k: v.to(cuda) for k, v in p.items()}
    xc = x.to(cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got, (conv, ssm) = L.mamba_apply(pc, xc, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    whole = 2 * 1000 * cfg.d_inner * cfg.mamba_d_state * 4
    assert peak < whole, (peak, whole)
    one, (conv1, ssm1) = L.mamba_apply(pc, xc, cfg, chunk=1000)
    cpu, (conv_cpu, ssm_cpu) = L.mamba_apply(p, x, cfg)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in ((got, one), (got, cpu), (conv, conv1), (conv, conv_cpu), (ssm, ssm1),
                 (ssm, ssm_cpu)):
        a, b = a.float().cpu(), b.float().cpu()
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= tol * scale


def _jamba_lane_cfg():
    """Jamba's lane: the (attn, mamba) pair of blocks with 4 experts on the
    Mamba block, at .scaled() width, float32."""
    from repro_torch.configs import get_config

    return get_config("jamba-1.5-large-398b").scaled(
        num_layers=2, block_pattern=("attn", "mamba"), param_dtype="float32",
        compute_dtype="float32")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def test_jamba_two_layer_lane_on_the_card_equals_the_cpu(cuda):
    """The forward, the one-forward fill and 4 decode steps of the
    two-layer Jamba lane on the card against the CPU, within 1e-4, the MoE
    routing (every pick, slot and kept mask) equal on both."""
    from repro_torch import models as pm
    from repro_torch.models import layers as L

    cfg = _jamba_lane_cfg()
    params = pm.init_model(cfg, generator=torch.Generator().manual_seed(46), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(47))
    out = {}
    route = L.moe_route
    for lane, dev in (("cpu", torch.device("cpu")), ("cuda", cuda)):
        seen = []

        def recording(logits, K, C):
            r = route(logits, K, C)
            seen.append(tuple(t.cpu() for t in r[2:]))
            return r

        p = _tree_to(params, dev)
        L.moe_route = recording
        try:
            logits, _ = pm.forward(p, cfg, toks.to(dev))
            st = pm.init_decode_state(cfg, 2, 48, device=dev)
            last, st = pm.prefill(p, cfg, toks.to(dev), st)
            steps = []
            for t in range(4):
                lg, st = pm.decode_step(p, cfg, st, toks[:, t:t + 1].to(dev), 40 + t)
                steps.append(lg.cpu())
        finally:
            L.moe_route = route
        out[lane] = (logits.cpu(), last.cpu(), steps, {k: v.cpu() for k, v in st.items()}, seen)
    (lc, pc, sc, stc, rc), (lg, pg, sg, stg, rg) = out["cpu"], out["cuda"]
    close = dict(rtol=1e-4, atol=1e-4)
    assert torch.allclose(lc, lg, **close) and torch.allclose(pc, pg, **close)
    assert all(torch.allclose(a, b, **close) for a, b in zip(sc, sg))
    assert all(torch.allclose(stc[k], stg[k], **close) for k in stc)
    assert len(rc) == len(rg) == 6
    assert all(torch.equal(x, y) for a, b in zip(rc, rg) for x, y in zip(a, b))
