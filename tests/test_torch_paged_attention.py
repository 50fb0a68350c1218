"""The port's paged_decode_attention, CPU path, == ``ref.paged_decode_attention``
== the Pallas kernel in interpreter mode at the JAX lane's shapes
(``tests/test_kernels.py``, rtol = atol = 2e-4, sequences with at least one
valid token), page-permutation invariance, strided pool views, and the fully
masked row against ``ref`` (zeros; the Pallas kernel differs there). The
card kernel's split-and-merge, in its plain version, against the same two
at 2e-4 (split boundaries, holes on them, splits and sequences with no
valid token), and the wrapper's split planner. The kernel's contiguous
mode (a model's decode cache read in place, with no page table): the plain
split-and-merge over the cache viewed as pages, in order, equals the plain
``ops.decode_attention`` at several lengths and strides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.paged_attention import paged_decode_attention as pallas_paged
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_split_plain,
    pages_per_split,
)

RNG = np.random.default_rng(0)


def _case(B, H, KV, hd, P, psize, ppseq, rng=RNG):
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kp = rng.normal(size=(P, psize, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(P, psize, KV, hd)).astype(np.float32)
    tbl = np.full((B, ppseq), -1, np.int32)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(1, ppseq + 1))
        tbl[b, :n] = rng.choice(P, size=n, replace=False)
        lens[b] = rng.integers((n - 1) * psize + 1, n * psize + 1)
    return q, kp, vp, tbl, lens


def _port(q, kp, vp, tbl, lens):
    before = paged_decode_attention.launches
    out = paged_decode_attention(*(torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)))
    assert paged_decode_attention.launches == before
    return out.numpy()


def _ref(q, kp, vp, tbl, lens):
    return np.asarray(ref.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, tbl, lens))))


@pytest.mark.parametrize(
    "B,H,KV,hd,P,psize,ppseq",
    [(2, 8, 4, 64, 16, 16, 4), (3, 4, 4, 128, 8, 32, 2), (1, 16, 2, 64, 32, 8, 8)],
)
def test_matches_ref_and_pallas(B, H, KV, hd, P, psize, ppseq):
    args = _case(B, H, KV, hd, P, psize, ppseq)
    got = _port(*args)
    pallas = np.asarray(pallas_paged(*(jnp.asarray(a) for a in args), interpret=True))
    np.testing.assert_allclose(got, _ref(*args), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)


def test_holes_and_lengths_past_the_table():
    args = list(_case(3, 8, 2, 64, 12, 8, 4))
    args[3][0, 1] = -1  # a hole inside the valid range
    args[4][2] = 4 * 8 + 5  # longer than the table covers
    np.testing.assert_allclose(_port(*args), _ref(*args), rtol=2e-4, atol=2e-4)


def test_page_permutation_invariance():
    B, H, KV, hd, P, psize = 2, 4, 4, 64, 12, 16
    q = RNG.normal(size=(B, H, hd)).astype(np.float32)
    kp = RNG.normal(size=(P, psize, KV, hd)).astype(np.float32)
    vp = RNG.normal(size=(P, psize, KV, hd)).astype(np.float32)
    tbl = np.array([[0, 1, 2], [3, 4, -1]], np.int32)
    lens = np.array([40, 20], np.int32)
    o1 = _port(q, kp, vp, tbl, lens)
    perm = RNG.permutation(P)
    inv = np.argsort(perm)
    tbl2 = np.where(tbl >= 0, perm[np.maximum(tbl, 0)], -1).astype(np.int32)
    o2 = _port(q, kp[inv].copy(), vp[inv].copy(), tbl2, lens)
    np.testing.assert_allclose(o1, o2, rtol=1e-5, atol=1e-5)


def test_fully_masked_row_gives_zeros_as_ref():
    args = list(_case(3, 4, 2, 64, 8, 16, 2))
    args[4][1] = 0  # no valid token
    args[3][2, :] = -1  # only holes
    got = _port(*args)
    np.testing.assert_allclose(got, _ref(*args), rtol=2e-4, atol=2e-4)
    assert not np.any(got[1]) and not np.any(got[2])


def test_strided_view_of_a_serving_pool():
    # layer group 1 of a pool whose pages hold [groups, K/V, tokens, KV, hd],
    # read through the view without a copy
    g = torch.Generator().manual_seed(5)
    pool = torch.randn((6, 3 * 2 * 8 * 2 * 32), generator=g).to(torch.bfloat16)
    view = pool.view(6, 3, 2, 8, 2, 32)
    k, v = view[:, 1, 0], view[:, 1, 1]
    q = torch.randn((2, 4, 32), generator=g).to(torch.bfloat16)
    tbl = torch.tensor([[5, 0, -1], [2, 3, 1]], dtype=torch.int32)
    lens = torch.tensor([12, 20], dtype=torch.int32)
    got = paged_decode_attention(q, k, v, tbl, lens)
    want = paged_decode_attention(q, k.contiguous(), v.contiguous(), tbl, lens)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def _split(args, pps):
    return paged_decode_attention_split_plain(
        *(torch.from_numpy(a) for a in args), pages_per_split=pps).numpy()


@pytest.mark.parametrize("pps", [1, 2, 3, "ppseq"])
@pytest.mark.parametrize(
    "B,H,KV,hd,P,psize,ppseq",
    [(2, 8, 4, 64, 16, 16, 4), (1, 16, 2, 64, 32, 8, 8), (3, 4, 2, 32, 40, 4, 7)],
)
def test_split_plain_matches_ref_and_pallas(B, H, KV, hd, P, psize, ppseq, pps):
    args = _case(B, H, KV, hd, P, psize, ppseq, rng=np.random.default_rng(ppseq))
    got = _split(args, ppseq if pps == "ppseq" else pps)
    pallas = np.asarray(pallas_paged(*(jnp.asarray(a) for a in args), interpret=True))
    np.testing.assert_allclose(got, _ref(*args), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("pps", [1, 2, 3])
def test_split_plain_hole_on_a_split_boundary(pps):
    args = list(_case(3, 8, 2, 64, 24, 8, 6, rng=np.random.default_rng(3)))
    args[3][0, 2] = -1  # first page of a split for pps in {1, 2}, last for 3
    args[3][1, 3] = -1
    args[4][:] = [48, 30, 45]
    want = _ref(*args)
    np.testing.assert_allclose(_split(args, pps), want, rtol=2e-4, atol=2e-4)
    pallas = np.asarray(pallas_paged(*(jnp.asarray(a) for a in args), interpret=True))
    np.testing.assert_allclose(_split(args, pps), pallas, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("pps", [1, 2])
def test_split_plain_split_with_no_valid_token(pps):
    # sequence 0: its first split is all holes; sequence 1: its length ends
    # before its last splits begin
    args = list(_case(2, 4, 2, 64, 16, 8, 6, rng=np.random.default_rng(4)))
    args[3][0, :2] = -1
    args[4][:] = [40, 9]
    got = _split(args, pps)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _ref(*args), rtol=2e-4, atol=2e-4)
    pallas = np.asarray(pallas_paged(*(jnp.asarray(a) for a in args), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("pps", [1, 3])
def test_split_plain_sequence_of_length_zero(pps):
    args = list(_case(3, 4, 2, 64, 16, 16, 3, rng=np.random.default_rng(5)))
    args[4][1] = 0
    got = _split(args, pps)
    assert np.isfinite(got).all() and not got[1].any()
    np.testing.assert_allclose(got, _ref(*args), rtol=2e-4, atol=2e-4)
    # the Pallas kernel gives the mean of a masked page there: rows 0 and 2
    pallas = np.asarray(pallas_paged(*(jnp.asarray(a) for a in args), interpret=True))
    np.testing.assert_allclose(got[[0, 2]], pallas[[0, 2]], rtol=2e-4, atol=2e-4)


def test_split_plain_matches_the_plain_version_in_bfloat16():
    args = _case(4, 16, 8, 128, 64, 16, 9, rng=np.random.default_rng(6))
    t = [torch.from_numpy(a) for a in args]
    t[0], t[1], t[2] = (x.to(torch.bfloat16) for x in t[:3])
    want = paged_decode_attention(*t)
    for pps in (1, 2, 5):
        got = paged_decode_attention_split_plain(*t, pages_per_split=pps)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("ppseq", [0, 1, 9, 22, 257])
@pytest.mark.parametrize("batch,kv_heads", [(1, 1), (12, 8), (16, 8), (200, 8)])
@pytest.mark.parametrize("blocks_per_sm", [1, 1000])
def test_split_planner_covers_every_page_once(ppseq, batch, kv_heads, blocks_per_sm):
    sm, slots = 132, blocks_per_sm * 132
    for min_pages in (1, 4, 64):
        pps = pages_per_split(ppseq, batch, kv_heads, sm, blocks_per_sm, min_pages)
        assert 1 <= pps <= max(ppseq, 1)
        n_splits = -(-ppseq // pps) if ppseq else 1
        covered = [p for s in range(n_splits)
                   for p in range(s * pps, min((s + 1) * pps, ppseq))]
        assert covered == list(range(ppseq))  # every page once, in table order
        grid = batch * kv_heads * n_splits
        fit = max(1, slots // (batch * kv_heads))
        # runs of min_pages, or as short as filling the card once takes
        assert pps >= min(min_pages, -(-max(ppseq, 1) // fit))
        # a grid beyond what the card holds at once only with long runs
        assert grid <= max(slots, batch * kv_heads) or pps >= min_pages


def test_split_planner_at_the_serving_shape():
    # 16 sequences over 8 KV heads, 4 blocks an SM on 132 SMs: 4 runs a
    # (sequence, head) fill the card. 9 or 22 pages, runs of 128 wanted:
    # 4 runs of 3 or 6; 8,192 positions in pages of 16: 4 runs of 128; the
    # decode cell's 32,768 in tiles of 32, runs of 64: 16 (3.9 grids); one
    # block an SM, 1 run fills the card: the same 16
    assert pages_per_split(9, 16, 8, 132, 4, 128) == 3
    assert pages_per_split(22, 16, 8, 132, 4, 128) == 6
    assert pages_per_split(512, 16, 8, 132, 4, 128) == 128
    assert pages_per_split(1024, 16, 8, 132, 4, 64) == 64
    assert pages_per_split(1024, 16, 8, 132, 1, 64) == 64
    with pytest.raises(ValueError):
        paged_decode_attention_split_plain(*(torch.zeros(s) for s in (
            (1, 2, 16), (2, 4, 1, 16), (2, 4, 1, 16))),
            torch.zeros((1, 2), dtype=torch.int32), torch.ones(1), pages_per_split=0)


def _cache_layout(layout, B, S, KV, hd, g):
    """A decode cache (B, S, KV, hd) as the model's state holds it, or
    sliced out of a larger buffer, with its strides."""
    if layout == "contiguous":
        return torch.randn((B, S, KV, hd), generator=g)
    if layout == "state_group":  # state[...][g] of a (G, B, S, KV, hd) state
        return torch.randn((3, B, S, KV, hd), generator=g)[1]
    if layout == "longer_buffer":  # batch stride above S * token stride
        return torch.randn((B, S + 32, KV, hd), generator=g)[:, :S]
    return torch.randn((B, S, KV + 3, hd), generator=g)[:, :, 2:2 + KV]  # head slice


def _as_pages(cache, page_size):
    """(pages, table): ``cache`` (B, S, KV, hd) read as a pool of pages of
    ``page_size`` tokens with a table naming each sequence's pages in
    order, through the cache's own strides and no copy. With ``page_size``
    S, page b is sequence b at the batch stride: the kernel's contiguous
    mode, token t of sequence b at b * stride_b + t * stride_t."""
    B, S, KV, hd = cache.shape
    sb, st, sh, sd = cache.stride()
    page = sb if page_size == S else page_size * st  # the page stride
    assert S % page_size == 0 and sb % page == 0
    per_seq = sb // page
    n_pages = (B - 1) * per_seq + S // page_size
    pages = cache.as_strided((n_pages, page_size, KV, hd), (page, st, sh, sd),
                             cache.storage_offset())
    table = (torch.arange(B)[:, None] * per_seq
             + torch.arange(S // page_size)[None, :]).to(torch.int32)
    return pages, table


@pytest.mark.parametrize("layout", ["contiguous", "state_group", "longer_buffer",
                                    "head_slice"])
@pytest.mark.parametrize("valid_len", [1, 37, 64])
@pytest.mark.parametrize("page_size", [16, "sequence"])
def test_split_plain_over_a_cache_in_place_matches_decode_attention(layout, valid_len,
                                                                    page_size):
    # float32 both ways; the merge by log-sum-exp and the one softmax differ
    # only by float32 rounding, 1e-5 of values of order 1
    g = torch.Generator().manual_seed(valid_len)
    B, S, KV, rep, hd = 3, 64, 2, 2, 32
    kc, vc = (_cache_layout(layout, B, S, KV, hd, g) for _ in range(2))
    q = torch.randn((B, 1, KV * rep, hd), generator=g)
    ps = S if page_size == "sequence" else page_size
    (kp, table), (vp, _) = _as_pages(kc, ps), _as_pages(vc, ps)
    lens = torch.full((B,), valid_len, dtype=torch.int32)
    want = ops.decode_attention(q, kc, vc, valid_len)[:, 0]
    for pps in sorted({1, 2, table.shape[1]}):
        got = paged_decode_attention_split_plain(q[:, 0], kp, vp, table, lens, pps)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
