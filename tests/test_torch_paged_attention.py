"""The port's paged_decode_attention, CPU path, == ``ref.paged_decode_attention``
== the Pallas kernel in interpreter mode at the JAX lane's shapes
(``tests/test_kernels.py``, rtol = atol = 2e-4, sequences with at least one
valid token), page-permutation invariance, strided pool views, and the fully
masked row against ``ref`` (zeros; the Pallas kernel differs there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.paged_attention import paged_decode_attention as pallas_paged
from repro_torch.kernels.paged_attention import paged_decode_attention

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
