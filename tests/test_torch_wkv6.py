"""The port's wkv6, CPU path, == the sequential ``ref.wkv6`` == the chunked
Pallas kernel in interpreter mode, at the JAX lane's shapes and tolerance
(``tests/test_kernels.py``: 3e-4), with S not a multiple of the chunk; and
with bfloat16 r, k, v beside float32 w and u, as the model passes them
(``ref`` at the bfloat16 lane's 2e-2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.rwkv6_chunk import wkv6_chunked
from repro_torch.kernels import ops
from repro_torch.kernels.wkv6 import (
    BLOCKS_PER_SM,
    BWD_COLS,
    BWD_ROWS,
    BWD_SLICE,
    COLUMNS_PER_LANE,
    MAX_THREADS,
    MIN_COLUMNS,
    ROW_GROUPS,
    wkv6,
    wkv6_bwd_cells,
    wkv6_bwd_grid,
    wkv6_grid,
)

RNG = np.random.default_rng(0)


def _case(B, S, H, hd, rng=RNG, decay_base=-1.0):
    r = rng.normal(size=(B, S, H, hd)) * 0.5
    k = rng.normal(size=(B, S, H, hd)) * 0.5
    v = rng.normal(size=(B, S, H, hd)) * 0.5
    w = np.exp(-np.exp(rng.normal(size=(B, S, H, hd)) * 0.5 + decay_base))
    u = rng.normal(size=(H, hd)) * 0.3
    return [a.astype(np.float32) for a in (r, k, v, w, u)]


def _port(r, k, v, w, u, dtype="float32"):
    rkv = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (r, k, v)]
    before = wkv6.launches
    o, s = wkv6(*rkv, torch.from_numpy(w), torch.from_numpy(u))
    assert wkv6.launches == before  # the CPU path launches nothing
    assert o.dtype == getattr(torch, dtype) and s.dtype == torch.float32
    return o.float().numpy(), s.numpy()


@pytest.mark.parametrize("B,S,H,hd,C",
                         [(2, 64, 2, 32, 16), (1, 100, 4, 64, 32), (2, 32, 2, 16, 32)])
def test_matches_ref_and_pallas(B, S, H, hd, C):
    args = _case(B, S, H, hd)
    o, s = _port(*args)
    ro, rs = ref.wkv6(*(jnp.asarray(a) for a in args))
    po, ps = wkv6_chunked(*(jnp.asarray(a) for a in args), chunk=C, interpret=True)
    for got, want in ((o, ro), (s, rs), (o, po), (s, ps)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("B,S,H,hd", [(2, 37, 3, 64), (1, 5, 2, 16)])
def test_bf16_rkv_with_f32_decay(B, S, H, hd):
    r, k, v, w, u = _case(B, S, H, hd, decay_base=-4.0)
    o, s = _port(r, k, v, w, u, "bfloat16")
    rkv = [jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)]
    ro, rs = ref.wkv6(*rkv, jnp.asarray(w), jnp.asarray(u))
    assert ro.dtype == jnp.bfloat16
    np.testing.assert_allclose(o, np.asarray(ro, np.float32), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(s, np.asarray(rs), rtol=3e-4, atol=3e-4)


def test_state_carries_the_whole_prompt():
    # the final state of a prompt, then one more token by the decode formula,
    # equals the output of the longer prompt at its last token
    r, k, v, w, u = _case(1, 12, 2, 16)
    o_all, _ = _port(r, k, v, w, u)
    _, s = _port(*(a[:, :11] for a in (r, k, v, w)), u)
    at = np.einsum("bhk,bhv->bhkv", k[:, 11], v[:, 11])
    last = np.einsum("bhk,bhkv->bhv", r[:, 11], s + u[None, :, :, None] * at)
    np.testing.assert_allclose(o_all[:, 11], last, rtol=3e-4, atol=3e-4)


def test_ops_wkv6_dispatches_to_the_kernel_wrapper():
    t = [torch.from_numpy(a) for a in _case(1, 8, 2, 16)]
    o1, s1 = ops.wkv6(*t)
    o2, s2 = wkv6(*t)
    assert torch.equal(o1, o2) and torch.equal(s1, s2)


def test_other_devices_are_refused():
    t = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        wkv6(t, t, t, t, torch.zeros((2, 16), device="meta"))


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_wkv6_grid_splits_columns_and_rows(hd):
    for heads in (1, 8, 160, 100_000):
        cols, slices = wkv6_grid(hd, heads, 132)
        assert cols * slices == hd and cols >= MIN_COLUMNS
        # a column pair's row groups are consecutive lanes of one warp, and a
        # block is whole warps of at most MAX_THREADS threads
        assert 32 % ROW_GROUPS == 0 and hd % ROW_GROUPS == 0
        threads = cols // COLUMNS_PER_LANE * ROW_GROUPS
        assert threads % 32 == 0 and threads <= MAX_THREADS
        # slices are added only while the grid is short of blocks
        if slices > max(1, hd // COLUMNS_PER_LANE * ROW_GROUPS // MAX_THREADS):
            assert heads * slices // 2 < BLOCKS_PER_SM * 132
    # small grids (the card tests' shapes) split every head size's columns
    assert wkv6_grid(hd, 8, 132)[1] > 1
    if hd == 64:  # RWKV6-3B's prefill: 4 x 40 heads, 320 blocks of 4 warps
        assert wkv6_grid(64, 160, 132) == (32, 2)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_wkv6_bwd_cluster_covers_each_state_element_once(hd):
    # head counts around the card's 132 SMs, and RWKV6-3B's 4 x 40
    for heads in (1, 3, 131, 132, 133, 160, 264):
        geo = wkv6_bwd_grid(hd, 4, heads)
        slices = geo["cluster"]
        assert slices * BWD_SLICE == hd and 1 <= slices <= 8  # a portable cluster
        assert geo["threads"] % 32 == 0 and geo["threads"] <= 1024
        assert geo["grid"] == (heads * slices, 4)
    for heads in (3, 133):  # neither a multiple of the cluster
        count = np.zeros((heads, hd, hd), np.int32)
        for bx in range(wkv6_bwd_grid(hd, 1, heads)["grid"][0]):
            cells = wkv6_bwd_cells(hd, bx)
            assert len(cells) == wkv6_bwd_grid(hd, 1, heads)["threads"]
            for head, rows, cols in cells.values():
                assert head == bx // (hd // BWD_SLICE)  # a cluster is one head's blocks
                for row in rows:
                    count[head, row, list(cols)] += 1
        assert (count == 1).all()
    # a row group's threads are consecutive lanes of one warp (its sums are
    # shuffles), holding adjacent columns; each warp holds 8 row groups (dv's
    # sum over them is a shuffle too)
    pairs = {}
    for tid, (_, rows, cols) in wkv6_bwd_cells(hd, 0).items():
        pairs.setdefault(rows, []).append((tid, cols))
    assert len(pairs) == hd // BWD_ROWS[hd] and len(pairs) % 8 == 0
    for rows, held in pairs.items():
        assert len(rows) == BWD_ROWS[hd]
        tids = [t for t, _ in held]
        assert tids == list(range(tids[0], tids[0] + BWD_SLICE // BWD_COLS))
        assert tids[0] // 32 == tids[-1] // 32
        assert all(list(c) == list(range(c[0], c[0] + BWD_COLS)) for _, c in held)


# --------------------------------------------------------------- gradients
# The JAX package trains through ``ref.wkv6`` (its Pallas kernel has no
# gradient), so autograd of the port's CPU path is held against jax.grad of
# ref.wkv6 in float32, with and without a gradient of the final state, at
# strong decays (many w under 1e-3) too, at 1e-4 relative to the largest
# gradient of each input (other summation orders; they differ by ~1e-6 of it).
def _jax_grads(r, k, v, w, u, do, dstate):
    import jax

    def f(r, k, v, w, u):
        o, s = ref.wkv6(r, k, v, w, u)
        out = jnp.sum(o * do)
        return out + jnp.sum(s * dstate) if dstate is not None else out

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (r, k, v, w, u)))]


@pytest.mark.parametrize("B,S,H,hd,decay_base", [(2, 37, 3, 16, -1.0), (1, 50, 2, 32, 2.0),
                                                  (1, 20, 2, 64, -4.0)])
@pytest.mark.parametrize("with_state", [False, True])
def test_gradients_match_jax_grad_of_ref(B, S, H, hd, decay_base, with_state):
    from repro_torch.kernels.wkv6 import wkv6_bwd

    args = _case(B, S, H, hd, decay_base=decay_base)
    do = RNG.normal(size=args[0].shape).astype(np.float32)
    dstate = RNG.normal(size=(B, H, hd, hd)).astype(np.float32) if with_state else None
    before = wkv6_bwd.launches
    got = wkv6_bwd(*(torch.from_numpy(a) for a in args), torch.from_numpy(do),
                   None if dstate is None else torch.from_numpy(dstate))
    assert wkv6_bwd.launches == before
    for name, g, want in zip("rkvwu", got, _jax_grads(*args, do, dstate)):
        assert g.shape == want.shape, name
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=name)


def test_gradient_through_ops_wkv6_is_autograd_of_the_plain_version():
    from repro_torch.kernels.wkv6 import wkv6_bwd_plain

    args = [torch.from_numpy(a) for a in _case(1, 9, 2, 16)]
    do = torch.from_numpy(RNG.normal(size=args[0].shape).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in args]
    o, _ = ops.wkv6(*leaves)
    o.backward(do)
    for a, b in zip((t.grad for t in leaves), wkv6_bwd_plain(*args, do)):
        assert torch.equal(a, b)
