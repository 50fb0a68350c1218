"""The port's victim_partition, CPU path, == the JAX package's Pallas kernel
in interpreter mode == its jnp fallback == a per-row heap replay of the
demotion walk, exactly, over random fast-tier layouts and demands (the
shapes and strategy of the JAX lane's property test). The card kernel's
decomposition (tiles, exclusive tile counts, the early stop past the
demand), ``victim_partition_tiled_plain``, is held to the same three."""

import heapq

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.demote_rank import _victim_partition_jnp, _victim_partition_pallas
from repro_torch.kernels.victim_partition import (
    TILE,
    victim_partition,
    victim_partition_plain,
    victim_partition_tiled_plain,
)


def _heap_replay(fast, demand):
    want = np.zeros_like(fast)
    for row in range(fast.shape[0]):
        # pop the lowest rank positions among fast entries, demand times
        heap = list(np.flatnonzero(fast[row]))
        heapq.heapify(heap)
        for _ in range(int(demand[row])):
            if not heap:
                break
            want[row, heapq.heappop(heap)] = 1
    return want


@pytest.mark.parametrize("shape", [(1, 64), (3, 64), (2, 200)])
def test_plain_matches_pallas_jnp_and_heap_replay(shape):
    s, r = shape  # fixed shapes bound the per-example jit compiles

    @settings(max_examples=15, deadline=None)
    @given(
        seed=st.integers(0, 2**32 - 1),
        density=st.floats(0.0, 1.0),
        tight=st.booleans(),
    )
    def _property(seed, density, tight):
        rng = np.random.default_rng(seed)
        fast = (rng.random((s, r)) < density).astype(np.int32)
        # "tight" draws demand near the fast supply, where the <= boundary
        # of the running count lives; loose draws roam past it
        hi = fast.sum(axis=1) + 1 if tight else np.full(s, r + 2)
        demand = rng.integers(0, hi + 1).astype(np.int64)
        got = victim_partition(torch.from_numpy(fast), torch.from_numpy(demand))
        assert got.dtype == torch.int32
        got = got.numpy()
        pallas = np.asarray(
            _victim_partition_pallas(
                jnp.asarray(fast), jnp.asarray(demand), interpret=True
            )
        )
        fallback = np.asarray(
            _victim_partition_jnp(jnp.asarray(fast), jnp.asarray(demand))
        )
        assert np.array_equal(got, pallas)
        assert np.array_equal(got, fallback)
        assert np.array_equal(got, _heap_replay(fast, demand))

    _property()


@pytest.mark.parametrize("demand", [0, 1, 5, 10_000])
def test_edge_demands(demand):
    fast = np.array([[0, 1, 1, 0, 1, 1, 1, 0, 0, 1]], dtype=np.int32)
    d = np.array([demand], dtype=np.int64)
    got = victim_partition_plain(torch.from_numpy(fast), torch.from_numpy(d))
    assert np.array_equal(got.numpy(), _heap_replay(fast, d))


def test_cpu_wrapper_never_counts_a_launch():
    before = victim_partition.launches
    fast = torch.ones((2, 8), dtype=torch.int32)
    victim_partition(fast, torch.tensor([3, 9]))
    assert victim_partition.launches == before


def test_unsupported_device_raises():
    fast = torch.ones((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        victim_partition(fast, torch.tensor([1], device="meta"))


# 4,099 columns: a ragged last tile at every tile size below
_TILED_SHAPE = (4, 4099)


def _tiled_demand(fast, tile, kind, rng):
    cum = np.cumsum(fast, axis=1)
    supply = cum[:, -1]
    if kind == "tile_boundary":  # the count through the first tile(s)
        return np.array([cum[r, min(n * tile, fast.shape[1]) - 1]
                         for r, n in enumerate((1, 2, 3, 1))], dtype=np.int64)
    if kind == "first_tile":
        return np.array([max(1, int(cum[r, tile - 1]) // 2) if tile > 1 else 1
                         for r in range(fast.shape[0])], dtype=np.int64)
    if kind == "past_supply":
        return supply + np.array([1, 7, 1000, 0], dtype=np.int64)
    if kind == "zero_and_negative":
        return np.array([0, -1, -100, 0], dtype=np.int64)
    return rng.integers(0, supply + 2).astype(np.int64)


@pytest.mark.parametrize("tile", [1, 4, 7, 4096])
@pytest.mark.parametrize(
    "kind", ["tile_boundary", "first_tile", "past_supply", "zero_and_negative", "random"]
)
def test_tiled_plain_matches_plain_jnp_and_pallas(tile, kind):
    rng = np.random.default_rng(tile * 31 + len(kind))
    fast = (rng.random(_TILED_SHAPE) < 0.55).astype(np.int32)
    fast[3, -3:] = 1  # fast entries in the ragged last tile
    demand = _tiled_demand(fast, tile, kind, rng)
    f, d = torch.from_numpy(fast), torch.from_numpy(demand)
    got = victim_partition_tiled_plain(f, d, tile)
    assert got.dtype == torch.int32 and got.shape == f.shape
    assert torch.equal(got, victim_partition_plain(f, d))
    pallas = np.asarray(_victim_partition_pallas(
        jnp.asarray(fast), jnp.asarray(demand), interpret=True))
    assert np.array_equal(got.numpy(), pallas)
    assert np.array_equal(
        got.numpy(), np.asarray(_victim_partition_jnp(jnp.asarray(fast), jnp.asarray(demand))))
    assert np.array_equal(got.numpy(), _heap_replay(fast, demand))


@settings(max_examples=40, deadline=None)
@given(
    seed=st.integers(0, 2**32 - 1),
    rows=st.integers(1, 6),
    cols=st.integers(1, 300),
    tile=st.integers(1, 64),
    density=st.floats(0.0, 1.0),
)
def test_tiled_plain_property(seed, rows, cols, tile, density):
    rng = np.random.default_rng(seed)
    fast = (rng.random((rows, cols)) < density).astype(np.int32)
    demand = rng.integers(-2, fast.sum(axis=1) + 3).astype(np.int64)
    got = victim_partition_tiled_plain(torch.from_numpy(fast), torch.from_numpy(demand), tile)
    assert np.array_equal(got.numpy(), _heap_replay(fast, demand))


@pytest.mark.parametrize("cols", [1, 5, TILE - 1, TILE, TILE + 1, 3 * TILE - 2])
def test_tiled_plain_rows_of_one_to_three_card_tiles(cols):
    rng = np.random.default_rng(cols)
    fast = (rng.random((3, cols)) < 0.5).astype(np.int32)
    cum = np.cumsum(fast, axis=1)
    at_tile = cum[:, min(TILE, cols) - 1]  # demand on the first tile's end
    demand = np.array([at_tile[0], at_tile[1] + 1, cum[2, -1]], dtype=np.int64)
    f, d = torch.from_numpy(fast), torch.from_numpy(demand)
    assert torch.equal(victim_partition_tiled_plain(f, d), victim_partition_plain(f, d))


def test_tiled_plain_many_short_rows():
    # 1,000 rows of one short tile each, as one launch of the card kernel
    rng = np.random.default_rng(1000)
    fast = (rng.random((1000, 37)) < 0.5).astype(np.int32)
    demand = rng.integers(-2, 40, size=1000).astype(np.int64)
    f, d = torch.from_numpy(fast), torch.from_numpy(demand)
    assert torch.equal(victim_partition_tiled_plain(f, d), victim_partition_plain(f, d))
    assert np.array_equal(victim_partition_tiled_plain(f, d, 8).numpy(),
                          _heap_replay(fast, demand))


def test_tiled_plain_rejects_an_empty_tile():
    with pytest.raises(ValueError, match="tile"):
        victim_partition_tiled_plain(torch.ones((1, 4), dtype=torch.int32),
                                     torch.tensor([1]), 0)
