"""The port's victim_partition, CPU path, == the JAX package's Pallas kernel
in interpreter mode == its jnp fallback == a per-row heap replay of the
demotion walk, exactly, over random fast-tier layouts and demands (the
shapes and strategy of the JAX lane's property test)."""

import heapq

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.demote_rank import _victim_partition_jnp, _victim_partition_pallas
from repro_torch.kernels.victim_partition import (
    victim_partition,
    victim_partition_plain,
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
