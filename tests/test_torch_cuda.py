"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided inside a
fixture, never at import). Run them on a machine with an H100:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Results must be exact (integer kernels).
"""

import numpy as np
import pytest
import torch

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
