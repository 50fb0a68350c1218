"""The port's strided_probe, CPU path, == ``ref.strided_probe`` == the
Pallas kernel in interpreter mode at the JAX lane's cases
(``tests/test_kernels.py``, rtol = atol = 1e-5), and == ``ref`` where the
Pallas kernel is undefined (an empty index list)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.strided_probe import strided_probe as pallas_probe
from repro_torch.kernels.strided_probe import (
    segments,
    strided_probe,
    strided_probe_plain,
)

RNG = np.random.default_rng(0)
FP = RNG.normal(size=(10, 128)).astype(np.float32)
SP = RNG.normal(size=(12, 128)).astype(np.float32)


def _port(fp, sp, fi, si, ai):
    before = strided_probe.launches
    out = strided_probe(torch.from_numpy(fp), torch.from_numpy(sp),
                        np.asarray(fi), np.asarray(si), ai)
    assert strided_probe.launches == before  # the CPU path launches nothing
    assert out.shape == (1, fp.shape[1]) and out.dtype == torch.float32
    return out.numpy()


def _ref(fp, sp, fi, si, ai):
    return np.asarray(ref.strided_probe(
        jnp.asarray(fp), jnp.asarray(sp), jnp.asarray(fi, jnp.int32),
        jnp.asarray(si, jnp.int32), ai))


@pytest.mark.parametrize("ai_iters", [0, 1, 7, 32])
def test_matches_ref_and_pallas(ai_iters):
    fi, si = [0, 3, 5, 9], [1, 2, 11]
    got = _port(FP, SP, fi, si, ai_iters)
    pallas = np.asarray(pallas_probe(
        jnp.asarray(FP), jnp.asarray(SP), jnp.asarray(fi, jnp.int32),
        jnp.asarray(si, jnp.int32), ai_iters, interpret=True))
    np.testing.assert_allclose(got, _ref(FP, SP, fi, si, ai_iters), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fi,si", [([], [1, 2, 11]), ([0, 3], []), ([], [])])
def test_empty_index_lists_follow_ref(fi, si):
    for ai in (1, 5):
        np.testing.assert_allclose(_port(FP, SP, fi, si, ai),
                                   _ref(FP, SP, fi, si, ai), rtol=1e-5, atol=1e-5)
    assert not np.any(_port(FP, SP, [], [], 3))


def test_ai_knob_changes_flops_not_reads():
    ones = np.ones((4, 64), np.float32)
    o1 = _port(ones, ones, [0, 1], [2], 1)
    o8 = _port(ones, ones, [0, 1], [2], 8)
    assert not np.allclose(o1, o8)
    # three pages of ones: sum over pages of sum_{j<8} 1.000001**j
    np.testing.assert_allclose(o8, 3 * sum(1.000001 ** j for j in range(8)),
                               rtol=1e-6)


def test_float64_plain_version_and_segments():
    got = strided_probe_plain(torch.from_numpy(FP), torch.from_numpy(SP),
                              torch.tensor([0, 3]), torch.tensor([1]), 7,
                              dtype=torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _ref(FP, SP, [0, 3], [1], 7),
                               rtol=1e-5, atol=1e-5)
    # 2**18 pages of 1,024 floats on 132 SMs: 4 column blocks, ~528 segments
    per = segments(262_144, 1024, 132)
    assert -(-262_144 // per) <= 528 and per >= 32
    assert segments(10, 1024, 132) == 10  # too few pages to split
