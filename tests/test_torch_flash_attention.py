"""The port's flash_attention, CPU path, == ``ref.attention`` == the Pallas
kernel in interpreter mode, at the JAX lane's shapes and tolerances
(``tests/test_kernels.py``: 2e-4 in float32, 2e-2 in bfloat16), plus
grouped heads, ragged lengths that are not a multiple of the card's 64-row
tiles, ``T > S`` (right-aligned causal queries) and the rows that see no
key (``S > T``), where the port gives zeros and ``ref`` NaN."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention

RNG = np.random.default_rng(0)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-4, atol=2e-4)


def _case(B, S, T, H, KV, hd, rng=RNG):
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, T, KV, hd)).astype(np.float32),
            rng.normal(size=(B, T, KV, hd)).astype(np.float32))


def _port(q, k, v, causal, dtype):
    before = flash_attention.launches
    out = flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                            for a in (q, k, v)), causal=causal)
    assert flash_attention.launches == before  # the CPU path launches nothing
    assert out.dtype == getattr(torch, dtype)
    return out.float().numpy()


def _ref(q, k, v, causal, dtype):
    return np.asarray(ref.attention(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                                    causal=causal), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,T,H,KV,hd,causal",
    [
        (1, 128, 128, 4, 2, 64, True),
        (2, 96, 96, 4, 4, 64, True),
        (1, 64, 192, 8, 2, 128, False),
        (1, 33, 65, 2, 1, 64, True),  # ragged, T > S
    ],
)
def test_matches_ref_and_pallas(B, S, T, H, KV, hd, causal, dtype):
    q, k, v = _case(B, S, T, H, KV, hd)
    got = _port(q, k, v, causal, dtype)
    pallas = pallas_flash(*(jnp.asarray(a, dtype) for a in (q, k, v)), causal=causal,
                          block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(got, _ref(q, k, v, causal, dtype), **_tol(dtype))
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), **_tol(dtype))


@pytest.mark.parametrize("B,S,T,H,KV,hd", [(2, 100, 100, 8, 2, 16), (1, 70, 131, 4, 1, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_tiles_and_grouped_heads(B, S, T, H, KV, hd, causal):
    q, k, v = _case(B, S, T, H, KV, hd)
    np.testing.assert_allclose(_port(q, k, v, causal, "float32"),
                               _ref(q, k, v, causal, "float32"), rtol=2e-4, atol=2e-4)


def test_rows_that_see_no_key_give_zeros():
    # causal with S > T: query s sits at key position s - (S - T), so the
    # first S - T rows see no key
    S, T = 48, 20
    q, k, v = _case(1, S, T, 4, 2, 64)
    got = _port(q, k, v, True, "float32")
    want = _ref(q, k, v, True, "float32")
    assert np.isnan(want[:, : S - T]).all()  # the reference's softmax over all -inf
    assert not got[:, : S - T].any()
    np.testing.assert_allclose(got[:, S - T:], want[:, S - T:], rtol=2e-4, atol=2e-4)
    pallas = np.asarray(pallas_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                                     block_q=16, block_k=16, interpret=True))
    np.testing.assert_allclose(got[:, S - T:], pallas[:, S - T:], rtol=2e-4, atol=2e-4)


def test_ops_attention_dispatches_to_flash():
    q, k, v = _case(1, 16, 16, 4, 2, 16)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    assert torch.equal(ops.attention(*t, causal=True), flash_attention(*t, causal=True))


def test_decode_attention_matches_ref():
    q = RNG.normal(size=(2, 1, 8, 32)).astype(np.float32)
    kc = RNG.normal(size=(2, 24, 2, 32)).astype(np.float32)
    vc = RNG.normal(size=(2, 24, 2, 32)).astype(np.float32)
    got = ops.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc)), 11)
    want = ref.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc)), 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_other_devices_are_refused():
    t = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(t, t, t)
