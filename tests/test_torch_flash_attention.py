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
from repro_torch.kernels.flash_attention import flash_attention, flash_bwd_walk

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,T,H,KV,hd,causal",
    [
        (4, 1, 150, 12, 12, 64, False),  # Whisper's decode cross-attention: one query
        (4, 150, 150, 12, 12, 64, False),  # its encoder: 150 = 2 x 64 + 22
        (4, 42, 150, 12, 12, 64, False),  # its prefill cross-attention
        (2, 230, 230, 14, 2, 64, True),  # InternVL2's 14 query heads over 2 KV heads
    ],
)
def test_whisper_and_internvl2_layouts(B, S, T, H, KV, hd, causal, dtype):
    """The layouts the encoder-decoder and VLM archs give the kernel, at
    small S and T (on the card: 1,500 frames, 416 prompt tokens, 2,304
    positions), against ``ref.attention`` and the Pallas kernel."""
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


# --------------------------------------------------------------- gradients
# The JAX package trains through ``ref.attention`` (its Pallas kernel has no
# gradient), so autograd of the port's CPU path is held against jax.grad of
# ref.attention in float32, at 1e-4 (the two frameworks sum in other orders;
# the gradients are O(1) and differ by about 1e-6). Rows that see no key are
# left out of ref's side: ref gives NaN there (tested separately below).
def _grads_ref(q, k, v, do, causal):
    import jax

    f = lambda q, k, v: jnp.sum(ref.attention(q, k, v, causal=causal) * do)  # noqa: E731
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))]


@pytest.mark.parametrize(
    "B,S,T,H,KV,hd,causal",
    [
        (1, 40, 40, 4, 4, 16, True),
        (2, 33, 65, 8, 2, 32, True),  # GQA 4, T > S, ragged
        (1, 24, 50, 4, 2, 64, False),
    ],
)
def test_gradients_match_jax_grad_of_ref(B, S, T, H, KV, hd, causal):
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    q, k, v = _case(B, S, T, H, KV, hd)
    do = RNG.normal(size=q.shape).astype(np.float32)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v)), None, None,
                              torch.from_numpy(do), causal=causal)
    assert flash_attention_bwd.launches == before
    for g, want in zip(got, _grads_ref(q, k, v, do, causal)):
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-4)


def test_gradient_through_ops_attention_is_autograd_of_the_plain_version():
    from repro_torch.kernels.flash_attention import flash_attention_bwd_plain

    q, k, v = (torch.from_numpy(a) for a in _case(1, 20, 20, 4, 2, 16))
    do = torch.from_numpy(RNG.normal(size=q.shape).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.attention(*leaves, causal=True).backward(do)
    for a, b in zip((t.grad for t in leaves), flash_attention_bwd_plain(q, k, v, do)):
        assert torch.equal(a, b)


def test_rows_that_see_no_key_have_zero_gradients():
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    q, k, v = _case(1, 50, 20, 4, 2, 16)  # causal: the first 30 rows see no key
    do = RNG.normal(size=q.shape).astype(np.float32)
    dq, dk, dv = flash_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v)), None,
                                     None, torch.from_numpy(do), causal=True)
    assert not bool(dq[:, :30].any())
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    # the rows that see keys: ref's gradient with the keyless rows' dO zeroed
    do_seen = do.copy()
    do_seen[:, :30] = 0.0
    want = _grads_ref(q[:, 30:], k, v, do_seen[:, 30:], True)
    np.testing.assert_allclose(dq[:, 30:].numpy(), want[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dk.numpy(), want[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dv.numpy(), want[2], rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ backward tile walk
# The card's bfloat16 backward kernels compute the score matrix in pieces of
# 16 rows (a warp's) against a streamed tile; ``flash_bwd_walk`` mirrors their
# index arithmetic. Each kernel must compute every visible (query, key) pair
# once, and no piece in which every pair is masked.
@pytest.mark.parametrize("S,T", [(2048, 2048), (1000, 1000), (100, 100), (33, 65), (130, 200),
                                 (150, 90), (48, 20), (77, 77), (1, 1), (64, 192)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("warps", [(4, 4), (8, 8), (4, 8)])
@pytest.mark.parametrize("tile", [64, 128])
def test_backward_walk_visits_each_visible_pair_once(S, T, causal, warps, tile):
    walk = flash_bwd_walk(S, T, causal, *warps, tile=tile)
    qpos = np.arange(S)[:, None] + (T - S)
    visible = np.arange(T)[None, :] <= qpos if causal else np.ones((S, T), bool)
    for kernel, pieces in walk.items():
        seen = np.zeros((S, T), np.int8)
        for q0, q1, k0, k1 in pieces:
            assert 0 <= q0 < q1 <= S and 0 <= k0 < k1 <= T, (kernel, q0, q1, k0, k1)
            assert visible[q0:q1, k0:k1].any(), f"{kernel} computes a masked piece"
            seen[q0:q1, k0:k1] += 1
        assert (seen <= 1).all(), f"{kernel} computes a pair twice"
        assert (seen[visible] == 1).all(), f"{kernel} misses a visible pair"
    if causal and S == T > 16 * 8:
        # heaviest first: the dQ kernel starts at the last query rows, the
        # dK dV kernel at the first keys
        own = 16 * warps[0]  # query rows a dQ block
        assert walk["dq"][0][0] // own == max(p[0] for p in walk["dq"]) // own
        assert walk["dkdv"][0][2] == 0


def test_variant_source_rewrites_the_geometry_constants():
    # tools/flash_bwd_variants.py times the bfloat16 kernels at other warps
    # and tile sizes by rewriting one constant each in a copy of the source
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "flash_bwd_variants", root / "tools" / "flash_bwd_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (root / "src" / "repro_torch" / "csrc" / "flash_attention_bwd.cu").read_text()
    out = tool.variant_source(src, 8, 4, 128)
    for name, value in (("kDqWarps", 8), ("kDkdvWarps", 4), ("kTile", 128)):
        assert f"constexpr int {name} = {value};" in out
    assert len(out.splitlines()) == len(src.splitlines())
    with pytest.raises(RuntimeError, match="kTile"):
        tool.variant_source(src.replace("constexpr int kTile", "constexpr int kTileRows"), 4, 4, 64)
