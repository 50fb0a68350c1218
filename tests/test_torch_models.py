"""The port's Qwen3 (dense GQA) and RWKV6 model families against the JAX
package at ``.scaled()`` size, on the CPU, with the JAX parameters carried
across by ``convert.model_params_from_jax`` and the same numpy tokens.

``FAMILIES`` stays these two: the five architectures of the MoE, MLA and
remaining dense configs run the same checks, and their own, in
``test_torch_models_moe_mla.py``, a file of its own so that ``--dist
loadfile`` gives the two files to different workers.

Tolerances:

* float32 (``.scaled(param_dtype="float32", compute_dtype="float32")``):
  rtol = atol = 1e-4. The two packages run the same float32 arithmetic in
  other summation orders (XLA's dots and reductions against PyTorch's);
  the logits are O(5) and differ by about 2e-6, so 1e-4 is ~50x margin
  and still catches any wrong term.
* bfloat16 (the configs as published): rtol = atol = 0.08, the JAX smoke
  test's own bound for decode against forward (``test_models_smoke.py``).
  The two frameworks round to bfloat16 after different ops; the logits
  differ by about 0.035.
"""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jm
from repro.launch.context import set_mesh
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import make_serve_fns as jax_serve_fns
from repro_torch import configs, convert
from repro_torch import models as pm
from repro_torch.launch.serve import make_serve_fns
from repro_torch.models.config import ModelConfig

FAMILIES = ["qwen3-1.7b", "rwkv6-3b"]
F32 = dict(param_dtype="float32", compute_dtype="float32")
TIGHT = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.08, atol=0.08)
B, S, MAX_LEN = 2, 16, 24


def _pair(name, **overrides):
    """(jax cfg, port cfg, jax params, port params) at .scaled() size."""
    jcfg = jconfigs.get_config(name).scaled(**overrides)
    pcfg = configs.get_config(name).scaled(**overrides)
    jp = jm.init_model(jax.random.key(0), jcfg)
    pp = convert.model_params_from_jax(jax.tree.map(np.asarray, jp), pcfg)
    return jcfg, pcfg, jp, pp


def _tokens(cfg, seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _assert_state_close(jstate, pstate, tol):
    assert set(jstate) == set(pstate)
    for key in jstate:
        assert tuple(jstate[key].shape) == tuple(pstate[key].shape), key
        np.testing.assert_allclose(_np(pstate[key]), _np(jstate[key]), **tol, err_msg=key)


@pytest.fixture
def host_mesh():
    mesh = make_host_mesh()
    yield mesh
    set_mesh(None)  # make_serve_fns sets the JAX package's ambient mesh


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", FAMILIES)
def test_configs_are_copies(name):
    assert asdict(configs.get_config(name)) == asdict(jconfigs.get_config(name))
    assert asdict(configs.get_config(name).scaled(**F32)) == asdict(
        jconfigs.get_config(name).scaled(**F32))


def test_registry_matches_on_the_ported_archs():
    assert configs.ARCHS == jconfigs.ARCHS
    assert {k: asdict(v) for k, v in configs.SHAPES.items()} == {
        k: asdict(v) for k, v in jconfigs.SHAPES.items()}
    want = [c for c in jconfigs.arch_shape_cells() if c[0] in configs.PORTED_ARCHS]
    assert configs.arch_shape_cells() == want


def test_every_arch_of_the_jax_package_is_ported():
    """``PORTED_ARCHS`` is the JAX ``ARCHS``: ``get_config`` raises for no
    architecture, and the grid is the JAX package's 40 cells."""
    assert configs.PORTED_ARCHS == jconfigs.ARCHS
    for name in jconfigs.ARCHS:
        assert asdict(configs.get_config(name)) == asdict(jconfigs.get_config(name))
    assert configs.arch_shape_cells() == jconfigs.arch_shape_cells()
    assert len(configs.arch_shape_cells()) == 40


@pytest.mark.parametrize("overrides", [
    dict(block_pattern=("attn", "mamba")), dict(block_pattern=("mamba",)),
    dict(block_pattern=("mamba", "attn"), kv_cache_dtype="int8"),
])
def test_mamba_layouts_match_jax(overrides):
    """Two-layer models of Mamba blocks alone and beside attention (one
    with the int8 KV cache) in float32, the JAX parameters carried across:
    the forward's logits, then 4 decode steps' logits and the decode state
    (the int8 values exactly) against the JAX package."""
    fields = dict(name="x", family="dense", num_layers=2, d_model=64, num_heads=4,
                  num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, **F32, **overrides)
    jcfg, pcfg = jm.ModelConfig(**fields), ModelConfig(**fields)
    jp = jm.init_model(jax.random.key(0), jcfg)
    pp = convert.model_params_from_jax(jax.tree.map(np.asarray, jp), pcfg)
    assert "ffn" in pp["layers"][0] and "A_log" in pp["layers"][
        jcfg.block_pattern.index("mamba")]["mix"]
    toks = _tokens(jcfg)
    jlog, _ = jm.forward(jp, jcfg, jnp.asarray(toks))
    plog, _ = pm.forward(pp, pcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(plog), _np(jlog), **TIGHT)
    js = jm.init_decode_state(jcfg, B, MAX_LEN)
    ps = pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu")
    for t in range(4):
        jl_, js = jm.decode_step(jp, jcfg, js, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        pl, ps = pm.decode_step(pp, pcfg, ps, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        np.testing.assert_allclose(_np(pl), _np(jl_), **TIGHT)
    for key in js:
        if ps[key].dtype == torch.int8:
            np.testing.assert_array_equal(ps[key].numpy(), np.asarray(js[key]), key)
        else:
            np.testing.assert_allclose(_np(ps[key]), _np(js[key]), **TIGHT, err_msg=key)


# ------------------------------------------------------------------- params
@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_cross_both_ways_bit_for_bit(name, dtype):
    jcfg, pcfg, jp, pp = _pair(name, param_dtype=dtype, compute_dtype=dtype)
    back = convert.params_from_model(pp, pcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        a = np.asarray(a)
        b = flat_b[path]
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        assert a.dtype == b.dtype and np.array_equal(a, b), path


@pytest.mark.parametrize("name", FAMILIES)
def test_init_model_shapes_and_scales(name):
    jcfg = jconfigs.get_config(name).scaled()
    pcfg = configs.get_config(name).scaled()
    pp = pm.init_model(pcfg, generator=torch.Generator().manual_seed(3), device="cpu")
    shapes = jax.eval_shape(lambda k: jm.init_model(k, jcfg), jax.random.key(0))
    tree = convert.params_from_model(pp, pcfg)
    want = {p: (s.shape, s.dtype.name) for p, s in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {p: (a.shape, "bfloat16" if a.dtype == np.uint16 else a.dtype.name)
           for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    assert got == want
    assert pm.param_count(pp) == jm.param_count(shapes)
    # dense weights: normal / sqrt(fan_in)
    w = pp["lm_head"].float()
    assert abs(float(w.std()) * np.sqrt(pcfg.d_model) - 1.0) < 0.05


def test_entry_points_default_to_the_card():
    cfg = configs.get_config("qwen3-1.7b").scaled()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_serve_fns(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.init_decode_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.init_model(cfg, generator=torch.Generator())


# ------------------------------------------------------------- float32 lanes
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_jax(name):
    jcfg, pcfg, jp, pp = _pair(name, **F32)
    toks = _tokens(jcfg)
    jl, jaux = jm.forward(jp, jcfg, jnp.asarray(toks))
    pl, paux = pm.forward(pp, pcfg, torch.from_numpy(toks).long())
    assert pl.shape == (B, S, jcfg.vocab_size) and float(paux) == float(jaux) == 0.0
    np.testing.assert_allclose(_np(pl), _np(jl), **TIGHT)


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_steps_match_jax(name):
    jcfg, pcfg, jp, pp = _pair(name, **F32)
    toks = _tokens(jcfg, seed=2, shape=(B, 4))
    js = jm.init_decode_state(jcfg, B, MAX_LEN)
    ps = pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu")
    _assert_state_close(js, ps, TIGHT)
    for t in range(toks.shape[1]):
        jl, js = jm.decode_step(jp, jcfg, js, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        pl, ps = pm.decode_step(pp, pcfg, ps, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        np.testing.assert_allclose(_np(pl), _np(jl), **TIGHT)
    _assert_state_close(js, ps, TIGHT)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_matches_jax_and_forward(name):
    jcfg, pcfg, jp, pp = _pair(name, **F32)
    toks = _tokens(jcfg, seed=3)
    jlast, js = jm.prefill(jp, jcfg, jnp.asarray(toks), jm.init_decode_state(jcfg, B, MAX_LEN))
    plast, ps = pm.prefill(pp, pcfg, torch.from_numpy(toks).long(),
                           pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu"))
    assert plast.shape == (B, 1, jcfg.vocab_size)
    np.testing.assert_allclose(_np(plast), _np(jlast), **TIGHT)
    _assert_state_close(js, ps, TIGHT)
    # the last logits are the forward's last position
    pl, _ = pm.forward(pp, pcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(plast[:, 0]), _np(pl[:, -1]), **TIGHT)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_from_one_forward_matches_decode_loop(name):
    """``prefill`` writes the state from one forward; ``prefill_stepwise``
    (one decode step a token, the JAX ``prefill``'s scan) is its oracle:
    logits and every state entry within 1e-4 in float32, and decoding on
    from either state gives the same logits."""
    _, pcfg, _, pp = _pair(name, **F32)
    toks = torch.from_numpy(_tokens(pcfg, seed=6)).long()
    last, st = pm.prefill(pp, pcfg, toks, pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu"))
    olast, ost = pm.prefill_stepwise(pp, pcfg, toks,
                                     pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu"))
    np.testing.assert_allclose(_np(last), _np(olast), **TIGHT)
    _assert_state_close(ost, st, TIGHT)
    nxt = toks[:, :1]
    for t in range(S, S + 3):
        pl, st = pm.decode_step(pp, pcfg, st, nxt, t)
        ol, ost = pm.decode_step(pp, pcfg, ost, nxt, t)
        np.testing.assert_allclose(_np(pl), _np(ol), **TIGHT)
        nxt = ol[:, -1].argmax(-1, keepdim=True)
    _assert_state_close(ost, st, TIGHT)


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_decode_loop_prefill_matches_jax(name):
    """The oracle itself in bfloat16: the decode-loop fill against the JAX
    ``prefill``, logits and state, at the bfloat16 tolerance."""
    jcfg, pcfg, jp, pp = _pair(name)
    toks = _tokens(jcfg, seed=7)
    jlast, js = jm.prefill(jp, jcfg, jnp.asarray(toks), jm.init_decode_state(jcfg, B, S))
    plast, ps = pm.prefill_stepwise(pp, pcfg, torch.from_numpy(toks).long(),
                                    pm.init_decode_state(pcfg, B, S, device="cpu"))
    np.testing.assert_allclose(_np(plast), _np(jlast), **BF16)
    _assert_state_close(js, ps, BF16)


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_fns_match_jax(name, host_mesh):
    jcfg, pcfg, jp, pp = _pair(name, **F32)
    jf = jax_serve_fns(jcfg, host_mesh, B, MAX_LEN)
    pf = make_serve_fns(pcfg, B, MAX_LEN, device="cpu")
    assert set(pf) == {"prefill", "decode", "init_state"}
    toks = _tokens(jcfg, seed=4)
    np.testing.assert_allclose(_np(pf["prefill"](pp, torch.from_numpy(toks).long())),
                               _np(jf["prefill"](jp, jnp.asarray(toks))), **TIGHT)
    js = jm.init_decode_state(jcfg, B, MAX_LEN)
    ps = pf["init_state"]()
    _assert_state_close(js, ps, TIGHT)
    for t in range(3):
        jl, js = jf["decode"](jp, js, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        pl, ps = pf["decode"](pp, ps, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        np.testing.assert_allclose(_np(pl), _np(jl), **TIGHT)
    _assert_state_close(js, ps, TIGHT)


# ------------------------------------------------------------ bfloat16 lane
@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_forward_and_prefill_match_jax(name):
    jcfg, pcfg, jp, pp = _pair(name)
    assert pcfg.param_dtype == pcfg.compute_dtype == "bfloat16"
    toks = _tokens(jcfg, seed=5)
    jl, _ = jm.forward(jp, jcfg, jnp.asarray(toks))
    pl, _ = pm.forward(pp, pcfg, torch.from_numpy(toks).long())
    assert pl.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(pl), _np(jl), **BF16)
    jlast, js = jm.prefill(jp, jcfg, jnp.asarray(toks), jm.init_decode_state(jcfg, B, S))
    plast, ps = pm.prefill(pp, pcfg, torch.from_numpy(toks).long(),
                           pm.init_decode_state(pcfg, B, S, device="cpu"))
    np.testing.assert_allclose(_np(plast), _np(jlast), **BF16)
    _assert_state_close(js, ps, BF16)


# ------------------------------------------------------------ layer options
def _attn_cfg(**overrides):
    base = dict(name="layer", family="dense", num_layers=1, d_model=64, num_heads=4,
                num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, **F32)
    base.update(overrides)
    return jm.ModelConfig(**base), ModelConfig(**base)


@pytest.mark.parametrize("opts", [dict(qkv_bias=True, rope_mode="half"),
                                  dict(qk_norm=True, rope_theta=1e6)])
def test_attention_layer_options_match_jax(opts):
    from repro.models import layers as jl
    from repro_torch.models import layers as pl_

    jcfg, pcfg = _attn_cfg(**opts)
    rng = np.random.default_rng(6)
    jp = jax.tree.map(lambda a: a[0], jl.g_attn_init(jax.random.key(1), jcfg, 1))
    jp = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.3)
          if k.startswith("b_") else v for k, v in jp.items()}
    pp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12))
    jout, (jk, jv) = jl.attn_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    rope = pl_.rope_tables(torch.from_numpy(pos.copy()), pcfg)
    pout, (pk, pv) = pl_.attn_apply(pp, torch.from_numpy(x), pcfg, rope)
    for got, want in ((pout, jout), (pk, jk), (pv, jv)):
        np.testing.assert_allclose(_np(got), _np(want), **TIGHT)


def test_gelu_mlp_matches_jax():
    from repro.models import layers as jl
    from repro_torch.models import layers as pl_

    jcfg, pcfg = _attn_cfg(mlp_act="gelu")
    jp = jax.tree.map(lambda a: a[0], jl.g_mlp_init(jax.random.key(2), jcfg, 1))
    assert set(jp) == {"w1", "w2"}
    x = np.random.default_rng(7).normal(size=(2, 5, 64)).astype(np.float32)
    want = jl.mlp_apply(jp, jnp.asarray(x), jcfg)
    got = pl_.mlp_apply({k: torch.from_numpy(np.array(v)) for k, v in jp.items()},
                        torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TIGHT)
