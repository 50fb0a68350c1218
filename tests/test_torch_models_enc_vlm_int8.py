"""The port's encoder-decoder (Whisper-small), VLM (InternVL2-1B) and int8
KV cache against the JAX package at ``.scaled()`` size, on the CPU, with
the JAX parameters carried across by ``convert.model_params_from_jax`` and
the same numpy tokens, frames and patch embeddings.

Tolerances, as in ``test_torch_models_moe_mla.py``: rtol = atol = 1e-4 in
float32 and 0.08 in bfloat16. ``quantize_kv`` is compared exactly.

Two gaps of the JAX ``prefill`` (``repro/models/transformer.py:448-466``)
and what the port's fill does instead:

* **The cross state.** ``init_decode_state`` zeroes ``b{i}_xk`` /
  ``b{i}_xv`` and the JAX ``prefill`` keeps the state it is given, so its
  decode steps attend over zeros unless the caller writes
  ``_cross_kv(encode(frames))`` first. The port's ``prefill(frames=...)``
  writes it (``cross_state``), so it is held against the JAX ``prefill``
  given a state so prepared, and against JAX ``forward``'s last position.
* **The image prefix.** The JAX ``prefill`` steps over the tokens alone at
  positions 0 .. S-1, while ``forward`` puts them at P .. P+S-1 after the
  P patch embeddings. The port's one-forward ``prefill`` writes all P + S
  positions (its last logits are JAX ``forward``'s and decoding goes on at
  ``cur_len = P + S``); ``prefill_stepwise`` keeps the JAX semantics and is
  held against the JAX ``prefill``.

An int8 cache is filled by one forward whose keys and values may differ
from a decode step's by an ulp in float32, which can move ``rint`` by one
step: the fill's caches are held against the decode loop's within one
quantization step times the scale, not bit for bit.
"""

from dataclasses import asdict, replace

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
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch import configs, convert
from repro_torch import models as pm
from repro_torch.launch.serve import make_serve_fns
from repro_torch.models import layers as pl_
from repro_torch.models import transformer as pt
from repro_torch.models.config import ModelConfig

NEW_ARCHS = ["whisper-small", "internvl2-1b"]
INT8_ARCHS = ["qwen3-1.7b", "chatglm3-6b"]
F32 = dict(param_dtype="float32", compute_dtype="float32")
TIGHT = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.08, atol=0.08)
B, S = 2, 12
P = 8  # the scaled configs' frontend_len: frames of Whisper, patches of InternVL2
MAX_LEN = P + S + 4


def _pair(name, **overrides):
    """(jax cfg, port cfg, jax params, port params) at .scaled() size."""
    jcfg = jconfigs.get_config(name).scaled(**overrides)
    pcfg = configs.get_config(name).scaled(**overrides)
    jp = jm.init_model(jax.random.key(0), jcfg)
    pp = convert.model_params_from_jax(jax.tree.map(np.asarray, jp), pcfg)
    return jcfg, pcfg, jp, pp


def _tokens(cfg, seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _frontend(cfg, seed=2):
    """The arch's frontend input as ({jax kwargs}, {port kwargs}): ``frames``
    for an encoder arch, ``extra_embeds`` for a VLM, both (B, P, D) normal
    numpy draws in the compute dtype, nothing for a text-only arch."""
    if cfg.frontend == "none":
        return {}, {}
    key = "frames" if cfg.has_encoder else "extra_embeds"
    a = np.random.default_rng(seed).normal(size=(B, cfg.frontend_len, cfg.d_model))
    a = np.asarray(jnp.asarray(a, jnp.dtype(cfg.compute_dtype)))
    return {key: jnp.asarray(a)}, {key: _t(a)}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _tok(a):
    return torch.from_numpy(np.asarray(a)).long()


def _dtype_name(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return jnp.dtype(x.dtype).name


def _assert_state_close(jstate, pstate, tol):
    assert set(jstate) == set(pstate)
    for key in jstate:
        assert tuple(jstate[key].shape) == tuple(pstate[key].shape), key
        assert _dtype_name(pstate[key]) == _dtype_name(jstate[key]), key
        np.testing.assert_allclose(_np(pstate[key]), _np(jstate[key]), **tol, err_msg=key)


def _jax_cross_state(jp, jcfg, js, frames):
    """The JAX state with ``b0_xk`` / ``b0_xv`` set to
    ``_cross_kv(encode(frames))``, what the JAX ``prefill`` needs given."""
    ck, cv = jt._cross_kv(jp, jcfg, jt.encode(jp, jcfg, frames))
    return {**js, "b0_xk": ck.astype(js["b0_xk"].dtype), "b0_xv": cv.astype(js["b0_xv"].dtype)}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.fixture
def host_mesh():
    mesh = make_host_mesh()
    yield mesh
    set_mesh(None)  # make_serve_fns sets the JAX package's ambient mesh


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", NEW_ARCHS)
def test_configs_are_copies(name):
    assert name in configs.PORTED_ARCHS
    assert asdict(configs.get_config(name)) == asdict(jconfigs.get_config(name))
    assert asdict(configs.get_config(name).scaled(**F32)) == asdict(
        jconfigs.get_config(name).scaled(**F32))


def test_published_configs():
    w, v = configs.get_config("whisper-small"), configs.get_config("internvl2-1b")
    assert (w.num_layers, w.encoder_layers, w.d_model, w.num_heads, w.num_kv_heads,
            w.head_dim, w.frontend, w.frontend_len, w.vocab_size) == (
        12, 12, 768, 12, 12, 64, "audio_stub", 1500, 51865)
    assert (v.num_layers, v.d_model, v.num_heads, v.num_kv_heads, v.head_dim, v.frontend,
            v.frontend_len, v.qkv_bias, v.tie_embeddings) == (
        24, 896, 14, 2, 64, "vision_stub", 256, True, True)


def test_jamba_config_is_the_jax_one_and_supported():
    """Jamba's config equals the JAX one field by field, and its blocks
    (attention, Mamba, MoE) pass ``check_supported``."""
    got = configs.get_config("jamba-1.5-large-398b")
    want = jconfigs.get_config("jamba-1.5-large-398b")
    for field, value in asdict(want).items():
        assert getattr(got, field) == value, field
    pt.check_supported(got)
    pt.check_supported(ModelConfig(**asdict(want)))


@pytest.mark.parametrize("overrides", [
    dict(kv_cache_dtype="int8"), dict(encoder_layers=2, frontend="audio_stub", frontend_len=8),
    dict(frontend="vision_stub", frontend_len=8),
])
def test_check_supported_accepts_the_new_pieces(overrides):
    cfg = ModelConfig(name="x", family="dense", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, **overrides)
    pt.check_supported(cfg)
    params = pm.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert ("encoder" in params) == bool(cfg.encoder_layers)


# ------------------------------------------------------------------- params
@pytest.mark.parametrize("name", NEW_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_cross_both_ways_bit_for_bit(name, dtype):
    jcfg, pcfg, jp, pp = _pair(name, param_dtype=dtype, compute_dtype=dtype)
    back = convert.params_from_model(pp, pcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        a, b = _bits(a), flat_b[path]
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    if jcfg.has_encoder:
        assert len(pp["encoder"]["layers"]) == jcfg.encoder_layers
        assert set(pp["layers"][0]) == {"ln1", "mix", "ln2", "ffn", "lnx", "xattn"}
        assert tuple(pp["encoder"]["pos_embed"].shape) == (max(jcfg.frontend_len, 8),
                                                           jcfg.d_model)
    else:
        assert "encoder" not in pp and "lm_head" not in pp  # tied embeddings


@pytest.mark.parametrize("name", NEW_ARCHS)
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
    w = pp["encoder"]["pos_embed"] if pcfg.has_encoder else pp["embed"]
    assert abs(float(w.float().std()) * np.sqrt(pcfg.d_model) - 1.0) < 0.1


# ------------------------------------------------------------- float32 lanes
def test_encode_matches_jax():
    jcfg, pcfg, jp, pp = _pair("whisper-small", **F32)
    jkw, pkw = _frontend(jcfg)
    want = jt.encode(jp, jcfg, jkw["frames"])
    got = pm.encode(pp, pcfg, pkw["frames"])
    assert got.shape == (B, P, pcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **TIGHT)
    # fewer frames than frontend_len: pos_embed[:T]
    np.testing.assert_allclose(_np(pm.encode(pp, pcfg, pkw["frames"][:, :5])),
                               _np(jt.encode(jp, jcfg, jkw["frames"][:, :5])), **TIGHT)


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_forward_matches_jax(name):
    jcfg, pcfg, jp, pp = _pair(name, **F32)
    toks = _tokens(jcfg)
    jkw, pkw = _frontend(jcfg)
    jlog, jaux = jm.forward(jp, jcfg, jnp.asarray(toks), **jkw)
    plog, paux = pm.forward(pp, pcfg, _tok(toks), **pkw)
    assert plog.shape == (B, S, jcfg.vocab_size)  # a VLM's prefix logits dropped
    np.testing.assert_allclose(_np(plog), _np(jlog), **TIGHT)
    assert float(paux) == float(jaux) == 0.0


def test_encoder_arch_requires_frames():
    jcfg, pcfg, jp, pp = _pair("whisper-small", **F32)
    toks = _tokens(jcfg)
    with pytest.raises(ValueError, match="requires frames"):
        jm.forward(jp, jcfg, jnp.asarray(toks))
    with pytest.raises(ValueError, match="requires frames"):
        pm.forward(pp, pcfg, _tok(toks))
    with pytest.raises(ValueError, match="requires frames"):
        pm.prefill(pp, pcfg, _tok(toks), pm.init_decode_state(pcfg, B, MAX_LEN, P,
                                                               device="cpu"))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_with_frames_matches_no_remat(remat):
    """The checkpointed groups carry the cross keys and values: the same
    loss and gradients as without remat, float32."""
    _, pcfg, _, pp = _pair("whisper-small", **F32)
    toks = _tok(_tokens(pcfg))
    _, pkw = _frontend(pcfg)
    grads = {}
    for mode in ("none", remat):
        leaves = [t.detach().clone().requires_grad_(True) for t in (
            pp["layers"][0]["xattn"]["w_k"], pp["encoder"]["layers"][0]["mix"]["w_q"])]
        p = {**pp, "layers": [{**pp["layers"][0], "xattn": {
            **pp["layers"][0]["xattn"], "w_k": leaves[0]}}] + pp["layers"][1:],
            "encoder": {**pp["encoder"], "layers": [{**pp["encoder"]["layers"][0], "mix": {
                **pp["encoder"]["layers"][0]["mix"], "w_q": leaves[1]}}]
                + pp["encoder"]["layers"][1:]}}
        logits, _ = pm.forward(p, pcfg, toks, remat=mode, **pkw)
        grads[mode] = torch.autograd.grad(logits.square().mean(), leaves)
    for a, b in zip(grads["none"], grads[remat]):
        assert float(a.abs().max()) > 0
        torch.testing.assert_close(b, a, **TIGHT)


def test_cross_state_matches_jax_cross_kv():
    jcfg, pcfg, jp, pp = _pair("whisper-small", **F32)
    jkw, pkw = _frontend(jcfg)
    js = _jax_cross_state(jp, jcfg, jm.init_decode_state(jcfg, B, MAX_LEN, P), jkw["frames"])
    ps = pm.cross_state(pp, pcfg, pm.init_decode_state(pcfg, B, MAX_LEN, P, device="cpu"),
                        pkw["frames"])
    _assert_state_close(js, ps, TIGHT)
    assert float(ps["b0_xk"].abs().max()) > 0


def test_decode_steps_from_a_jax_prepared_cross_state():
    jcfg, pcfg, jp, pp = _pair("whisper-small", **F32)
    toks = _tokens(jcfg, seed=3, shape=(B, 4))
    jkw, pkw = _frontend(jcfg)
    js = _jax_cross_state(jp, jcfg, jm.init_decode_state(jcfg, B, MAX_LEN, P), jkw["frames"])
    ps = pm.cross_state(pp, pcfg, pm.init_decode_state(pcfg, B, MAX_LEN, P, device="cpu"),
                        pkw["frames"])
    for t in range(toks.shape[1]):
        jlog, js = jm.decode_step(jp, jcfg, js, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        plog, ps = pm.decode_step(pp, pcfg, ps, _tok(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(plog), _np(jlog), **TIGHT)
    _assert_state_close(js, ps, TIGHT)


def test_prefill_with_frames_matches_jax_prefill_given_the_cross_state():
    """The port's one-forward fill with frames against the JAX ``prefill``
    given a state whose cross keys and values were written first, and
    against JAX ``forward``'s last position; the decode loop
    (``prefill_stepwise``) too."""
    jcfg, pcfg, jp, pp = _pair("whisper-small", **F32)
    toks = _tokens(jcfg, seed=4)
    jkw, pkw = _frontend(jcfg)
    js = _jax_cross_state(jp, jcfg, jm.init_decode_state(jcfg, B, MAX_LEN, P), jkw["frames"])
    jlast, js = jm.prefill(jp, jcfg, jnp.asarray(toks), js, **jkw)
    jlog, _ = jm.forward(jp, jcfg, jnp.asarray(toks), **jkw)
    for fill in (pm.prefill, pm.prefill_stepwise):
        plast, ps = fill(pp, pcfg, _tok(toks),
                         pm.init_decode_state(pcfg, B, MAX_LEN, P, device="cpu"), **pkw)
        assert plast.shape == (B, 1, jcfg.vocab_size)
        np.testing.assert_allclose(_np(plast), _np(jlast), **TIGHT)
        np.testing.assert_allclose(_np(plast[:, 0]), _np(jlog[:, -1]), **TIGHT)
        _assert_state_close(js, ps, TIGHT)


def test_jax_prefill_leaves_the_cross_state_zero():
    """The reference gap: the JAX ``prefill`` from ``init_decode_state``
    keeps zero cross keys and values, so its last logits are not its own
    ``forward``'s; the port's fill writes them (the test above)."""
    jcfg, _, jp, _ = _pair("whisper-small", **F32)
    toks = _tokens(jcfg, seed=4)
    jkw, _ = _frontend(jcfg)
    jlast, js = jm.prefill(jp, jcfg, jnp.asarray(toks), jm.init_decode_state(jcfg, B, MAX_LEN, P),
                           **jkw)
    jlog, _ = jm.forward(jp, jcfg, jnp.asarray(toks), **jkw)
    assert not np.asarray(js["b0_xk"]).any()
    assert not np.allclose(_np(jlast[:, 0]), _np(jlog[:, -1]), **TIGHT)


def test_prefill_with_frames_then_decoding_matches_the_decode_loop():
    _, pcfg, _, pp = _pair("whisper-small", **F32)
    toks = _tok(_tokens(pcfg, seed=5))
    _, pkw = _frontend(pcfg)
    last, st = pm.prefill(pp, pcfg, toks, pm.init_decode_state(pcfg, B, MAX_LEN, P, device="cpu"),
                          **pkw)
    olast, ost = pm.prefill_stepwise(pp, pcfg, toks,
                                     pm.init_decode_state(pcfg, B, MAX_LEN, P, device="cpu"),
                                     **pkw)
    np.testing.assert_allclose(_np(last), _np(olast), **TIGHT)
    nxt = olast[:, -1].argmax(-1, keepdim=True)
    for t in range(S, S + 3):
        pl, st = pm.decode_step(pp, pcfg, st, nxt, t)
        ol, ost = pm.decode_step(pp, pcfg, ost, nxt, t)
        np.testing.assert_allclose(_np(pl), _np(ol), **TIGHT)
        nxt = ol[:, -1].argmax(-1, keepdim=True)
    _assert_state_close(ost, st, TIGHT)


def test_prefill_with_extra_embeds_is_forward_with_the_prefix():
    """The port's one-forward fill writes the P prefix positions and the S
    tokens: its last logits are JAX ``forward``'s last position (and the
    JAX serve fns' ``prefill``), and a decode step at ``cur_len = P + S``
    gives JAX ``forward``'s logits over the prompt and that token."""
    jcfg, pcfg, jp, pp = _pair("internvl2-1b", **F32)
    toks = _tokens(jcfg, seed=6)
    jkw, pkw = _frontend(jcfg)
    plast, ps = pm.prefill(pp, pcfg, _tok(toks),
                           pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu"), **pkw)
    jlog, _ = jm.forward(jp, jcfg, jnp.asarray(toks), **jkw)
    np.testing.assert_allclose(_np(plast[:, 0]), _np(jlog[:, -1]), **TIGHT)
    assert float(ps["b0_k"][:, :, P + S - 1].abs().max()) > 0
    assert not ps["b0_k"][:, :, P + S:].any()
    nxt = np.asarray(jlog[:, -1].argmax(-1))[:, None].astype(np.int32)
    pl, ps = pm.decode_step(pp, pcfg, ps, _tok(nxt), P + S)
    jl2, _ = jm.forward(jp, jcfg, jnp.asarray(np.concatenate([toks, nxt], 1)), **jkw)
    np.testing.assert_allclose(_np(pl[:, 0]), _np(jl2[:, -1]), **TIGHT)


def test_prefill_stepwise_with_extra_embeds_matches_jax_prefill():
    """``prefill_stepwise`` keeps the JAX ``prefill``'s semantics: the
    tokens alone at positions 0 .. S-1 (the patches never reach the
    caches), logits and state at 1e-4; the JAX ``prefill``'s last logits
    are then not JAX ``forward``'s (the reference gap)."""
    jcfg, pcfg, jp, pp = _pair("internvl2-1b", **F32)
    toks = _tokens(jcfg, seed=7)
    jkw, pkw = _frontend(jcfg)
    jlast, js = jm.prefill(jp, jcfg, jnp.asarray(toks), jm.init_decode_state(jcfg, B, MAX_LEN),
                           **jkw)
    plast, ps = pm.prefill_stepwise(pp, pcfg, _tok(toks),
                                    pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu"), **pkw)
    np.testing.assert_allclose(_np(plast), _np(jlast), **TIGHT)
    _assert_state_close(js, ps, TIGHT)
    jlog, _ = jm.forward(jp, jcfg, jnp.asarray(toks), **jkw)
    assert not np.allclose(_np(jlast[:, 0]), _np(jlog[:, -1]), **TIGHT)
    # without the prefix the two fills agree
    olast, ost = pm.prefill(pp, pcfg, _tok(toks),
                            pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu"))
    np.testing.assert_allclose(_np(olast), _np(plast), **TIGHT)
    _assert_state_close(js, ost, TIGHT)


@pytest.mark.parametrize("name", NEW_ARCHS + ["qwen3-1.7b-int8"])
def test_serve_fns_match_jax(name, host_mesh):
    """The serve fns against the JAX ones on the host mesh: the prefill fn
    with the frontend's input, then decode steps from the same state (for
    Whisper, the cross state written on both sides; for the int8 cache,
    the JAX decode fn's context-parallel branch, which dequantizes inside
    its shards)."""
    arch = name.removesuffix("-int8")
    jcfg, pcfg, jp, pp = _int8(arch, **F32) if arch != name else _pair(arch, **F32)
    jf = jax_serve_fns(jcfg, host_mesh, B, MAX_LEN)
    pf = make_serve_fns(pcfg, B, MAX_LEN, device="cpu")
    toks = _tokens(jcfg, seed=8)
    jkw, pkw = _frontend(jcfg)
    np.testing.assert_allclose(_np(pf["prefill"](pp, _tok(toks), **pkw)),
                               _np(jf["prefill"](jp, jnp.asarray(toks), **jkw)), **TIGHT)
    js = jm.init_decode_state(jcfg, B, MAX_LEN, jcfg.frontend_len if jcfg.has_encoder else 0)
    ps = pf["init_state"]()
    _assert_state_close(js, ps, TIGHT)
    if jcfg.has_encoder:
        js = _jax_cross_state(jp, jcfg, js, jkw["frames"])
        ps = pm.cross_state(pp, pcfg, ps, pkw["frames"])
    for t in range(3):
        jlog, js = jf["decode"](jp, js, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        plog, ps = pf["decode"](pp, ps, _tok(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(plog), _np(jlog), **TIGHT)
    _assert_state_close(js, ps, TIGHT)


# ------------------------------------------------------------ bfloat16 lane
@pytest.mark.parametrize("name", NEW_ARCHS)
def test_bf16_forward_and_decode_match_jax(name):
    jcfg, pcfg, jp, pp = _pair(name)
    assert pcfg.param_dtype == pcfg.compute_dtype == "bfloat16"
    toks = _tokens(jcfg, seed=9)
    jkw, pkw = _frontend(jcfg)
    jlog, _ = jm.forward(jp, jcfg, jnp.asarray(toks), **jkw)
    plog, _ = pm.forward(pp, pcfg, _tok(toks), **pkw)
    assert plog.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(plog), _np(jlog), **BF16)
    enc = P if jcfg.has_encoder else 0
    js = jm.init_decode_state(jcfg, B, MAX_LEN, enc)
    ps = pm.init_decode_state(pcfg, B, MAX_LEN, enc, device="cpu")
    if jcfg.has_encoder:
        js = _jax_cross_state(jp, jcfg, js, jkw["frames"])
        ps = pm.cross_state(pp, pcfg, ps, pkw["frames"])
    jlast, js = jm.prefill(jp, jcfg, jnp.asarray(toks), js, **jkw)
    plast, ps = pm.prefill_stepwise(pp, pcfg, _tok(toks), ps, **pkw)
    np.testing.assert_allclose(_np(plast), _np(jlast), **BF16)
    _assert_state_close(js, ps, BF16)


# ------------------------------------------------------------ int8 KV cache
def _kv_rows(case):
    rng = np.random.default_rng(13)
    shape = (3, 5, 4, 32)
    if case == "random":
        return rng.normal(size=shape).astype(np.float32) * rng.uniform(0.01, 10, (3, 5, 4, 1))
    if case == "ties":
        # amax 127 gives scale 1 exactly: every x.5 value is a rounding tie
        x = rng.integers(-126, 126, shape).astype(np.float32) + 0.5
        x[..., 0] = 127.0
        x[..., 1] = -127.0
        return x
    if case == "zeros":
        x = np.zeros(shape, np.float32)
        x[0, 0, 0, 0] = 1e-9  # below the 1e-6 floor of the scale
        return x
    # bfloat16 rows, as the model's bf16 keys and values come
    return np.asarray(jnp.asarray(rng.normal(size=shape) * 3, jnp.bfloat16))


@pytest.mark.parametrize("case", ["random", "ties", "zeros", "bfloat16"])
def test_quantize_kv_equals_jax_exactly(case):
    x = _kv_rows(case)
    jq, js = jl.quantize_kv(jnp.asarray(x))
    pq, ps = pl_.quantize_kv(_t(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.bfloat16
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.view(torch.int16).numpy().view(np.uint16), _bits(js))
    if case == "ties":
        # half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
        assert np.array_equal(pq.numpy()[..., 2:], np.round(x[..., 2:]).astype(np.int8))
        assert np.all(pq.numpy()[..., 2:] % 2 == 0)
    if case == "zeros":
        assert not pq.any() and float(ps[1:].float().max()) == np.float32(
            jnp.asarray(1e-6 / 127, jnp.bfloat16))


def _attended(q, s, rep):
    """The JAX ``attn_decode``'s dequantized keys as its attention reads
    them: ``cache.bf16 * scale.bf16``, repeated for ``rep`` query heads a
    KV head (``ref.decode_attention``), cast to float32."""
    kd = q.astype(jnp.bfloat16) * s.astype(jnp.bfloat16)
    kx = jnp.repeat(kd, rep, axis=2) if rep > 1 else kd
    return kx.astype(jnp.float32)[:, :, ::rep]


def test_jax_dequantizes_in_bfloat16_only_with_grouped_heads():
    """A reference gap. The JAX ``attn_decode`` rounds the dequantized
    cache to bfloat16, as the port's ``dequantize_kv`` does, and XLA
    compiles it so when query heads share a KV head (the repeat sits
    between the product and the float32 cast). With one query head a KV
    head XLA, allowed excess precision by default, drops the rounding and
    attends over the exact float32 product (an int8 value times a
    bfloat16 scale is exact there). The published GQA archs share KV heads
    (Qwen3-1.7B 16/8, ChatGLM3-6B 32/2); ``.scaled()`` Qwen3's 4/4 does
    not, so the int8 tests keep Qwen3's ratio of 2."""
    q, s = jl.quantize_kv(jnp.asarray(_kv_rows("random")))
    port = pl_.dequantize_kv(_t(q), _t(s)).float().numpy()
    exact = np.asarray(q, np.float64) * np.asarray(s, np.float64)
    np.testing.assert_array_equal(port, np.asarray(_attended(q, s, 1)))  # op by op
    np.testing.assert_array_equal(port, np.asarray(jax.jit(_attended, static_argnums=2)(q, s, 2)))
    np.testing.assert_array_equal(np.asarray(jax.jit(_attended, static_argnums=2)(q, s, 1)), exact)
    assert not np.array_equal(port, exact)


def test_int8_decode_with_a_kv_head_a_query_head_differs_by_that_rounding_alone(monkeypatch):
    """``.scaled()`` Qwen3 (4 query heads over 4 KV heads): the JAX decode
    steps attend over the exact products. The port's, over its bfloat16
    ones, leave 1e-4 behind; given the exact products instead they agree
    at 1e-4: the rounding is the whole gap."""
    jcfg, pcfg, jp, pp = _pair("qwen3-1.7b", kv_cache_dtype="int8", **F32)
    assert pcfg.num_heads == pcfg.num_kv_heads
    toks = _tokens(jcfg, seed=10, shape=(B, 3))
    worst = {}
    for mode in ("bfloat16", "exact"):
        if mode == "exact":
            monkeypatch.setattr(pl_, "dequantize_kv", lambda q, s: q.float() * s.float())
        js = jm.init_decode_state(jcfg, B, MAX_LEN)
        ps = pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu")
        worst[mode] = 0.0
        for t in range(toks.shape[1]):
            jlog, js = jm.decode_step(jp, jcfg, js, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
            plog, ps = pm.decode_step(pp, pcfg, ps, _tok(toks[:, t:t + 1]), t)
            worst[mode] = max(worst[mode], float(np.abs(_np(plog) - _np(jlog)).max()))
    assert worst["exact"] <= 1e-4 < worst["bfloat16"], worst


def _int8(name, **over):
    """An arch with the int8 cache at ``.scaled()`` size; Qwen3 keeps its
    published two query heads a KV head (see the test above)."""
    if name == "qwen3-1.7b":
        over.setdefault("num_kv_heads", 2)
    return _pair(name, kv_cache_dtype="int8", **over)


def _deq(q, s):
    return q.astype(np.float32) * s.astype(np.float32)


def _assert_int8_state_close(jstate, pstate, steps: float = 0.0, tol=TIGHT):
    """The int8 caches' dequantized values within ``steps`` quantization
    steps (their scales) plus ``tol`` of each other, the int8 values equal
    when ``steps`` is 0; the scales and every other entry within ``tol``."""
    assert set(jstate) == set(pstate)
    for key in jstate:
        assert tuple(jstate[key].shape) == tuple(pstate[key].shape), key
        if pstate[key].dtype != torch.int8:
            np.testing.assert_allclose(_np(pstate[key]), _np(jstate[key]), **tol, err_msg=key)
            continue
        assert np.asarray(jstate[key]).dtype == np.int8
        js, ps = _np(jstate[key + "s"]), _np(pstate[key + "s"])
        jd, pd = _deq(np.asarray(jstate[key]), js), _deq(pstate[key].numpy(), ps)
        if steps == 0:
            np.testing.assert_array_equal(pstate[key].numpy(), np.asarray(jstate[key]), key)
        bound = steps * np.maximum(js, ps) + tol["atol"] + tol["rtol"] * np.abs(jd)
        assert np.all(np.abs(pd - jd) <= bound), (key, float(np.abs(pd - jd).max()))


@pytest.mark.parametrize("name", INT8_ARCHS)
def test_int8_decode_steps_match_jax(name):
    """Decode steps with the int8 cache (ChatGLM3-6B: half RoPE) from a
    zero state: logits at 1e-4 each step; the int8 values equal, the
    scales within a bfloat16 ulp."""
    jcfg, pcfg, jp, pp = _int8(name, **F32)
    toks = _tokens(jcfg, seed=10, shape=(B, 6))
    js = jm.init_decode_state(jcfg, B, MAX_LEN)
    ps = pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu")
    assert ps["b0_k"].dtype == torch.int8 and ps["b0_ks"].shape == (
        pcfg.num_groups, B, MAX_LEN, pcfg.num_kv_heads, 1)
    _assert_state_close(js, ps, TIGHT)
    for t in range(toks.shape[1]):
        jlog, js = jm.decode_step(jp, jcfg, js, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        plog, ps = pm.decode_step(pp, pcfg, ps, _tok(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(plog), _np(jlog), **TIGHT)
    _assert_int8_state_close(js, ps)


@pytest.mark.parametrize("name", INT8_ARCHS)
def test_int8_prefill_matches_jax_prefill(name):
    """The one-forward fill against the JAX ``prefill`` (a decode loop):
    its attention reads the keys and values quantized, as the decode steps
    read their cache, so the last logits agree at 1e-4 and the caches
    within one quantization step; ``forward``, which attends over the
    unquantized keys and values, gives other last logits. The port's
    decode loop (``prefill_stepwise``) equals the JAX one, and decoding on
    from either fill agrees at 1e-4."""
    jcfg, pcfg, jp, pp = _int8(name, **F32)
    toks = _tokens(jcfg, seed=11)
    jlast, js = jm.prefill(jp, jcfg, jnp.asarray(toks), jm.init_decode_state(jcfg, B, MAX_LEN))
    jlog, _ = jm.forward(jp, jcfg, jnp.asarray(toks))
    plast, ps = pm.prefill(pp, pcfg, _tok(toks), pm.init_decode_state(pcfg, B, MAX_LEN,
                                                                      device="cpu"))
    np.testing.assert_allclose(_np(plast), _np(jlast), **TIGHT)
    assert not np.allclose(_np(jlast[:, 0]), _np(jlog[:, -1]), **TIGHT)
    _assert_int8_state_close(js, ps, steps=1.0)
    olast, ost = pm.prefill_stepwise(pp, pcfg, _tok(toks),
                                     pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu"))
    np.testing.assert_allclose(_np(olast), _np(jlast), **TIGHT)
    _assert_int8_state_close(js, ost)
    nxt = olast[:, -1].argmax(-1, keepdim=True)
    for t in range(S, S + 3):
        pl, ps = pm.decode_step(pp, pcfg, ps, nxt, t)
        ol, ost = pm.decode_step(pp, pcfg, ost, nxt, t)
        np.testing.assert_allclose(_np(pl), _np(ol), **TIGHT)
        nxt = ol[:, -1].argmax(-1, keepdim=True)


def test_int8_bf16_decode_matches_jax():
    """bfloat16 with the int8 cache: the decode loop against the JAX
    ``prefill`` within the bfloat16 tolerance, the caches within one
    quantization step of it."""
    jcfg, pcfg, jp, pp = _int8("qwen3-1.7b")
    toks = _tokens(jcfg, seed=12)
    jlast, js = jm.prefill(jp, jcfg, jnp.asarray(toks), jm.init_decode_state(jcfg, B, MAX_LEN))
    plast, ps = pm.prefill_stepwise(pp, pcfg, _tok(toks),
                                    pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu"))
    np.testing.assert_allclose(_np(plast), _np(jlast), **BF16)
    _assert_int8_state_close(js, ps, steps=1.0, tol=BF16)


def test_int8_cache_is_about_half_the_bytes():
    """At Qwen3-1.7B's published size, 4 x 2,080 positions: the int8
    caches and their scales against the bfloat16 caches (shapes only)."""
    cfg = configs.get_config("qwen3-1.7b")
    per = cfg.num_layers * 4 * 2080 * cfg.num_kv_heads * 2  # K and V rows
    bf16, int8 = per * cfg.head_dim * 2, per * cfg.head_dim + per * 2
    assert (bf16, int8) == (954_204_160, 484_556_800)
    st = pm.init_decode_state(replace(cfg, num_layers=2, kv_cache_dtype="int8"), 1, 4,
                              device="cpu")
    assert {k: (t.dtype, tuple(t.shape)) for k, t in st.items()} == {
        "b0_k": (torch.int8, (2, 1, 4, 8, 128)), "b0_v": (torch.int8, (2, 1, 4, 8, 128)),
        "b0_ks": (torch.bfloat16, (2, 1, 4, 8, 1)), "b0_vs": (torch.bfloat16, (2, 1, 4, 8, 1))}
