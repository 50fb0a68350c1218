"""The port's Mamba block and the hybrid Jamba-1.5-Large (one attention
and seven Mamba blocks a group, MoE on every other layer) against the JAX
package at ``.scaled()`` size, on the CPU, with the JAX parameters carried
across by ``convert.model_params_from_jax`` and the same numpy tokens.

Tolerances, as in ``test_torch_models_moe_mla.py``: rtol = atol = 1e-4 in
float32 (the two packages sum in other orders) and 0.08 in bfloat16 (the
JAX smoke test's bound for decode against forward). MoE routing is compared
exactly.

The JAX ``mamba_apply`` scans the whole sequence at once
(``jax.lax.associative_scan`` over (B, S, d_inner, d_state) arrays); the
port's scans it in chunks of ``chunk`` positions, carrying the state from
chunk to chunk, so it is held to the JAX function at chunk lengths that
divide S, that do not, of one position and longer than S. Its full-sequence
mode also returns the state S decode steps from zeros leave (the
one-forward fill), which is held against the JAX decode steps'.
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
from repro.models import layers as jl
from repro_torch import configs, convert
from repro_torch import models as pm
from repro_torch.launch.serve import make_serve_fns
from repro_torch.models import layers as pl_
from repro_torch.models import transformer as pt

JAMBA = "jamba-1.5-large-398b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
TIGHT = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.08, atol=0.08)
B, S, MAX_LEN = 2, 16, 24


def _pair(**overrides):
    """(jax cfg, port cfg, jax params, port params) of Jamba at .scaled()
    size (2 groups of 8 blocks: 16 layers)."""
    jcfg = jconfigs.get_config(JAMBA).scaled(**overrides)
    pcfg = configs.get_config(JAMBA).scaled(**overrides)
    jp = jm.init_model(jax.random.key(0), jcfg)
    pp = convert.model_params_from_jax(jax.tree.map(np.asarray, jp), pcfg)
    return jcfg, pcfg, jp, pp


def _tokens(cfg, seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _tok(a):
    return torch.from_numpy(a).long()


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


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


# ------------------------------------------------------------ Mamba alone
def _mamba_pair(dtype="float32"):
    """One Mamba block's parameters (the JAX ``g_mamba_init`` at G = 1,
    sliced) on both sides, at Jamba's .scaled() size: d_model 64, d_inner
    128, d_state 4, d_conv 4, dt rank 4."""
    over = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = jconfigs.get_config(JAMBA).scaled(**over)
    pcfg = configs.get_config(JAMBA).scaled(**over)
    jp = jax.tree.map(lambda a: a[0], jl.g_mamba_init(jax.random.key(6), jcfg, 1))
    pp = {k: convert.pool_from_numpy(np.asarray(v)) for k, v in jp.items()}
    return jcfg, pcfg, jp, pp


def _x(cfg, seed, shape, dtype=np.float32):
    x = np.random.default_rng(seed).normal(size=shape + (cfg.d_model,)).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, cfg.compute_dtype))


def _jax_decode_loop(jp, jcfg, x):
    """The JAX ``mamba_apply`` in decode mode over each position of x from
    a zero state: (outputs (B, S, D), conv state, SSM state)."""
    Bx = x.shape[0]
    conv = jnp.zeros((Bx, jcfg.mamba_d_conv - 1, jcfg.d_inner), x.dtype)
    ssm = jnp.zeros((Bx, jcfg.d_inner, jcfg.mamba_d_state), jnp.float32)
    outs = []
    for t in range(x.shape[1]):
        o, (conv, ssm) = jl.mamba_apply(jp, x[:, t:t + 1], jcfg, state=(conv, ssm))
        outs.append(o)
    return jnp.concatenate(outs, axis=1), conv, ssm


@pytest.mark.parametrize("chunk", [1, 3, 5, 16, 64])
def test_mamba_full_sequence_matches_jax_at_every_chunk(chunk):
    """The chunked scan against the JAX associative scan, S = 16: chunks of
    one position, chunks that do not divide S (3, 5), one chunk of exactly
    S and one longer than S; the returned state against the JAX decode
    steps' from zeros."""
    jcfg, pcfg, jp, pp = _mamba_pair()
    jx, px = _x(jcfg, 16, (B, S))
    jout, jstate = jl.mamba_apply(jp, jx, jcfg)
    assert jstate is None
    pout, (conv, ssm) = pl_.mamba_apply(pp, px, pcfg, chunk=chunk)
    assert pout.shape == (B, S, jcfg.d_model) and ssm.dtype == torch.float32
    np.testing.assert_allclose(_np(pout), _np(jout), **TIGHT)
    _, jconv, jssm = _jax_decode_loop(jp, jcfg, jx)
    np.testing.assert_allclose(_np(conv), _np(jconv), **TIGHT)
    np.testing.assert_allclose(_np(ssm), _np(jssm), **TIGHT)


def test_mamba_default_chunk_is_stated():
    """The default chunk keeps one chunk's float32 (B, L, d_inner, d_state)
    array at 537 MB at Jamba's serving shape (B 4), a sixteenth of the
    whole 2,048-token sequence's."""
    cfg = configs.get_config(JAMBA)
    per_chunk = 4 * pl_.MAMBA_CHUNK * cfg.d_inner * cfg.mamba_d_state * 4
    assert pl_.MAMBA_CHUNK == 128 and per_chunk == 536_870_912
    assert 4 * 2048 * cfg.d_inner * cfg.mamba_d_state * 4 == 16 * per_chunk


@pytest.mark.parametrize("prompt", [1, 2, 16])
def test_mamba_state_from_a_prompt_then_a_decode_step(prompt):
    """The full-sequence mode over a prompt of 1, 2 or 16 positions (the
    conv state zero-padded when the prompt is shorter than d_conv - 1)
    leaves the conv and SSM states the JAX decode steps leave; the port's
    decode steps give the JAX ones; a decode step from the port's state
    equals the JAX step from the JAX state."""
    jcfg, pcfg, jp, pp = _mamba_pair()
    jx, px = _x(jcfg, 17 + prompt, (B, prompt + 1))
    jouts, jconv, jssm = _jax_decode_loop(jp, jcfg, jx[:, :prompt])
    pout, (conv, ssm) = pl_.mamba_apply(pp, px[:, :prompt], pcfg, chunk=3)
    np.testing.assert_allclose(_np(pout), _np(jouts), **TIGHT)
    np.testing.assert_allclose(_np(conv), _np(jconv), **TIGHT)
    np.testing.assert_allclose(_np(ssm), _np(jssm), **TIGHT)
    if prompt < jcfg.mamba_d_conv - 1:
        assert not bool(conv[:, :jcfg.mamba_d_conv - 1 - prompt].any())
    # the port's decode loop from zeros
    c = torch.zeros((B, pcfg.mamba_d_conv - 1, pcfg.d_inner))
    s = torch.zeros((B, pcfg.d_inner, pcfg.mamba_d_state))
    for t in range(prompt):
        o, (c, s) = pl_.mamba_apply(pp, px[:, t:t + 1], pcfg, state=(c, s))
        np.testing.assert_allclose(_np(o), _np(jouts[:, t:t + 1]), **TIGHT)
    np.testing.assert_allclose(_np(c), _np(jconv), **TIGHT)
    np.testing.assert_allclose(_np(s), _np(jssm), **TIGHT)
    # one more step from each side's state
    jo, (jc2, js2) = jl.mamba_apply(jp, jx[:, prompt:], jcfg, state=(jconv, jssm))
    po, (pc2, ps2) = pl_.mamba_apply(pp, px[:, prompt:], pcfg, state=(conv, ssm))
    for got, want in ((po, jo), (pc2, jc2), (ps2, js2)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), **TIGHT)


def test_mamba_decode_step_is_the_jax_line_on_a_random_state():
    """A decode step from a random (not zero) conv and SSM state."""
    jcfg, pcfg, jp, pp = _mamba_pair()
    rng = np.random.default_rng(18)
    conv = rng.normal(size=(B, jcfg.mamba_d_conv - 1, jcfg.d_inner)).astype(np.float32)
    ssm = rng.normal(size=(B, jcfg.d_inner, jcfg.mamba_d_state)).astype(np.float32)
    jx, px = _x(jcfg, 19, (B, 1))
    jo, (jc, js) = jl.mamba_apply(jp, jx, jcfg, state=(jnp.asarray(conv), jnp.asarray(ssm)))
    po, (pc, ps) = pl_.mamba_apply(pp, px, pcfg, state=(torch.from_numpy(conv),
                                                        torch.from_numpy(ssm)))
    for got, want in ((po, jo), (pc, jc), (ps, js)):
        np.testing.assert_allclose(_np(got), _np(want), **TIGHT)


@pytest.mark.parametrize("chunk", [5, 128])
def test_mamba_bf16_matches_jax(chunk):
    """bfloat16 parameters and activations, the scan in float32 (``A_log``
    and ``Dskip`` stay float32): the output in bfloat16 within 0.08."""
    jcfg, pcfg, jp, pp = _mamba_pair("bfloat16")
    assert pp["A_log"].dtype == pp["Dskip"].dtype == torch.float32
    assert pp["in_proj"].dtype == torch.bfloat16
    jx, px = _x(jcfg, 20, (B, S), jnp.bfloat16)
    jout, _ = jl.mamba_apply(jp, jx, jcfg)
    pout, (conv, ssm) = pl_.mamba_apply(pp, px, pcfg, chunk=chunk)
    assert pout.dtype == conv.dtype == torch.bfloat16 and ssm.dtype == torch.float32
    np.testing.assert_allclose(_np(pout), _np(jout), **BF16)


def test_mamba_gradients_match_jax():
    """Autograd through the chunked scan (no tensor written in place)
    against ``jax.grad`` of the JAX function: the input's and every
    parameter's gradient of a weighted sum of the output, within 1e-4
    relative to each gradient's largest value."""
    jcfg, pcfg, jp, pp = _mamba_pair()
    jx, px = _x(jcfg, 21, (B, S))
    w = np.random.default_rng(22).normal(size=(B, S, jcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        return (jl.mamba_apply(p, x, jcfg)[0] * w).sum()

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    leaves = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
    xx = px.clone().requires_grad_(True)
    out, _ = pl_.mamba_apply(leaves, xx, pcfg, chunk=5)
    (out * torch.from_numpy(w)).sum().backward()
    pairs = [("x", xx.grad, jgx)] + [(k, leaves[k].grad, jgp[k]) for k in pp]
    for name, got, want in pairs:
        want = _np(want)
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(_np(got) / scale, want / scale, rtol=0, atol=1e-4,
                                   err_msg=name)


# ------------------------------------------------------------ the config
def test_jamba_config_and_block_layout():
    cfg = configs.get_config(JAMBA)
    assert (cfg.num_layers, cfg.group_size, cfg.num_groups, cfg.d_model, cfg.d_inner,
            cfg.mamba_d_state, cfg.n_experts, cfg.top_k) == (72, 8, 9, 8192, 16384, 16, 16, 2)
    assert pt.layer_kinds(cfg)[:8] == ["attn"] + ["mamba"] * 7
    # MoE on the odd positions of a group: the Mamba blocks 1, 3, 5 and 7
    assert [pt._is_moe_layer(cfg, i) for i in range(8)] == [False, True] * 4
    assert cfg.subquadratic


def test_param_shapes_and_state_layout_match_jax():
    jcfg, pcfg = jconfigs.get_config(JAMBA).scaled(), configs.get_config(JAMBA).scaled()
    shapes = jax.eval_shape(lambda k: jm.init_model(k, jcfg), jax.random.key(0))
    tree = convert.params_from_model(
        pm.init_model(pcfg, generator=torch.Generator().manual_seed(3), device="cpu"), pcfg)
    want = {p: (s.shape, s.dtype.name) for p, s in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {p: (a.shape, "bfloat16" if a.dtype == np.uint16 else a.dtype.name)
           for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    assert got == want
    js = jm.init_decode_state(jcfg, B, MAX_LEN)
    ps = pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu")
    assert {k: (tuple(v.shape), v.dtype.name) for k, v in js.items()} == {
        k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in ps.items()}
    assert ps["b1_conv"].dtype == torch.bfloat16 and ps["b1_ssm"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_cross_both_ways_bit_for_bit(dtype):
    """Every leaf, the Mamba subtree's ``in_proj``, ``conv_w``, ``conv_b``,
    ``x_proj``, ``dt_proj``, ``dt_bias``, ``A_log``, ``Dskip`` and
    ``out_proj`` among them; the JAX ``A_log`` is a broadcast view, the
    port's copy is contiguous."""
    jcfg, pcfg, jp, pp = _pair(param_dtype=dtype, compute_dtype=dtype)
    mix = pp["layers"][1]["mix"]
    assert set(mix) == {"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
                        "A_log", "Dskip", "out_proj"}
    assert mix["A_log"].is_contiguous() and mix["A_log"].dtype == torch.float32
    back = convert.params_from_model(pp, pcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        a, b = _bits(a), flat_b[path]
        assert a.dtype == b.dtype and np.array_equal(a, b), path


# ------------------------------------------------------------- float32 lanes
def test_forward_and_aux_match_jax():
    jcfg, pcfg, jp, pp = _pair(**F32)
    toks = _tokens(jcfg)
    jlog, jaux = jm.forward(jp, jcfg, jnp.asarray(toks))
    plog, paux = pm.forward(pp, pcfg, _tok(toks))
    assert plog.shape == (B, S, jcfg.vocab_size)
    np.testing.assert_allclose(_np(plog), _np(jlog), **TIGHT)
    np.testing.assert_allclose(float(paux), float(jaux), **TIGHT)
    assert float(paux) > 0


def test_prefill_matches_jax_then_decodes_as_jax():
    """The one-forward fill's last logits and every state entry (``b0_k``,
    ``b0_v``, ``b{1..7}_conv``, ``b{1..7}_ssm``) against the JAX
    ``prefill`` (a scan of decode steps), then 4 decode steps on both."""
    jcfg, pcfg, jp, pp = _pair(**F32)
    toks = _tokens(jcfg, seed=3)
    jlast, js = jm.prefill(jp, jcfg, jnp.asarray(toks), jm.init_decode_state(jcfg, B, MAX_LEN))
    plast, ps = pm.prefill(pp, pcfg, _tok(toks),
                           pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu"))
    assert set(ps) == {"b0_k", "b0_v"} | {f"b{i}_{n}" for i in range(1, 8)
                                           for n in ("conv", "ssm")}
    np.testing.assert_allclose(_np(plast), _np(jlast), **TIGHT)
    _assert_state_close(js, ps, TIGHT)
    nxt = _tokens(jcfg, seed=4, shape=(B, 4))
    for t in range(4):
        jlog, js = jm.decode_step(jp, jcfg, js, jnp.asarray(nxt[:, t:t + 1]), jnp.int32(S + t))
        plog, ps = pm.decode_step(pp, pcfg, ps, _tok(nxt[:, t:t + 1]), S + t)
        np.testing.assert_allclose(_np(plog), _np(jlog), **TIGHT)
    _assert_state_close(js, ps, TIGHT)


@pytest.mark.parametrize("prompt", [1, 2, 16])
def test_prefill_from_one_forward_matches_decode_loop(prompt):
    """``prefill`` (one forward, the scan in chunks) against
    ``prefill_stepwise`` (one decode step a token) on prompts of 1, 2 and
    16 tokens: last logits and every state entry, then decoding on from
    either state."""
    _, pcfg, _, pp = _pair(**F32)
    toks = _tok(_tokens(pcfg, seed=6, shape=(B, prompt)))
    last, st = pm.prefill(pp, pcfg, toks, pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu"))
    olast, ost = pm.prefill_stepwise(pp, pcfg, toks,
                                     pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu"))
    np.testing.assert_allclose(_np(last), _np(olast), **TIGHT)
    _assert_state_close(ost, st, TIGHT)
    nxt = toks[:, :1]
    for t in range(prompt, prompt + 3):
        pl, st = pm.decode_step(pp, pcfg, st, nxt, t)
        ol, ost = pm.decode_step(pp, pcfg, ost, nxt, t)
        np.testing.assert_allclose(_np(pl), _np(ol), **TIGHT)
        nxt = ol[:, -1].argmax(-1, keepdim=True)
    _assert_state_close(ost, st, TIGHT)


def test_serve_fns_match_jax(host_mesh):
    """The serve fns against the JAX ones on the host mesh: the prefill fn
    (``forward``'s last position); decode steps against ``decode_step``
    without the mesh, since the JAX serve fns' decode of an MoE arch
    raises under jax 0.9 on the host mesh (``test_torch_models_moe_mla.py``)."""
    jcfg, pcfg, jp, pp = _pair(**F32)
    jf = jax_serve_fns(jcfg, host_mesh, B, MAX_LEN)
    pf = make_serve_fns(pcfg, B, MAX_LEN, device="cpu")
    toks = _tokens(jcfg, seed=7)
    np.testing.assert_allclose(_np(pf["prefill"](pp, _tok(toks))),
                               _np(jf["prefill"](jp, jnp.asarray(toks))), **TIGHT)
    set_mesh(None)
    js = jm.init_decode_state(jcfg, B, MAX_LEN)
    ps = pf["init_state"]()
    _assert_state_close(js, ps, TIGHT)
    for t in range(3):
        jlog, js = jm.decode_step(jp, jcfg, js, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        plog, ps = pf["decode"](pp, ps, _tok(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(plog), _np(jlog), **TIGHT)
    _assert_state_close(js, ps, TIGHT)


def _jax_routing(logits, K, C):
    """The routing lines of the JAX ``moe_apply`` on ``logits`` (N, E)."""
    N, E = logits.shape
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    _, topk_idx = jax.lax.top_k(probs, K)
    flat = jax.nn.one_hot(topk_idx, E, dtype=jnp.int32).reshape(N * K, E)
    pos = jnp.cumsum(flat, axis=0) - flat
    pos = (pos * flat).sum(-1).reshape(N, K)
    return np.asarray(topk_idx), np.asarray(pos), np.asarray(pos < C)


def test_moe_routing_on_the_mamba_layers_equals_jax(monkeypatch):
    """Every MoE layer of Jamba is a Mamba block's FFN; the routing the
    port's forward and fill take there (the router logits each layer
    sees) equals the JAX ``moe_apply``'s routing lines on the same logits:
    experts, slots and kept mask, exactly."""
    jcfg, pcfg, jp, pp = _pair(**F32)
    seen = []
    route = pl_.moe_route

    def recording(logits, K, C):
        out = route(logits, K, C)
        seen.append((logits.clone(), C, out))
        return out

    monkeypatch.setattr(pl_, "moe_route", recording)
    toks = _tok(_tokens(pcfg, seed=9))
    pm.forward(pp, pcfg, toks)
    n_moe = sum(pt._is_moe_layer(pcfg, i % pcfg.group_size) for i in range(pcfg.num_layers))
    kinds = pt.layer_kinds(pcfg)
    assert n_moe == 8 and all(kinds[i] == "mamba" for i in range(pcfg.num_layers)
                              if pt._is_moe_layer(pcfg, i % pcfg.group_size))
    assert len(seen) == n_moe
    pm.prefill(pp, pcfg, toks, pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu"))
    assert len(seen) == 2 * n_moe
    for logits, C, (_, _, picks, pos, keep) in seen:
        for g in range(logits.shape[0]):
            jidx, jpos, jkeep = _jax_routing(logits[g].numpy(), pcfg.top_k, C)
            np.testing.assert_array_equal(picks[g].numpy(), jidx)
            np.testing.assert_array_equal(pos[g].numpy(), jpos)
            np.testing.assert_array_equal(keep[g].numpy(), jkeep)


# ------------------------------------------------------------ bfloat16 lane
def _rel_l2(a, b) -> float:
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _f32(jp):
    return jax.tree.map(lambda a: a.astype(jnp.float32), jp)


def _picks(logits, K: int) -> np.ndarray:
    """The experts each token of router ``logits`` (N, E) picks, in
    ascending order: the top K probabilities, the lower expert first among
    equal ones (``jax.lax.top_k``)."""
    probs = torch.softmax(torch.as_tensor(np.array(logits, np.float32)), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :K]
    return torch.sort(idx, dim=-1).values.numpy()


def _record_routers(monkeypatch) -> tuple:
    """From here on, the router logits (N, E) of every MoE call of both
    packages, in call order: (JAX's, the port's). JAX's are taken by a
    debug callback on the JAX function's own router product, since its
    groups run under ``jax.lax.scan``."""
    jseen, pseen = [], []
    jmoe, proute = jl.moe_apply, pl_.moe_route

    def jax_recording(p, x, cfg, capacity_factor=1.25):
        logits = jnp.einsum("nd,de->ne", x.reshape(-1, x.shape[-1]),
                            p["router"]).astype(jnp.float32)
        jax.debug.callback(lambda a: jseen.append(np.asarray(a)), logits)
        return jmoe(p, x, cfg, capacity_factor)

    def recording(logits, K, C):
        pseen.append(logits.reshape(-1, logits.shape[-1]).clone())
        return proute(logits, K, C)

    monkeypatch.setattr(jl, "moe_apply", jax_recording)
    monkeypatch.setattr(pl_, "moe_route", recording)
    return jseen, pseen


def _routed_otherwise(jseen, pseen, K: int) -> list:
    """For each MoE call, whether each token's picks differ between the
    packages, (N,) bool."""
    assert len(jseen) == len(pseen)
    return [(_picks(j, K) != _picks(p, K)).any(-1) for j, p in zip(jseen, pseen)]


def test_bf16_forward_matches_jax(monkeypatch):
    """The bfloat16 forward of the 16 layers against the JAX one. Both
    packages' router logits are recorded (``_record_routers``); the
    positions the two route to other experts in some MoE layer must be
    rare (at most one in eight). In each row, every position before the
    first such one within 0.08 element by element; from there on the Mamba
    state carries that token's other experts to every later position of
    its row, so the whole of the logits is held by relative L2: within
    0.08 of the JAX bfloat16 logits, and no farther than twice the JAX
    bfloat16 forward's distance from the float32 forward on the same
    weights."""
    jcfg, pcfg, jp, pp = _pair()
    assert pcfg.param_dtype == pcfg.compute_dtype == "bfloat16"
    toks = _tokens(jcfg, seed=5)
    j32, _ = jm.forward(_f32(jp), jconfigs.get_config(JAMBA).scaled(**F32), jnp.asarray(toks))
    jseen, pseen = _record_routers(monkeypatch)
    jlog, _ = jm.forward(jp, jcfg, jnp.asarray(toks))
    plog, _ = pm.forward(pp, pcfg, _tok(toks))
    assert plog.dtype == torch.bfloat16
    n_moe = sum(pt._is_moe_layer(pcfg, i % pcfg.group_size) for i in range(pcfg.num_layers))
    assert len(pseen) == n_moe
    otherwise = {divmod(n, S) for differs in _routed_otherwise(jseen, pseen, pcfg.top_k)
                 for n in np.nonzero(differs)[0].tolist()}
    assert len(otherwise) <= B * S // 8, otherwise
    got, want = _np(plog), _np(jlog)
    for b in range(B):
        first = min([s for row, s in otherwise if row == b], default=S)
        np.testing.assert_allclose(got[b, :first], want[b, :first], **BF16,
                                   err_msg=f"row {b} before position {first}")
    assert _rel_l2(plog, jlog) <= 0.08
    assert _rel_l2(plog, j32) <= 2 * _rel_l2(jlog, j32)


def test_bf16_prefill_and_decode_match_jax(monkeypatch):
    """The bfloat16 fill (routed position by position, as decode steps
    route) against the JAX ``prefill``: last logits and every state entry
    within 0.08 element by element; then 4 decode steps, routed alike by
    the two packages in every MoE layer (``_record_routers``), each step's
    logits within 0.08 relative L2 of the JAX step's and no farther than
    twice the JAX bfloat16 step's distance from the float32 step. Element
    by element at 0.08 the steps' logits are below the bfloat16 floor
    here: the fills' SSM states differ between the packages about as much
    as JAX's own bfloat16 and float32 fills do, and the JAX bfloat16 steps
    themselves leave 0.08 of its float32 steps (PERF.md, section 5)."""
    jcfg, pcfg, jp, pp = _pair()
    jcfg32 = jconfigs.get_config(JAMBA).scaled(**F32)
    jp32 = _f32(jp)
    toks = _tokens(jcfg, seed=5)
    jlast, js = jm.prefill(jp, jcfg, jnp.asarray(toks), jm.init_decode_state(jcfg, B, MAX_LEN))
    plast, ps = pm.prefill(pp, pcfg, _tok(toks),
                           pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu"))
    np.testing.assert_allclose(_np(plast), _np(jlast), **BF16)
    _assert_state_close(js, ps, BF16)
    _, js32 = jm.prefill(jp32, jcfg32, jnp.asarray(toks), jm.init_decode_state(jcfg32, B, MAX_LEN))
    steps32 = []
    for t in range(4):
        j32, js32 = jm.decode_step(jp32, jcfg32, js32, jnp.asarray(toks[:, t:t + 1]),
                                   jnp.int32(S + t))
        steps32.append(j32)
    jseen, pseen = _record_routers(monkeypatch)
    for t in range(4):
        tok = toks[:, t:t + 1]
        jl_, js = jm.decode_step(jp, jcfg, js, jnp.asarray(tok), jnp.int32(S + t))
        pl, ps = pm.decode_step(pp, pcfg, ps, _tok(tok), S + t)
        assert _rel_l2(pl, jl_) <= 0.08, t
        assert _rel_l2(pl, steps32[t]) <= 2 * _rel_l2(jl_, steps32[t]), t
    assert len(pseen) == 4 * sum(pt._is_moe_layer(pcfg, i % pcfg.group_size)
                                 for i in range(pcfg.num_layers))
    assert not any(d.any() for d in _routed_otherwise(jseen, pseen, pcfg.top_k))


def test_jamba_config_equals_jax_scaled_and_published():
    assert asdict(configs.get_config(JAMBA)) == asdict(jconfigs.get_config(JAMBA))
    assert asdict(configs.get_config(JAMBA).scaled(**F32)) == asdict(
        jconfigs.get_config(JAMBA).scaled(**F32))
