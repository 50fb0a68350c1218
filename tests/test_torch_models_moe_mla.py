"""The port's MoE (DeepSeekMoE-16B, Granite-MoE-1B), MLA (MiniCPM3-4B) and
remaining dense (ChatGLM3-6B, Qwen2-72B) architectures against the JAX
package at ``.scaled()`` size, on the CPU, with the JAX parameters carried
across by ``convert.model_params_from_jax`` and the same numpy tokens.

Tolerances, as in ``test_torch_models.py``: rtol = atol = 1e-4 in float32
(the two packages sum in other orders; the logits differ by about 1e-6)
and 0.08 in bfloat16 (the JAX smoke test's bound for decode against
forward). MoE routing is compared exactly: the top-k experts, each pick's
slot in its expert's buffer and the kept mask.

The routing reference is the JAX ``moe_apply``'s own lines
(``repro/models/layers.py:378-387``: ``jax.lax.top_k`` of the softmax,
then the one-hot cumsum), run with JAX on the same router logits, because
the JAX function returns only its output and aux loss; those are compared
too.

A decode step's MoE routes the batch's B tokens with the capacity of B
tokens, and the JAX ``prefill`` fills the state by decode steps. So for an
MoE arch the state fill's last logits are the decode loop's and differ
from ``forward``'s last position (capacity over all B * S tokens) in both
packages; ``test_fill_last_logits_against_forward`` states it.
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
from repro.models import transformer as jt
from repro_torch import configs, convert
from repro_torch import models as pm
from repro_torch.launch.serve import make_serve_fns
from repro_torch.models import layers as pl_
from repro_torch.models import transformer as pt

ARCHS = ["deepseek-moe-16b", "granite-moe-1b-a400m", "minicpm3-4b", "chatglm3-6b",
         "qwen2-72b"]
MOE = ["deepseek-moe-16b", "granite-moe-1b-a400m"]
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


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_state_close(jstate, pstate, tol):
    assert set(jstate) == set(pstate)
    for key in jstate:
        assert tuple(jstate[key].shape) == tuple(pstate[key].shape), key
        np.testing.assert_allclose(_np(pstate[key]), _np(jstate[key]), **tol, err_msg=key)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.fixture
def host_mesh():
    mesh = make_host_mesh()
    yield mesh
    set_mesh(None)  # make_serve_fns sets the JAX package's ambient mesh


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", ARCHS)
def test_configs_are_copies(name):
    assert name in configs.PORTED_ARCHS
    assert asdict(configs.get_config(name)) == asdict(jconfigs.get_config(name))
    assert asdict(configs.get_config(name).scaled(**F32)) == asdict(
        jconfigs.get_config(name).scaled(**F32))


@pytest.mark.parametrize("name", configs.PORTED_ARCHS)
def test_active_params_and_flops_match_jax(name):
    """At the published sizes, from shapes alone (meta tensors in the port,
    ``jax.eval_shape`` in the JAX package)."""
    jcfg, pcfg = jconfigs.get_config(name), configs.get_config(name)
    want = jt.active_param_count_shapes(jcfg)
    assert pt.active_param_count_shapes(pcfg) == want
    shapes = pt.param_shapes(pcfg)
    jshapes = jax.eval_shape(lambda k: jm.init_model(k, jcfg), jax.random.key(0))
    assert pt.active_param_count(shapes, pcfg) == jt.active_param_count(jshapes, jcfg)
    assert pt.model_flops(shapes, pcfg, 8192) == jt.model_flops(jshapes, jcfg, 8192)
    assert pm.param_count(shapes) == jm.param_count(jshapes)
    if pcfg.n_experts:
        assert pt.active_param_count(shapes, pcfg) < pm.param_count(shapes)


# ------------------------------------------------------------------- params
@pytest.mark.parametrize("name", ARCHS)
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
    if jcfg.n_shared_experts:
        assert set(pp["layers"][0]["ffn"]["shared"]) == {"w1", "w3", "w2"}


@pytest.mark.parametrize("name", MOE + ["minicpm3-4b"])
def test_optimizer_state_crosses_with_nested_leaves(name):
    jcfg, pcfg, jp, pp = _pair(name, **F32)
    rng = np.random.default_rng(9)
    m = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), jp)
    v = jax.tree.map(lambda a: rng.random(size=a.shape).astype(np.float32), jp)
    state = {"m": m, "v": v, "step": np.asarray(3, np.int32)}
    back = convert.opt_state_to_jax(convert.opt_state_from_jax(state, pcfg), pcfg)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, a in jax.tree_util.tree_leaves_with_path(state):
        assert np.array_equal(np.asarray(a), flat[path]), path


@pytest.mark.parametrize("name", ARCHS)
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
    # dense weights: normal / sqrt(fan_in); experts' fan-in is D (axis 1)
    w = pp["layers"][0]["ffn"]["we1"] if pcfg.n_experts else pp["embed"]
    assert abs(float(w.float().std()) * np.sqrt(pcfg.d_model) - 1.0) < 0.05


# ------------------------------------------------------------- float32 lanes
@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_aux_match_jax(name):
    jcfg, pcfg, jp, pp = _pair(name, **F32)
    toks = _tokens(jcfg)
    jlog, jaux = jm.forward(jp, jcfg, jnp.asarray(toks))
    plog, paux = pm.forward(pp, pcfg, torch.from_numpy(toks).long())
    assert plog.shape == (B, S, jcfg.vocab_size) and paux.dtype == torch.float32
    np.testing.assert_allclose(_np(plog), _np(jlog), **TIGHT)
    np.testing.assert_allclose(float(paux), float(jaux), **TIGHT)
    assert (float(paux) > 0) == bool(jcfg.n_experts)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_match_jax(name):
    jcfg, pcfg, jp, pp = _pair(name, **F32)
    toks = _tokens(jcfg, seed=2, shape=(B, 4))
    js = jm.init_decode_state(jcfg, B, MAX_LEN)
    ps = pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu")
    _assert_state_close(js, ps, TIGHT)
    for t in range(toks.shape[1]):
        jlog, js = jm.decode_step(jp, jcfg, js, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        plog, ps = pm.decode_step(pp, pcfg, ps, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        np.testing.assert_allclose(_np(plog), _np(jlog), **TIGHT)
    _assert_state_close(js, ps, TIGHT)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_jax(name):
    """The JAX ``prefill`` fills by decode steps, so its MoE layers route
    with a capacity per position; the port's one-forward fill must too."""
    jcfg, pcfg, jp, pp = _pair(name, **F32)
    toks = _tokens(jcfg, seed=3)
    jlast, js = jm.prefill(jp, jcfg, jnp.asarray(toks), jm.init_decode_state(jcfg, B, MAX_LEN))
    plast, ps = pm.prefill(pp, pcfg, torch.from_numpy(toks).long(),
                           pm.init_decode_state(pcfg, B, MAX_LEN, device="cpu"))
    assert plast.shape == (B, 1, jcfg.vocab_size)
    np.testing.assert_allclose(_np(plast), _np(jlast), **TIGHT)
    _assert_state_close(js, ps, TIGHT)


@pytest.mark.parametrize("name", ARCHS)
def test_fill_last_logits_against_forward(name):
    """For a dense or MLA arch the fill's last logits are ``forward``'s last
    position; for an MoE arch they are not (capacity of B tokens per
    position against B * S tokens), in the JAX package as in the port."""
    jcfg, pcfg, jp, pp = _pair(name, **F32)
    toks = _tokens(jcfg, seed=8)
    plast, _ = pm.prefill(pp, pcfg, torch.from_numpy(toks).long(),
                          pm.init_decode_state(pcfg, B, S, device="cpu"))
    plog, _ = pm.forward(pp, pcfg, torch.from_numpy(toks).long())
    jlast, _ = jm.prefill(jp, jcfg, jnp.asarray(toks), jm.init_decode_state(jcfg, B, S))
    jlog, _ = jm.forward(jp, jcfg, jnp.asarray(toks))
    same_port = np.allclose(_np(plast[:, 0]), _np(plog[:, -1]), **TIGHT)
    same_jax = np.allclose(_np(jlast[:, 0]), _np(jlog[:, -1]), **TIGHT)
    assert same_port == same_jax == (not jcfg.n_experts)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_from_one_forward_matches_decode_loop(name):
    """``prefill`` writes the state from one forward; ``prefill_stepwise``
    (one decode step a token) is its oracle: logits and every state entry
    within 1e-4 in float32, and decoding on from either state agrees."""
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


@pytest.mark.parametrize("name", ARCHS)
def test_serve_fns_match_jax(name, host_mesh):
    """The serve fns against the JAX ones on the host mesh. For an MoE arch
    the JAX decode fn raises under jax 0.9 on that mesh (``moe_apply``'s
    gather of the token rows meets the data-sharded output of the
    context-parallel decode attention, a ``ShardingTypeError``), so its
    decode steps are held against its body, ``decode_step``, without the
    mesh."""
    jcfg, pcfg, jp, pp = _pair(name, **F32)
    jf = jax_serve_fns(jcfg, host_mesh, B, MAX_LEN)
    pf = make_serve_fns(pcfg, B, MAX_LEN, device="cpu")
    toks = _tokens(jcfg, seed=4)
    np.testing.assert_allclose(_np(pf["prefill"](pp, torch.from_numpy(toks).long())),
                               _np(jf["prefill"](jp, jnp.asarray(toks))), **TIGHT)
    jdecode = jf["decode"]
    if jcfg.n_experts:
        set_mesh(None)

        def jdecode(p, st, tok, t):
            return jm.decode_step(p, jcfg, st, tok, t)
    js = jm.init_decode_state(jcfg, B, MAX_LEN)
    ps = pf["init_state"]()
    _assert_state_close(js, ps, TIGHT)
    for t in range(3):
        jlog, js = jdecode(jp, js, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        plog, ps = pf["decode"](pp, ps, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        np.testing.assert_allclose(_np(plog), _np(jlog), **TIGHT)
    _assert_state_close(js, ps, TIGHT)


# ------------------------------------------------------------ bfloat16 lane
NEAR_TIE_ULPS = 4


def _near_tie_positions(logits_by_layer, K: int, S: int) -> set:
    """The (b, s) positions whose top-K cut in some MoE layer of a forward
    (router logits (1, B * S, E), bfloat16 values) lies within
    NEAR_TIE_ULPS bfloat16 ulps: the K-th and (K+1)-th logits that close.
    The two packages round the residual stream to bfloat16 at other points
    (the JAX forward is one fused XLA program), so their router logits
    differ by an ulp or two, and at such a cut they may pick other
    experts."""
    near = set()
    for logits in logits_by_layer:
        v = logits[0].sort(dim=-1, descending=True).values.double()
        a, b = v[:, K - 1], v[:, K]
        ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(a.abs(), b.abs()).clamp_min(
            2.0 ** -126))) - 7)
        for n in torch.nonzero(a - b <= NEAR_TIE_ULPS * ulp).flatten().tolist():
            near.add(divmod(n, S))
    return near


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_forward_and_prefill_match_jax(name, monkeypatch):
    """The bfloat16 forward within the BF16 tolerance at every position,
    except, for an MoE arch, a position whose routing in the port's own
    forward sits at a near-tie (``_near_tie_positions``): there the two
    packages may pick other experts, and its logits are not compared.
    Such positions must be few (at most one in eight). The state fill
    (positions routed one at a time) at the BF16 tolerance throughout."""
    jcfg, pcfg, jp, pp = _pair(name)
    assert pcfg.param_dtype == pcfg.compute_dtype == "bfloat16"
    toks = _tokens(jcfg, seed=5)
    jlog, _ = jm.forward(jp, jcfg, jnp.asarray(toks))
    seen = []
    route = pl_.moe_route

    def recording(logits, K, C):
        seen.append(logits.clone())
        return route(logits, K, C)

    monkeypatch.setattr(pl_, "moe_route", recording)
    plog, _ = pm.forward(pp, pcfg, torch.from_numpy(toks).long())
    monkeypatch.setattr(pl_, "moe_route", route)
    assert plog.dtype == torch.bfloat16
    assert len(seen) == (pcfg.num_layers if pcfg.n_experts else 0)
    near = _near_tie_positions(seen, pcfg.top_k, S)
    assert len(near) <= B * S // 8, near
    got, want = _np(plog), _np(jlog)
    for b in range(B):
        for s in range(S):
            if (b, s) not in near:
                np.testing.assert_allclose(got[b, s], want[b, s], **BF16,
                                           err_msg=f"position {(b, s)}")
    jlast, js = jm.prefill(jp, jcfg, jnp.asarray(toks), jm.init_decode_state(jcfg, B, S))
    plast, ps = pm.prefill(pp, pcfg, torch.from_numpy(toks).long(),
                           pm.init_decode_state(pcfg, B, S, device="cpu"))
    np.testing.assert_allclose(_np(plast), _np(jlast), **BF16)
    _assert_state_close(js, ps, BF16)


# ---------------------------------------------------------------- MoE alone
def _jax_routing(logits, K, C):
    """The routing lines of the JAX ``moe_apply`` on ``logits`` (N, E)."""
    N, E = logits.shape
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    gate_vals, topk_idx = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.clip(gate_vals.sum(-1, keepdims=True), 1e-9)
    flat = jax.nn.one_hot(topk_idx, E, dtype=jnp.int32).reshape(N * K, E)
    pos = jnp.cumsum(flat, axis=0) - flat
    pos = (pos * flat).sum(-1).reshape(N, K)
    return (np.asarray(gate_vals), np.asarray(topk_idx), np.asarray(pos),
            np.asarray(pos < C))


def _port_routing(logits, K, C):
    _, gates, picks, pos, keep = pl_.moe_route(torch.from_numpy(logits)[None], K, C)
    return gates[0].numpy(), picks[0].numpy(), pos[0].numpy(), keep[0].numpy()


def _assert_same_routing(logits, K, C):
    jg, jidx, jpos, jkeep = _jax_routing(logits, K, C)
    pg, pidx, ppos, pkeep = _port_routing(logits, K, C)
    np.testing.assert_array_equal(pidx, jidx)
    np.testing.assert_array_equal(ppos, jpos)
    np.testing.assert_array_equal(pkeep, jkeep)
    np.testing.assert_allclose(pg, jg, rtol=1e-6, atol=1e-7)
    return pidx, ppos, pkeep


@pytest.mark.parametrize("case", ["normal", "small_integers", "zero", "pressure"])
def test_routing_equals_jax_exactly(case):
    """The top-k experts, slots and kept mask at DeepSeekMoE-16B's E = 64,
    K = 6 over 4,096 tokens: normal logits; small integers (ties in most
    rows, as bfloat16 router logits give); a zero router (every
    probability equal: every token picks experts 0..K-1 and the picks of
    token C and later are dropped); and capacity pressure (C below N K /
    E, by a capacity factor of 0.5)."""
    N, E, K = 4096, 64, 6
    rng = np.random.default_rng(11)
    factor = 0.5 if case == "pressure" else 1.25
    C = max(1, int(factor * N * K / E))
    logits = {"normal": rng.normal(size=(N, E)),
              "small_integers": rng.integers(0, 4, size=(N, E)),
              "zero": np.zeros((N, E)),
              "pressure": rng.normal(size=(N, E)) + np.linspace(0, 2, E)}[case]
    idx, pos, keep = _assert_same_routing(logits.astype(np.float32), K, C)
    if case == "zero":
        assert (idx == np.arange(K)).all()
        np.testing.assert_array_equal(pos, np.broadcast_to(np.arange(N)[:, None], (N, K)))
        assert keep[:C].all() and not keep[C:].any()
    if case == "pressure":
        assert N * K / E > C and not keep.all()
    if case == "small_integers":
        top = np.sort(logits, axis=1)[:, ::-1]
        assert (top[:, K - 1] == top[:, K]).mean() > 0.5  # ties at the cut


def _moe_pair(name, **overrides):
    jcfg = jconfigs.get_config(name).scaled(**F32, **overrides)
    pcfg = configs.get_config(name).scaled(**F32, **overrides)
    jp = jax.tree.map(lambda a: a[0], jl.g_moe_init(jax.random.key(4), jcfg, 1))
    pp = jax.tree.map(lambda a: _t(a), jp)
    return jcfg, pcfg, jp, pp


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("case", ["random", "zero_router", "pressure"])
def test_moe_apply_matches_jax(name, case):
    """``moe_apply`` alone, output and aux loss within 1e-4 and routing
    exact: at the model's capacity, with a zero router (ties everywhere:
    experts 0..K-1, picks beyond C dropped) and under capacity pressure
    (factor 0.5)."""
    jcfg, pcfg, jp, pp = _moe_pair(name)
    if case == "zero_router":
        jp = {**jp, "router": jnp.zeros_like(jp["router"])}
        pp = {**pp, "router": torch.zeros_like(pp["router"])}
    factor = 0.5 if case == "pressure" else 1.25
    x = np.random.default_rng(12).normal(size=(4, 16, jcfg.d_model)).astype(np.float32)
    jout, jaux = jl.moe_apply(jp, jnp.asarray(x), jcfg, capacity_factor=factor)
    pout, paux = pl_.moe_apply(pp, torch.from_numpy(x), pcfg, capacity_factor=factor)
    np.testing.assert_allclose(_np(pout), _np(jout), **TIGHT)
    np.testing.assert_allclose(float(paux), float(jaux), **TIGHT)
    N = x.shape[0] * x.shape[1]
    C = pl_.moe_capacity(N, pcfg, factor)
    assert C == max(1, int(factor * N * jcfg.top_k / jcfg.n_experts))
    logits = (x.reshape(N, -1) @ np.asarray(jp["router"])).astype(np.float32)
    idx, _, keep = _assert_same_routing(logits, jcfg.top_k, C)
    if case == "zero_router":
        assert (idx == np.arange(jcfg.top_k)).all() and keep[:C].all() and not keep[C:].any()
    if case == "pressure":
        assert not keep.all()


@pytest.mark.parametrize("name", MOE)
def test_moe_per_position_is_the_decode_steps(name):
    """The fill's MoE (each position's B tokens a group, capacity of B
    tokens) equals the JAX ``moe_apply`` called on each position alone."""
    jcfg, pcfg, jp, pp = _moe_pair(name)
    x = np.random.default_rng(13).normal(size=(4, 6, jcfg.d_model)).astype(np.float32)
    pout, _ = pl_.moe_apply(pp, torch.from_numpy(x), pcfg, per_position=True)
    for s in range(x.shape[1]):
        jout, _ = jl.moe_apply(jp, jnp.asarray(x[:, s:s + 1]), jcfg)
        np.testing.assert_allclose(_np(pout[:, s:s + 1]), _np(jout), **TIGHT)


# ---------------------------------------------------------------- MLA alone
def _mla_pair():
    jcfg = jconfigs.get_config("minicpm3-4b").scaled(**F32)
    pcfg = configs.get_config("minicpm3-4b").scaled(**F32)
    jp = jax.tree.map(lambda a: a[0], jl.g_mla_init(jax.random.key(5), jcfg, 1))
    return jcfg, pcfg, jp, jax.tree.map(_t, jp)


def test_mla_apply_matches_jax():
    jcfg, pcfg, jp, pp = _mla_pair()
    x = np.random.default_rng(14).normal(size=(2, 12, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12))
    jout, (jckv, jkr) = jl.mla_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    rope = pl_.rope_tables(torch.from_numpy(pos.copy()), pcfg)
    assert rope[0].shape[-1] == pcfg.qk_rope_dim // 2 != pcfg.head_dim // 2
    pout, (pckv, pkr) = pl_.mla_apply(pp, torch.from_numpy(x), pcfg, rope)
    for got, want in ((pout, jout), (pckv, jckv), (pkr, jkr)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), **TIGHT)


@pytest.mark.parametrize("cur_len", [0, 5, 11])
def test_mla_decode_matches_jax(cur_len):
    jcfg, pcfg, jp, pp = _mla_pair()
    rng = np.random.default_rng(15 + cur_len)
    x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(2, 12, jcfg.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(2, 12, jcfg.qk_rope_dim)).astype(np.float32)
    ckv[:, cur_len:] = 0
    kr[:, cur_len:] = 0
    jout, jckv, jkr = jl.mla_decode(jp, jnp.asarray(x), jcfg, jnp.asarray(ckv),
                                    jnp.asarray(kr), jnp.int32(cur_len))
    rope = pl_.rope_tables(torch.full((2, 1), cur_len), pcfg)
    pckv, pkr = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    pout = pl_.mla_decode(pp, torch.from_numpy(x), pcfg, pckv, pkr, cur_len, rope)
    np.testing.assert_allclose(_np(pout), _np(jout), **TIGHT)
    np.testing.assert_allclose(_np(pckv), _np(jckv), **TIGHT)
    np.testing.assert_allclose(_np(pkr), _np(jkr), **TIGHT)
