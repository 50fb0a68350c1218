"""Training the MoE, MLA, remaining dense, encoder-decoder, VLM and hybrid
archs: the port's loss, gradients and one whole step against the JAX
package's at ``.scaled()`` size in float32, on the CPU, with the JAX
parameters carried across by ``convert.model_params_from_jax`` and the same
numpy tokens, labels, frames (Whisper) and patch embeddings (InternVL2).

* the loss and every gradient against ``jax.value_and_grad`` of the JAX
  ``loss_fn`` (``repro/launch/train.py:69-78``, with ``extra_embeds=`` and
  ``frames=`` from the batch): the loss at rtol 1e-5, each gradient within
  1e-4 of its largest value (``tests/test_torch_train.py``'s tolerances:
  the two frameworks sum in other orders);
* one port ``step`` against the JAX package's own ``make_train_fns(cfg,
  make_host_mesh())["step"]`` under ``jax.jit``: the loss at rtol 1e-5; the
  AdamW moments within the gradients' tolerance (``m`` is 0.1 g after one
  step, ``v`` 0.05 g^2, so 2e-4 of its largest value); the parameters
  within 2 lr of each other, as a first Adam step moves each weight by lr
  times about its gradient's sign (the sign of a gradient that is rounding
  noise may differ), and their update within 1e-3 relative L2;
* ``remat`` ``none``, ``dots`` and ``full`` on the port: the same loss and
  gradients bit for bit.

MoE routing: a near-tie at a router's top-K cut (the K-th and (K+1)-th
logits within NEAR_TIE_ULPS float32 ulps) could make the two packages
pick other experts, and the loss and gradients then differ by more than
summation order; ``_near_ties`` records every cut of the port's forward
and the tests fail with the positions if any is that close, rather than
compare across it.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jm
from repro.launch.mesh import make_host_mesh
from repro.launch.train import cross_entropy as jax_cross_entropy
from repro.launch.train import make_train_fns as jax_train_fns
from repro_torch import configs, convert
from repro_torch.launch.train import make_train_fns
from repro_torch.models import layers as pl_
from repro_torch.optim.adamw import leaves

ARCHS = ["deepseek-moe-16b", "granite-moe-1b-a400m", "minicpm3-4b", "chatglm3-6b",
         "qwen2-72b", "whisper-small", "internvl2-1b", "jamba-1.5-large-398b"]
F32 = dict(param_dtype="float32", compute_dtype="float32")
B, S = 2, 16
AUX_WEIGHT = 0.01  # make_train_fns' default in both packages
LR1 = 3e-4 / 200  # the first step's lr: both packages' default peak and warm-up
NEAR_TIE_ULPS = 4


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(jax cfg, port cfg, jax params, jax batch, port batch) of ``name``
    at .scaled() float32 size: tokens and labels (B, S), and the arch's
    frontend input, (B, frontend_len, D) normal draws, as ``frames`` or
    ``patches``; every array from one numpy seed."""
    jcfg = jconfigs.get_config(name).scaled(**F32)
    pcfg = configs.get_config(name).scaled(**F32)
    jp = jm.init_model(jax.random.key(0), jcfg)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)}
    if jcfg.frontend != "none":
        key = "frames" if jcfg.has_encoder else "patches"
        batch[key] = rng.normal(size=(B, jcfg.frontend_len, jcfg.d_model)).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    return jcfg, pcfg, jp, jbatch, batch


def _port_params(name):
    jcfg, pcfg, jp, _, _ = _case(name)
    pp = convert.model_params_from_jax(jax.tree.map(np.asarray, jp), pcfg)
    for p in leaves(pp):
        p.requires_grad_(True)
    return pp


def _jax_loss(jcfg):
    """The JAX ``loss_fn`` of ``make_train_fns`` (``repro/launch/
    train.py:69-78``), which that function does not return."""
    def loss_fn(params, batch):
        logits, aux = jm.forward(params, jcfg, batch["tokens"],
                                 extra_embeds=batch.get("patches"),
                                 frames=batch.get("frames"))
        return jax_cross_entropy(logits, batch["labels"]) + AUX_WEIGHT * aux
    return loss_fn


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(name):
    jcfg, _, jp, jbatch, _ = _case(name)
    return jax.jit(jax.value_and_grad(_jax_loss(jcfg)))(jp, jbatch)


def _near_ties(logits_by_layer, K: int) -> list:
    """The (layer, token) cuts of recorded router logits (G, N, E) whose
    K-th and (K+1)-th values lie within NEAR_TIE_ULPS float32 ulps."""
    near = []
    for i, logits in enumerate(logits_by_layer):
        v = logits.reshape(-1, logits.shape[-1]).sort(dim=-1, descending=True).values
        a, b = v[:, K - 1].double(), v[:, K].double()
        ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(a.abs(), b.abs()).clamp_min(
            2.0 ** -126))) - 23)
        near += [(i, n) for n in torch.nonzero(a - b <= NEAR_TIE_ULPS * ulp).flatten().tolist()]
    return near


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads(name, remat):
    """The port's loss and gradients (``make_train_fns``' ``loss`` under
    autograd), with every router's logits of the forward recorded."""
    _, pcfg, _, _, batch = _case(name)
    pp = _port_params(name)
    seen, route = [], pl_.moe_route

    def recording(logits, K, C):
        seen.append(logits.detach().clone())
        return route(logits, K, C)

    pl_.moe_route = recording
    try:
        loss = make_train_fns(pcfg, remat=remat, device="cpu")["loss"](pp, batch)
        grads = torch.autograd.grad(loss, leaves(pp))
    finally:
        pl_.moe_route = route
    return loss.detach(), grads, seen


def _assert_routing_clear(name, seen):
    pcfg = _case(name)[1]
    if pcfg.n_experts:
        assert seen, "an MoE arch's forward routed nothing"
        near = _near_ties(seen, pcfg.top_k)
        assert not near, f"router cuts within {NEAR_TIE_ULPS} float32 ulps: {near}"


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_gradients_match_jax(name):
    _, pcfg, _, _, _ = _case(name)
    jl, jg = _jax_value_and_grad(name)
    loss, grads, seen = _port_loss_and_grads(name, "none")
    _assert_routing_clear(name, seen)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = convert.model_params_from_jax(jax.tree.map(np.asarray, jg), pcfg)
    assert len(grads) == len(leaves(want))
    for g, w in zip(grads, leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * max(float(w.abs().max()), 1e-6))


@pytest.mark.parametrize("name", ARCHS)
def test_one_step_matches_the_jax_step(name):
    jcfg, pcfg, jp, jbatch, batch = _case(name)
    jfns = jax_train_fns(jcfg, make_host_mesh())
    jo = jfns["init"](jax.random.key(0))[1]
    jnew, jstate, jmetrics = jax.jit(jfns["step"])(jp, jo, jbatch)
    pp = _port_params(name)
    po = convert.opt_state_from_jax(jax.tree.map(np.asarray, jo), pcfg)
    before = [p.detach().clone() for p in leaves(pp)]
    pnew, pstate, pmetrics = make_train_fns(pcfg, device="cpu")["step"](pp, po, batch)
    np.testing.assert_allclose(float(pmetrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    assert int(pstate["step"]) == int(jstate["step"]) == 1
    for key, got, want in (("m", pstate["m"], jstate["m"]), ("v", pstate["v"], jstate["v"])):
        want = convert.model_params_from_jax(jax.tree.map(np.asarray, want), pcfg)
        tol = 1e-4 if key == "m" else 2e-4
        for a, b in zip(leaves(got), leaves(want)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                       atol=tol * max(float(b.abs().max()), 1e-12), err_msg=key)
    want = leaves(convert.model_params_from_jax(jax.tree.map(np.asarray, jnew), pcfg))
    num = den = 0.0
    for a, b, p0 in zip(leaves(pnew), want, before):
        a = a.detach()
        assert float((a - b).abs().max()) <= 2 * LR1 * 1.01
        num += float(((a - b).double() ** 2).sum())
        den += float(((b - p0).double() ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= 1e-3


@pytest.mark.parametrize("name", ["chatglm3-6b", "qwen2-72b"])
def test_one_step_with_bfloat16_state_matches_the_jax_step(name):
    """One step of ``make_train_fns(opt_state_dtype=torch.bfloat16)``, the
    AdamW state phase 14 of ``chip_smoke.py`` gives ChatGLM3-6B and
    Qwen2-72B, against the JAX step with ``opt_state_dtype=jnp.bfloat16``
    at float32 weights. Both round ``m`` and ``v`` to bfloat16 after
    computing them in float32, from gradients that differ by the two
    frameworks' summation orders, so an element near a rounding boundary
    may round to the neighbouring bfloat16 value: ``m`` and ``v`` within
    one bfloat16 ulp of the element (2^-7 relative) plus the float32 step's
    tolerances (1e-4 and 2e-4 of the leaf's largest value). The new weights
    as in the float32 step: within 2 lr of each other (an ulp of ``m`` or
    ``v`` moves an update by under 1% of lr) and their update within 1e-3
    relative L2."""
    jcfg, pcfg, jp, jbatch, batch = _case(name)
    jfns = jax_train_fns(jcfg, make_host_mesh(), opt_state_dtype=jnp.bfloat16)
    jo = jfns["init"](jax.random.key(0))[1]
    jnew, jstate, jmetrics = jax.jit(jfns["step"])(jp, jo, jbatch)
    pp = _port_params(name)
    po = convert.opt_state_from_jax(jax.tree.map(np.asarray, jo), pcfg)
    before = [p.detach().clone() for p in leaves(pp)]
    fns = make_train_fns(pcfg, opt_state_dtype=torch.bfloat16, device="cpu")
    pnew, pstate, pmetrics = fns["step"](pp, po, batch)
    np.testing.assert_allclose(float(pmetrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    assert int(pstate["step"]) == int(jstate["step"]) == 1
    for key, tol in (("m", 1e-4), ("v", 2e-4)):
        want = leaves(convert.model_params_from_jax(jax.tree.map(np.asarray, jstate[key]), pcfg))
        got = leaves(pstate[key])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == torch.bfloat16, key
            np.testing.assert_allclose(_np(a), _np(b), rtol=2.0 ** -7,
                                       atol=tol * max(float(b.float().abs().max()), 1e-12),
                                       err_msg=key)
    want = leaves(convert.model_params_from_jax(jax.tree.map(np.asarray, jnew), pcfg))
    num = den = 0.0
    for a, b, p0 in zip(leaves(pnew), want, before):
        a = a.detach()
        assert a.dtype == b.dtype == torch.float32
        assert float((a - b).abs().max()) <= 2 * LR1 * 1.01
        num += float(((a - b).double() ** 2).sum())
        den += float(((b - p0).double() ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= 1e-3


@pytest.mark.parametrize("name", ARCHS)
def test_remat_modes_give_the_same_gradients_bit_for_bit(name):
    loss, grads, seen = _port_loss_and_grads(name, "none")
    for remat in ("dots", "full"):
        loss_m, grads_m, seen_m = _port_loss_and_grads(name, remat)
        assert torch.equal(loss_m, loss), remat
        assert all(torch.equal(a, b) for a, b in zip(grads_m, grads)), remat
        # the backward recomputes each group (the last first), and each MoE
        # layer routes on the forward's router logits again
        assert len(seen_m) == 2 * len(seen), remat
        assert all(any(torch.equal(r, f) for f in seen) for r in seen_m[len(seen):]), remat


def test_the_step_passes_frames_and_patches_to_forward():
    """The port's train step used to keep only tokens and labels: Whisper's
    loss raised ``enc-dec model requires frames`` and InternVL2's dropped
    the patches without a word. Now Whisper's loss is the JAX loss_fn's,
    and InternVL2's with patches is the JAX loss_fn's and differs from
    the loss without them."""
    losses = {}
    for name in ("whisper-small", "internvl2-1b"):
        jcfg, pcfg, jp, jbatch, batch = _case(name)
        loss = make_train_fns(pcfg, device="cpu")["loss"]
        pp = _port_params(name)
        with torch.no_grad():
            losses[name] = float(loss(pp, batch))
            if name == "internvl2-1b":
                text_only = {k: v for k, v in batch.items() if k != "patches"}
                without = float(loss(pp, text_only))
        np.testing.assert_allclose(losses[name], float(jax.jit(_jax_loss(jcfg))(jp, jbatch)),
                                   rtol=1e-5)
    assert abs(without - losses["internvl2-1b"]) > 1e-3 * abs(losses["internvl2-1b"])


@pytest.mark.parametrize("chunk", [1, 5, 16, 40])
def test_mamba_scan_gradient_is_autograd_of_the_loop(chunk):
    """``MambaScan`` keeps only the h entering each chunk and recomputes a
    chunk at a time in its backward; its values and gradients (of y and of
    the last h) are autograd's through the chunked loop, bit for bit, at
    chunks of one position, that do not divide S, that do and longer
    than S."""
    rng = np.random.default_rng(chunk)
    Bx, Sx, DI, DS = 2, 37, 6, 4

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    dt = torch.nn.functional.softplus(draw(Bx, Sx, DI))
    ins = (dt, dt * draw(Bx, Sx, DI), draw(Bx, Sx, DS), draw(Bx, Sx, DS),
           -torch.exp(draw(DI, DS)))
    wy, wh = draw(Bx, Sx, DI), draw(Bx, DI, DS)
    out = []
    for scan in (pl_.MambaScan.apply, pl_._mamba_scan):
        leaves_ = [t.clone().requires_grad_(True) for t in ins]
        y, h = scan(*leaves_, chunk)
        out.append((y.detach(), h.detach(),
                    torch.autograd.grad((y * wy).sum() + (h * wh).sum(), leaves_)))
    (y, h, g), (y0, h0, g0) = out
    assert torch.equal(y, y0) and torch.equal(h, h0)
    assert all(torch.equal(a, b) for a, b in zip(g, g0))


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_adamw_in_slices_gives_the_whole_leaf_bits(state_dtype, monkeypatch):
    """``update_`` cuts each leaf into flat slices of ``CHUNK`` elements
    (one() makes a dozen float32 temporaries of what it is given); the
    parameters and both moments after three steps are those of the whole
    leaf at once, bit for bit, a transposed (non-contiguous) gradient
    included."""
    adamw_module = sys.modules["repro_torch.optim.adamw"]
    rng = np.random.default_rng(8)
    params = {"w": torch.from_numpy(rng.normal(size=(300, 37)).astype(np.float32)),
              "t": torch.from_numpy(rng.normal(size=(50, 70)).astype(np.float32))}
    grads = {"w": torch.from_numpy(rng.normal(size=(300, 37)).astype(np.float32)),
             "t": torch.from_numpy(rng.normal(size=(70, 50)).astype(np.float32)).T}
    out = []
    for chunk in (None, 1000):
        monkeypatch.setitem(adamw_module.CHUNK, "cpu", chunk)
        opt = adamw_module.adamw(lr=1e-2, state_dtype=state_dtype)
        p = {k: v.clone() for k, v in params.items()}
        state = opt.init(p)
        for _ in range(3):
            opt.update_(grads, state, p)
        out.append(leaves(p) + leaves(state["m"]) + leaves(state["v"]))
    assert all(torch.equal(a, b) for a, b in zip(*out))
