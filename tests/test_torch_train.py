"""The port's training path against the JAX package's, on the CPU: AdamW,
the schedule and the clip on identical gradients; the loss and gradients
of the ``.scaled()`` Qwen3 and RWKV6 models for each ``remat`` with the
JAX weights crossed by ``convert``; the trainer's losses step by step; the
port's own resume, bit for bit, also against a run with a failure injected;
and the depth cuts and memory reckoning of ``chip_smoke.py``'s phase 14.

Tolerances:

* AdamW: float32, rtol 1e-6 plus an absolute 1e-6 of each leaf's largest
  value: the same float32 arithmetic in the same order, apart from
  ``b ** step`` and the square root, which XLA and PyTorch may round an ulp
  apart; a parameter that ``p - lr * u`` brings near zero keeps that ulp
  of the leaf's scale (measured: 1.9e-9 on a leaf of 0.04).
* loss and gradients: float32, 1e-4 of each leaf's largest gradient (the
  two frameworks sum in other orders; measured differences ~1e-6 of it).
* trainer losses over 12 steps: float32 weights, absolute 5e-4 on losses
  of about 6.6 (measured 4e-5: Adam carries the step-one rounding
  differences forward). The tiny config is ``tests/test_trainer_e2e.py``'s
  in float32, where bfloat16 rounding at other points would hide a wrong
  term.
"""

import importlib.util
from dataclasses import replace
from pathlib import Path

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
from repro.launch.trainer import train as jax_train
from repro.optim import adamw as jax_adamw
from repro.optim import cosine_schedule as jax_cosine
from repro.optim import global_norm as jax_global_norm
from repro_torch import configs, convert
from repro_torch.checkpoint import save_checkpoint
from repro_torch.launch import train_lm
from repro_torch.launch.train import cross_entropy, make_train_fns, width_scaled_lr
from repro_torch.launch.trainer import train
from repro_torch.models import param_count
from repro_torch.optim import adamw, cosine_schedule, global_norm
from repro_torch.optim.adamw import leaves

F32 = dict(param_dtype="float32", compute_dtype="float32")
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=512)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# ---------------------------------------------------------------- optimizer
def _grad_trees(rng, steps):
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2)}}
    return [jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32) * scale, shapes,
                         is_leaf=lambda s: isinstance(s, tuple))
            for scale in np.geomspace(0.01, 100.0, steps)]


def _torch_tree(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree, np.float32)).to(dtype)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1.0, None])
def test_adamw_matches_the_jax_update(state_dtype, clip_norm):
    rng = np.random.default_rng(0)
    grads = _grad_trees(rng, 6)  # norms from ~0.05 to ~500: the clip bites late
    params0 = jax.tree.map(lambda g: rng.normal(size=g.shape).astype(np.float32), grads[0])
    jopt = jax_adamw(lr=jax_cosine(0.1, warmup=2, total=10), clip_norm=clip_norm,
                     state_dtype=getattr(jnp, state_dtype))
    popt = adamw(lr=cosine_schedule(0.1, warmup=2, total=10), clip_norm=clip_norm,
                 state_dtype=getattr(torch, state_dtype))
    jp = jax.tree.map(jnp.asarray, params0)
    js = jopt.init(jp)
    pp = _torch_tree(params0)
    ps = popt.init(pp)
    for g in grads:
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        pp, ps = popt.update(_torch_tree(g), ps, pp)
        for key, got, want in [("params", pp, jp), ("m", ps["m"], js["m"]),
                               ("v", ps["v"], js["v"])]:
            for a, b in zip(leaves(got), jax.tree.leaves(want)):
                assert str(a.dtype).split(".")[-1] == str(b.dtype), key
                b = np.asarray(b, np.float32)
                np.testing.assert_allclose(a.float().numpy(), b, rtol=1e-6,
                                           atol=1e-6 * float(np.abs(b).max()), err_msg=key)
        assert int(ps["step"]) == int(js["step"])


def test_update_in_place_equals_update_and_leaves_inputs_alone():
    rng = np.random.default_rng(1)
    g = _torch_tree(_grad_trees(rng, 1)[0])
    params = _torch_tree(jax.tree.map(lambda a: a + 1.0, _np(_grad_trees(rng, 1)[0])))
    opt = adamw(lr=0.05)
    state = opt.init(params)
    before = [t.clone() for t in leaves(params)]
    new_p, new_s = opt.update(g, state, params)
    assert all(torch.equal(a, b) for a, b in zip(leaves(params), before))
    opt.update_(g, state, params)
    assert all(torch.equal(a, b) for a, b in zip(leaves(params), leaves(new_p)))
    assert int(state["step"]) == int(new_s["step"]) == 1


@pytest.mark.parametrize("step", [0, 1, 5, 10, 50, 99, 100, 150])
def test_cosine_schedule_is_the_jax_float32_schedule(step):
    got = cosine_schedule(3e-4, warmup=10, total=100)(step)
    assert got.dtype == torch.float32
    assert float(got) == float(jax_cosine(3e-4, warmup=10, total=100)(step))


def test_global_norm_and_cross_entropy_match():
    rng = np.random.default_rng(2)
    tree = {"x": rng.normal(size=(7, 3)).astype(np.float32), "y": rng.normal(size=5).astype(np.float32)}
    np.testing.assert_allclose(float(global_norm(_torch_tree(tree))),
                               float(jax_global_norm(tree)), rtol=1e-6)
    logits = (rng.normal(size=(2, 9, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    np.testing.assert_allclose(float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))),
                               float(jax_cross_entropy(logits, labels)), rtol=1e-6)
    assert width_scaled_lr(64) == pytest.approx(0.05) and width_scaled_lr(2048) == 3e-4


def test_opt_state_crosses_both_ways():
    cfg_j = jconfigs.get_config("qwen3-1.7b").scaled(**TINY)
    cfg_p = configs.get_config("qwen3-1.7b").scaled(**TINY)
    _, state = jax_train_fns(cfg_j, make_host_mesh(), opt_state_dtype=jnp.bfloat16)["init"](
        jax.random.key(0))
    state = jax.tree.map(lambda a: np.asarray(a) + np.asarray(1, a.dtype), state)
    port = convert.opt_state_from_jax(state, cfg_p)
    assert port["m"]["layers"][1]["mix"]["w_q"].dtype == torch.bfloat16
    assert int(port["step"]) == 1
    back = convert.opt_state_to_jax(port, cfg_p)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(state), jax.tree.leaves(back)):
        a = np.asarray(a)
        np.testing.assert_array_equal(a.view(np.uint16) if a.dtype.name == "bfloat16" else a,
                                      b, err_msg=str(path))


# ------------------------------------------------------------ model gradients
def _model_pair(name):
    jcfg = jconfigs.get_config(name).scaled(**F32)
    pcfg = configs.get_config(name).scaled(**F32)
    jp = jm.init_model(jax.random.key(0), jcfg)
    pp = convert.model_params_from_jax(_np(jp), pcfg)
    return jcfg, pcfg, jp, pp


@pytest.mark.parametrize("name", ["qwen3-1.7b", "rwkv6-3b"])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_gradients_match_the_jax_loss_fn(name, remat):
    jcfg, pcfg, jp, pp = _model_pair(name)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)}

    def jloss(p):
        logits, aux = jm.forward(p, jcfg, batch["tokens"], remat=remat)
        return jax_cross_entropy(logits, batch["labels"]) + 0.01 * aux

    jl, jg = jax.value_and_grad(jloss)(jp)
    for p in leaves(pp):
        p.requires_grad_(True)
    loss = make_train_fns(pcfg, remat=remat, device="cpu")["loss"](pp, batch)
    grads = torch.autograd.grad(loss, leaves(pp))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = convert.model_params_from_jax(_np(jg), pcfg)
    for g, w in zip(grads, leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * max(float(w.abs().max()), 1e-6))


def test_remat_policies_give_the_same_gradients_bit_for_bit():
    _, pcfg, _, pp = _model_pair("qwen3-1.7b")
    batch = {"tokens": np.arange(32).reshape(2, 16) % pcfg.vocab_size,
             "labels": (np.arange(32).reshape(2, 16) * 7) % pcfg.vocab_size}
    for p in leaves(pp):
        p.requires_grad_(True)
    out = {}
    for remat in ("none", "full", "dots"):
        loss = make_train_fns(pcfg, remat=remat, device="cpu")["loss"](pp, batch)
        out[remat] = torch.autograd.grad(loss, leaves(pp))
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(out["none"], out[remat])), remat
    with pytest.raises(ValueError, match="remat"):
        make_train_fns(pcfg, remat="everything", device="cpu")["loss"](pp, batch)


def test_a_step_that_raises_leaves_params_and_state_alone():
    pcfg = configs.get_config("qwen3-1.7b").scaled(**TINY)
    fns = make_train_fns(pcfg, device="cpu")
    params, state = fns["init"](torch.Generator().manual_seed(0))
    before = [t.detach().clone() for t in leaves(params) + leaves(state)]
    bad = {"tokens": np.zeros((2, 8), np.int32),
           "labels": np.full((2, 8), pcfg.vocab_size + 5, np.int32)}  # out of range
    with pytest.raises((RuntimeError, IndexError)):
        fns["step"](params, state, bad)
    assert all(torch.equal(a, b) for a, b in zip(leaves(params) + leaves(state), before))
    good = {"tokens": np.zeros((2, 8), np.int32), "labels": np.ones((2, 8), np.int32)}
    _, state, metrics = fns["step"](params, state, good)
    assert int(metrics["step"]) == 1 and np.isfinite(float(metrics["loss"]))


# ----------------------------------------------------------------- trainer
@pytest.fixture(scope="module")
def tiny_f32():
    return (jconfigs.get_config("qwen3-1.7b").scaled(**TINY, **F32),
            configs.get_config("qwen3-1.7b").scaled(**TINY, **F32))


def test_twelve_steps_match_the_jax_trainer(tiny_f32, tmp_path):
    """The JAX trainer from seed 0, and the port's resumed from a step-0
    checkpoint holding the same initial weights (the two packages draw
    other numbers from one seed), with a failure injected at step 5 in
    both."""
    jcfg, pcfg = tiny_f32
    mesh = make_host_mesh()
    want = jax_train(jcfg, mesh, steps=12, global_batch=4, seq_len=32, inject_failure_at=5)
    p0, o0 = jax_train_fns(jcfg, mesh)["init"](jax.random.key(0))
    save_checkpoint(tmp_path, 0, {
        "params": convert.model_params_from_jax(jax.tree.map(np.asarray, p0), pcfg),
        "opt": convert.opt_state_from_jax(jax.tree.map(np.asarray, o0), pcfg),
    })
    got = train(pcfg, steps=12, global_batch=4, seq_len=32, ckpt_dir=tmp_path,
                ckpt_every=100, inject_failure_at=5, device="cpu")
    assert got.resumed_from == 0 and len(got.losses) == 12
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=5e-4)


def test_resume_is_bit_exact(tiny_f32, tmp_path):
    _, pcfg = tiny_f32
    full = train(pcfg, steps=12, global_batch=4, seq_len=32, device="cpu")
    train(pcfg, steps=8, global_batch=4, seq_len=32, ckpt_dir=tmp_path, ckpt_every=8,
          device="cpu")
    resumed = train(pcfg, steps=12, global_batch=4, seq_len=32, ckpt_dir=tmp_path,
                    ckpt_every=100, device="cpu")
    assert resumed.resumed_from == 8
    assert resumed.losses == full.losses[8:]
    assert len(full.step_times) == 12 and all(t > 0 for t in full.step_times)


def test_an_injected_failure_leaves_the_losses_a_resume_gives(tmp_path):
    """What phase 14's full-depth resume check in ``chip_smoke.py`` relies
    on: a run with a failure injected at step 2 (the retry path, as its
    uninterrupted run (a) has it) gives from step 2 on the losses of the
    same run checkpointed at step 2 and resumed there, bit for bit, in
    bfloat16 with remat="full" as on the card."""
    cfg = configs.get_config("qwen3-1.7b").scaled(**TINY)
    kw = dict(global_batch=4, seq_len=32, remat="full", seed=3, device="cpu")
    uninterrupted = train(cfg, steps=5, inject_failure_at=2, **kw)
    train(cfg, steps=2, ckpt_dir=tmp_path, ckpt_every=2, **kw)
    resumed = train(cfg, steps=5, ckpt_dir=tmp_path, ckpt_every=100, **kw)
    assert resumed.resumed_from == 2 and len(uninterrupted.losses) == 5
    assert resumed.losses == uninterrupted.losses[2:]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name, layers, state, params", [
    ("deepseek-moe-16b", 8, "float32", 5_122_328_576),
    ("chatglm3-6b", 28, "bfloat16", 6_243_584_000),
    ("qwen2-72b", 4, "bfloat16", 6_002_163_712),
])
def test_phase14_depth_cuts_and_memory_reckoning(smoke, name, layers, state, params):
    """``chip_smoke.family_cfg`` applies an arch's ``layers`` cut of
    ``FAMILY_RUNS`` and nothing else, and ``train_state_bytes`` is
    ``param_count`` x the bytes a parameter takes: 2 + 2 for bfloat16
    weights and gradients, 2 x 4 or 2 x 2 for AdamW's m and v."""
    run = smoke.FAMILY_RUNS[name]
    assert run.get("layers", layers) == layers and run.get("state", "float32") == state
    cfg = smoke.family_cfg(name)
    assert cfg == replace(configs.get_config(name), num_layers=layers)
    n = param_count(make_train_fns(cfg, device="cpu")["param_shapes"])
    assert n == params
    assert smoke.train_state_bytes(cfg, state) == n * (4 + 2 * {"float32": 4, "bfloat16": 2}[state])


def test_train_lm_runs_on_the_cpu(capsys):
    assert train_lm.main(["--device", "cpu", "--steps", "12", "--layers", "2",
                          "--d-model", "64", "--seq", "32", "--batch", "4"]) == 0
    out = capsys.readouterr().out
    assert "retry exercised" in out and "ok." in out
