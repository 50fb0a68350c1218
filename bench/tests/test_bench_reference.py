"""The plain reference against ``repro_torch`` at a tiny size on the CPU,
in float32: the parameters, the logits of a sequence, and three training
steps (loss, gradient norm, each leaf's first gradient and change)."""

from dataclasses import replace

import pytest
import torch

from bench.harness import program, weights
from bench.reference import model as ref_model
from bench.reference.arch import Arch
from bench.tests import tiny

CPU = torch.device("cpu")
# the benchmark's configurations, and Qwen3 with an untied head as well
NAMES = ["qwen3-1.7b", "deepseek-moe-16b-l8", "qwen3-1.7b:untied"]


def f32(name):
    config = tiny.config(name.split(":")[0])
    if name.endswith(":untied"):
        config["tie_word_embeddings"] = False
    cfg = replace(program.model_config(config), param_dtype="float32", compute_dtype="float32")
    return config, cfg, Arch.from_config(config)


@pytest.mark.parametrize("name", NAMES)
def test_leaves_are_the_programs(name):
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim.adamw import leaves

    config, cfg, arch = f32(name)
    tree = param_shapes(program.model_config(config))
    ours = weights.to_tree({n: torch.empty(s, device="meta") for n, s, _ in arch.leaves()})
    assert [t.shape for t in leaves(tree)] == [t.shape for t in leaves(ours)]
    assert sum(t.numel() for t in leaves(tree)) == arch.n_params()


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_the_program(name):
    from repro_torch.models.transformer import forward

    config, cfg, arch = f32(name)
    W = weights.make(arch, 5, CPU, dtype=torch.float32)
    tokens = torch.randint(0, arch.vocab, (1, 40), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = forward(weights.to_tree(W), cfg, tokens)
    got = ref_model.Model(arch, W).logits_at(tokens[0], torch.arange(40))
    torch.testing.assert_close(got, want[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_training_steps_match_the_program(name):
    from repro_torch.launch.train import make_train_fns

    config, cfg, arch = f32(name)
    mix = tiny.mix("train-2k")
    aux = program.aux_weight(mix, config)
    fns = make_train_fns(cfg, lr=mix["lr"], total_steps=mix["total_steps"], warmup=mix["warmup"],
                         remat="full", aux_weight=aux, device=CPU)
    W = weights.make(arch, 9, CPU, dtype=torch.float32)
    W0 = {n: t.clone() for n, t in W.items()}
    P = {n: t.clone().requires_grad_(True) for n, t in W.items()}
    m = {n: torch.zeros_like(t) for n, t in W.items()}
    v = {n: torch.zeros_like(t) for n, t in W.items()}
    params = weights.to_tree(P)
    opt = {"m": weights.to_tree(m), "v": weights.to_tree(v), "step": torch.zeros((), dtype=torch.int32)}
    gen = torch.Generator().manual_seed(2)
    batches = []
    for _ in range(3):
        t = torch.randint(0, arch.vocab, (4, 17), generator=gen)
        batches.append((t[:, :-1], t[:, 1:]))
    losses, norms = [], []
    for i, (tok, lab) in enumerate(batches):
        params, opt, out = fns["step"](params, opt, {"tokens": tok, "labels": lab})
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
        if i == 0:
            g1 = {n: float(t.norm()) / (1 - mix["adamw"]["b1"]) for n, t in m.items()}
    ref = ref_model.train(arch, W, batches, mix, aux)
    assert ref["loss"] == pytest.approx(losses, rel=1e-5)
    assert ref["grad_norm"] == pytest.approx(norms, rel=1e-4)
    for n in g1:
        assert ref["grad_leaf"][n] == pytest.approx(g1[n], rel=1e-3, abs=1e-7)
        assert float((W[n] - W0[n]).norm()) == pytest.approx(
            float((P[n].detach() - W0[n]).norm()), rel=1e-3, abs=1e-7)


def test_recomputed_update_is_the_held_one():
    config, cfg, arch = f32("deepseek-moe-16b-l8")
    mix = tiny.mix("train-2k")
    gen = torch.Generator().manual_seed(4)
    t = torch.randint(0, arch.vocab, (2, 9), generator=gen)
    batches = [(t[:, :-1], t[:, 1:])] * 2
    W1 = weights.make(arch, 1, CPU)
    W2 = weights.make(arch, 1, CPU)
    a = ref_model.train(arch, W1, batches, mix, 0.001, keep_grads=True)
    b = ref_model.train(arch, W2, batches, mix, 0.001, keep_grads=False)
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    assert all(torch.equal(W1[n], W2[n]) for n in W1)


def test_attention_gradient_is_autograds():
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 2500, 2, 2, 16, generator=gen, dtype=torch.float64).float().requires_grad_()
    k = torch.randn(2, 2500, 2, 16, generator=gen).requires_grad_()
    v = torch.randn(2, 2500, 2, 16, generator=gen).requires_grad_()
    do = torch.randn(2, 2500, 2, 2, 16, generator=gen)
    o = ref_model.CausalAttention.apply(q, k, v)
    o.backward(do)
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    s = torch.einsum("bsgrd,btgd->bgrst", q, k) / 4.0
    s = s.masked_fill(torch.ones(2500, 2500, dtype=torch.bool).triu(1), float("-inf"))
    want_o = torch.einsum("bgrst,btgd->bsgrd", torch.softmax(s, -1), v)
    torch.testing.assert_close(o, want_o, rtol=1e-4, atol=1e-5)
    want_o.backward(do)
    for g, t in zip(got, (q, k, v)):
        torch.testing.assert_close(g, t.grad, rtol=1e-4, atol=1e-4)


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.linspace(-3, 3, 1001)
    y = ref_model.fp8_round(x, per_row=False)
    assert (y - x).abs().max() <= 3 * 2 ** -4 * 3 / 2 ** 0 + 1e-6
    assert (y - x).abs().max() > 0
    assert len(torch.unique(y)) < 256
