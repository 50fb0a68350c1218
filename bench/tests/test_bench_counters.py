"""The program's MoE counters (``repro_torch.obs``) against the plain
reference at a tiny size on the CPU, in float32: under remat "full" each
layer's picks past capacity in the first step are the reference's
``dropped``, counted once (not again by the recompute)."""

from dataclasses import replace

import pytest
import torch

from bench.harness import program, weights
from bench.reference import model as ref_model
from bench.reference.arch import Arch
from bench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture
def tracing():
    from repro_torch import obs

    obs.reset()
    obs.enable()
    yield obs
    obs.disable()
    obs.reset()


@pytest.mark.parametrize("seed", [3, 11])
def test_dropped_picks_are_the_references_layer_by_layer(tracing, seed):
    from repro_torch.launch.train import make_train_fns

    config = tiny.config("deepseek-moe-16b-l8")
    cfg = replace(program.model_config(config), param_dtype="float32", compute_dtype="float32")
    arch = Arch.from_config(config)
    mix = tiny.mix("train-2k")
    aux = program.aux_weight(mix, config)
    fns = make_train_fns(cfg, lr=mix["lr"], total_steps=mix["total_steps"], warmup=mix["warmup"],
                         remat="full", aux_weight=aux, device=CPU)
    W = weights.make(arch, seed, CPU, dtype=torch.float32)
    P = {n: t.clone().requires_grad_(True) for n, t in W.items()}
    zeros = {n: torch.zeros_like(t) for n, t in W.items()}
    opt = {"m": weights.to_tree(zeros), "v": weights.to_tree({n: t.clone() for n, t in
                                                              zeros.items()}),
           "step": torch.zeros((), dtype=torch.int32)}
    t = torch.randint(0, arch.vocab, (mix["batch"], mix["seq_len"] + 1),
                      generator=torch.Generator().manual_seed(seed))
    fns["step"](weights.to_tree(P), opt, {"tokens": t[:, :-1], "labels": t[:, 1:]})
    got = tracing.counters()
    layers = arch.layers
    assert [len(v) for v in got.values()] == [layers] * 3  # once a layer, not twice
    dropped = [p - k for p, k in zip(got["moe.picks"], got["moe.kept"])]
    ref = ref_model.train(arch, W, [(t[:, :-1], t[:, 1:])], mix, aux)
    assert dropped == ref["dropped"]
    assert sum(dropped) > 0
    N = mix["batch"] * mix["seq_len"]
    assert got["moe.picks"] == [N * arch.top_k] * layers
    assert all(s >= k for s, k in zip(got["moe.slots"], got["moe.kept"]))
