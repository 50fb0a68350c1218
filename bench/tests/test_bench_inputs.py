"""Inputs and weights come from the seed: the same seed gives the same
inputs, and the decode check's sequences cover every group of slots."""

import math
from types import SimpleNamespace

import pytest
import torch

from bench.harness import spec, weights
from bench.kinds import decode, train
from bench.reference.arch import Arch
from bench.tests import tiny

CPU = torch.device("cpu")


def ctx(cell: str, seed: int):
    entry = spec.cell(spec.load(), cell)
    config = tiny.config(entry["config"])
    return SimpleNamespace(config=config, mix=tiny.mix(entry["traffic"]),
                           arch=Arch.from_config(config), seed=seed, device=CPU)


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 3 * 2**32 + 1])
def test_train_batches_repeat_and_differ(seed):
    a, b = train._batches(ctx("qwen3-1.7b.train-4k", seed)), train._batches(
        ctx("qwen3-1.7b.train-4k", seed))
    first = [next(a) for _ in range(3)]
    again = [next(b) for _ in range(3)]
    for x, y in zip(first, again):
        assert torch.equal(x["tokens"], y["tokens"]) and torch.equal(x["labels"], y["labels"])
    assert torch.equal(first[0]["tokens"][:, 1:], first[0]["labels"][:, :-1])
    rows = torch.cat([f["tokens"] for f in first])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    other = next(train._batches(ctx("qwen3-1.7b.train-4k", seed + 1)))
    assert not torch.equal(other["tokens"], first[0]["tokens"])


@pytest.mark.parametrize("seed", [1, 2**31 + 1, 3 * 2**32 + 7])
def test_decode_checks_one_sequence_a_group_of_slots(seed):
    mix = spec.mix("decode-32k")
    B, n = mix["batch"], mix["checked_sequences"]
    slots = decode.checked_slots(B, n, seed)
    assert slots == decode.checked_slots(B, n, seed)
    assert [s // (B // n) for s in slots] == list(range(n))
    drawn = {tuple(decode.checked_slots(B, n, seed + k)) for k in range(8)}
    assert len(drawn) > 1


@pytest.mark.parametrize("name", ["qwen3-1.7b", "deepseek-moe-16b-l8"])
def test_weights_repeat_and_chunks_draw_alone(name):
    arch = Arch.from_config(tiny.config(name))
    w1, w2 = weights.make(arch, 11, CPU), weights.make(arch, 11, CPU)
    assert list(w1) == [n for n, _, _ in arch.leaves()]
    assert all(torch.equal(w1[n], w2[n]) for n in w1)
    for i in range(len(weights.chunks(arch))):
        for n, t in weights.draw_chunk(arch, 11, i, CPU).items():
            assert torch.equal(t, w1[n])
    w3 = weights.make(arch, 12, CPU)
    assert not torch.equal(w1["embed"], w3["embed"])
    assert all(w1[n].dtype == torch.bfloat16 for n in w1)


def test_chunks_cover_every_matrix_once():
    arch = Arch.from_config(spec.config(spec.load(), "qwen3-1.7b"))
    names = [n for group in weights.chunks(arch) for n, _, _ in group]
    assert sorted(names) == sorted(n for n, _, f in arch.leaves() if f is not None)
    assert all(sum(math.prod(s) for _, s, _ in g) <= weights.CHUNK or len(g) == 1
               for g in weights.chunks(arch))


def test_tree_follows_the_names():
    arch = Arch.from_config(tiny.config("deepseek-moe-16b-l8"))
    flat = weights.make(arch, 3, CPU)
    tree = weights.to_tree(flat)
    assert tree["layers"][1]["ffn"]["shared"]["w2"] is flat["layers.1.ffn.shared.w2"]
    assert tree["final_norm"]["scale"] is flat["final_norm.scale"]
    assert len(tree["layers"]) == arch.layers
