"""The frozen counts against hand counts at the cells' shapes."""

import pytest

from bench.counts import flops
from bench.harness import spec
from bench.reference.arch import Arch

B = spec.load()
QWEN = Arch.from_config(spec.config(B, "qwen3-1.7b"))
DSM = Arch.from_config(spec.config(B, "deepseek-moe-16b-l8"))


def test_parameters_by_hand():
    # Qwen3-1.7B: q 2048x2048, k and v 2048x1024, o 2048x2048, MLP 3 x 2048x6144
    layer = 2048 * 2048 * 2 + 2048 * 1024 * 2 + 3 * 2048 * 6144
    assert flops.layer_active_params(QWEN) == 28 * layer == 1_409_286_144
    assert flops.head_params(QWEN) == 2048 * 151_936
    assert QWEN.n_params() == 1_720_574_976  # head tied to the embedding, norms included
    assert "lm_head" not in [n for n, _, _ in QWEN.leaves()]
    # DeepSeekMoE-16B: MHA 4 x 2048x2048; router 2048x64; 6 routed + 2 shared
    # experts of 3 x 2048x1408 a token
    layer = 4 * 2048 * 2048 + 2048 * 64 + 8 * 3 * 2048 * 1408
    assert flops.layer_active_params(DSM) == 8 * layer == 688_914_432
    assert flops.head_params(DSM) == 2048 * 102_400
    assert DSM.n_params() == 5_122_328_576


def test_train_step_by_hand():
    # 6 N D plus 12 hd H per visible pair per layer
    pairs = 4 * 2048 * 2049 // 2
    want = 6 * (688_914_432 + 209_715_200) * 4 * 2048 + 12 * 128 * 16 * 8 * pairs
    assert flops.train_step_flops(DSM, 4, 2048) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(45.8195e12, rel=1e-5)
    pairs = 4 * 4096 * 4097 // 2
    want = 6 * (1_409_286_144 + 311_164_928) * 4 * 4096 + 12 * 128 * 16 * 28 * pairs
    assert flops.train_step_flops(QWEN, 4, 4096) == pytest.approx(want, rel=1e-12)


def test_published_keys_and_the_ports_departures():
    config = spec.config(B, "deepseek-moe-16b-l8")
    assert config["first_k_dense_replace"] == 1 and config["norm_topk_prob"] is False
    # the reference follows what the port runs: every layer MoE, gates renormalised
    assert DSM.first_dense == 0 and DSM.norm_topk and all(DSM.is_moe(i) for i in range(8))
    assert QWEN.tied and not DSM.tied


def test_decode_step_by_hand():
    ctx = 31_744
    f = 2 * (1_409_286_144 + 311_164_928) * 16 + 4 * 128 * 16 * 28 * 16 * (ctx + 1)
    assert flops.decode_step_flops(QWEN, 16, ctx) == pytest.approx(f, rel=1e-12)
    weights = 1_409_286_144 + 28 * 2 * 2048 + 311_164_928 + 2048 + 16 * 2048
    kv = 16 * 28 * 2 * 8 * 128 * (ctx + 1)
    nbytes = 2 * (weights + kv + 16 * 151_936)
    assert flops.decode_step_bytes(QWEN, 16, ctx) == pytest.approx(nbytes, rel=1e-12)
    assert nbytes / 3.35e12 > f / 989e12  # bytes bound the step
    assert flops.roofline_s(f, nbytes) == pytest.approx(nbytes / 3.35e12)


def test_flash_bounds_by_hand():
    pairs = 4 * 2048 * 2049 // 2
    assert flops.flash_bwd_bound_s(4, 2048, 16, 16, 128) == pytest.approx(
        10 * 16 * 128 * pairs / 989e12)
    assert flops.flash_bwd_bound_s(4, 2048, 16, 16, 128) * 1e3 == pytest.approx(0.1738, abs=1e-4)
    # one query row: bytes bound it
    assert flops.flash_bwd_bound_s(1, 1, 16, 8, 128) == pytest.approx(
        (2 * (4 * 16 * 128 + 4 * 8 * 128) + 4 * 16) / 3.35e12)
