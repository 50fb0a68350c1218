"""The port's tiered serving loop on the CPU == the JAX package's
``repro.serving`` loop, exactly: ``summary()``, per-round history, tuner
decisions, watermark log, the page -> HBM slot map, tiers and the bits of
both page pools, with the same seeded host contents handed to both."""

from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import decision_dicts, event_dicts
from repro.core import TunaTuner as JaxTuner
from repro.core import TunerConfig as JaxTunerConfig
from repro.core import WatermarkController as JaxController
from repro.core.perfdb import PerfDB, PerfRecord
from repro.core.telemetry import ConfigVector
from repro.serving import ContinuousBatcher as JaxBatcher
from repro.serving import TieredPagedKV as JaxKV
from repro.serving import TieredServer as JaxServer
from repro.serving.kv_cache import KVPageConfig as JaxPageConfig
from repro.sim.costmodel import TPU_V5E_TIER
from repro_torch import convert
from repro_torch.core.tuner import TunaTuner, TunerConfig
from repro_torch.core.watermark import WatermarkController
from repro_torch.serving import ContinuousBatcher, TieredPagedKV, TieredServer
from repro_torch.sim.costmodel import H100_HOST_TIER

# the JAX server's default tier profile, carried across as plain fields
HW = convert.hardware_profile_from_dict(asdict(TPU_V5E_TIER))


def _demo_db_records(total_pages):
    """The hand-built database of ``examples/serve_tiered.py``."""
    grid = np.array([1.0, 0.85, 0.7, 0.55, 0.4, 0.25])
    out = []
    for pacc in (200, 800, 2400):
        for pm in (2, 16, 64):
            loss = (pm / 32.0) * (1.0 / grid - 1.0) * 0.08
            out.append({
                "config": dict(pacc_f=pacc, pacc_s=pm, pm_de=pm, pm_pr=pm,
                               ai=1e6, rss_pages=total_pages, hot_thr=2,
                               num_threads=1),
                "fm_fracs": grid, "times": 1.0 + loss,
            })
    return out


def _pair(cfg, total, hbm, batcher_kw, seed, tuned=False, fm_pages=None):
    """(JAX server, port server) over the same seeded host pool."""
    rng = np.random.default_rng(seed)
    jcfg = JaxPageConfig(**cfg)
    host = np.asarray(rng.normal(size=(total, jcfg.elems_per_page)),
                      dtype=jnp.bfloat16)
    jkv = JaxKV(jcfg, total_pages=total, hbm_capacity=hbm)
    jkv.host[:] = host
    kv = TieredPagedKV(convert.kv_page_config_from_dict(cfg), total_pages=total,
                       hbm_capacity=hbm, device="cpu")
    kv.host.copy_(convert.pool_from_numpy(host))
    if fm_pages is not None:
        jkv.pool.set_fm_size(fm_pages)
        kv.pool.set_fm_size(fm_pages)
    jt = pt = None
    if tuned:
        recs = _demo_db_records(total)
        jdb = PerfDB()
        for r in recs:
            jdb.add(PerfRecord(config=ConfigVector(**r["config"]),
                               fm_fracs=r["fm_fracs"], times=r["times"]))
        jdb.build()
        jt = JaxTuner(jdb, JaxController(jkv.pool, max_step_frac=0.1),
                      JaxTunerConfig(target_loss=0.05), peak_rss_pages=hbm)
        pt = TunaTuner(convert.perfdb_from_records(recs),
                       WatermarkController(kv.pool, max_step_frac=0.1),
                       TunerConfig(target_loss=0.05), peak_rss_pages=hbm)
    ref = JaxServer(jkv, JaxBatcher(**batcher_kw), tuner=jt, tune_every=16)
    port = TieredServer(kv, ContinuousBatcher(**batcher_kw), tuner=pt,
                        tune_every=16, hw=HW)
    return ref, port


def _assert_same(ref, port):
    assert ref.summary() == port.summary()
    assert [asdict(h) for h in ref.history] == [asdict(h) for h in port.history]
    jkv, kv = ref.kv, port.kv
    assert np.array_equal(jkv.hbm_slot, kv.hbm_slot)
    assert np.array_equal(np.asarray(jkv.pool.tier), np.asarray(kv.pool.tier))
    every = np.arange(jkv.total_pages)
    assert np.array_equal(jkv.pool.heat_of(every), kv.pool.heat_of(every))
    assert np.array_equal(np.asarray(jkv.host).view(np.uint16),
                          convert.pool_bits(kv.host))
    assert np.array_equal(np.asarray(jkv.hbm).view(np.uint16),
                          convert.pool_bits(kv.hbm))
    if ref.tuner is not None:
        assert decision_dicts(ref.tuner.decisions) == \
            decision_dicts(port.tuner.decisions)
        assert event_dicts(ref.tuner.controller.log) == \
            event_dicts(port.tuner.controller.log)


@pytest.mark.parametrize("seed", [0, 1])
def test_matches_jax_at_substrate_size(seed):
    # tests/test_substrate.py's server: 256 pages, 64 slots, budget 48
    ref, port = _pair(
        dict(n_groups=2, page_size=4, kv_heads=2, head_dim=8), 256, 64,
        dict(n_sessions=40, page_size=4, max_batch=8, seed=1), seed,
        fm_pages=48,
    )
    ref.run(rounds=60, drift_every=0)
    port.run(rounds=60, drift_every=0)
    _assert_same(ref, port)
    s = port.summary()
    assert s["migrated_in"] > 0 and s["migrated_out"] > 0
    assert port.kv.pool.fast_used <= 64


def test_matches_jax_tuned_at_demo_page_counts():
    # examples/serve_tiered.py's counts (4,096 pages, 1,024 slots, 400
    # sessions) at a narrow page; drift fires twice, the tuner moves the
    # watermarks both ways
    ref, port = _pair(
        dict(n_groups=1, page_size=16, kv_heads=1, head_dim=8), 4096, 1024,
        dict(n_sessions=400, page_size=16, max_batch=16, resumes_per_round=3.0),
        seed=7, tuned=True,
    )
    ref.run(rounds=300, drift_every=100)
    port.run(rounds=300, drift_every=100)
    _assert_same(ref, port)
    log = port.tuner.controller.log
    assert len(log) > 0 and port.summary()["migrated_out"] > 0


def test_pages_migrate_and_data_survives():
    # tests/test_substrate.py's round trip, on both packages
    cfg = dict(n_groups=2, page_size=4, kv_heads=2, head_dim=8)
    jkv = JaxKV(JaxPageConfig(**cfg), total_pages=256, hbm_capacity=64)
    kv = TieredPagedKV(convert.kv_page_config_from_dict(cfg), total_pages=256,
                       hbm_capacity=64, device="cpu")
    n = kv.cfg.elems_per_page
    for k in (jkv, kv):
        k.ensure_resident(np.array([5]))
    jkv.write_tokens(np.array([5]), jnp.arange(n, dtype=jnp.bfloat16)[None])
    kv.write_tokens(np.array([5]), torch.arange(n, dtype=torch.bfloat16)[None])
    for k in (jkv, kv):
        k.demote(np.array([5]))
        assert k.tier_of(5).name == "SLOW"
        k.ensure_resident(np.array([5]))
    got = kv.hbm[int(kv.hbm_slot[5])]
    assert torch.equal(got, torch.arange(n, dtype=torch.bfloat16))
    assert np.array_equal(np.asarray(jkv.hbm).view(np.uint16),
                          convert.pool_bits(kv.hbm))
    assert np.array_equal(np.asarray(jkv.host).view(np.uint16),
                          convert.pool_bits(kv.host))


def test_page_config_and_tier_profile():
    cfg = convert.kv_page_config_from_dict(
        dict(n_groups=28, page_size=16, kv_heads=8, head_dim=128))
    assert cfg.bytes_per_page == 1_835_008  # one Qwen3-1.7B KV page in bf16
    assert cfg.bytes_per_page == JaxPageConfig(
        n_groups=28, page_size=16, kv_heads=8, head_dim=128).bytes_per_page
    assert H100_HOST_TIER.bw_fast == 3.35e12 and H100_HOST_TIER.bw_slow == 64e9
    kv = TieredPagedKV(cfg.__class__(1, 4, 1, 8, "float32"), total_pages=8,
                       hbm_capacity=4, device="cpu")
    with pytest.raises(TypeError):
        TieredServer(kv, ContinuousBatcher(n_sessions=2, page_size=4))
    assert not kv.host.is_pinned()
