"""The port's analytic roofline (``repro_torch.roofline``) against the JAX
package's (``repro.roofline``), on the CPU.

``analytic.py`` is the same float arithmetic in the same order over the
port's ``ModelConfig``, so every count equals the JAX one exactly, for
every architecture of the JAX ``ARCHS`` at every shape of ``SHAPES`` (and
a few variants: the int8 KV cache, other remat policies, Jamba's one-card
cut). ``roofline_terms`` equals the JAX function given the same
``HWConsts`` and uses one H100 SXM's constants by default.
"""

from dataclasses import asdict, replace

import pytest

from repro import configs as jconfigs
from repro.models import transformer as jt
from repro.roofline import analytic as ja
from repro.roofline import report as jr
from repro_torch import configs
from repro_torch.models import transformer as pt
from repro_torch.roofline import HW, HWConsts, analytic as pa, report as pr, roofline_terms

CELLS = [(a, s) for a in jconfigs.ARCHS for s in jconfigs.SHAPES]


def _cfgs(arch, **over):
    return replace(jconfigs.get_config(arch), **over), replace(configs.get_config(arch), **over)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_counts_equal_jax_exactly(arch, shape):
    """``forward_flops``, ``cell_flops`` and ``cell_hbm_bytes`` at the
    shape's (kind, batch, seq), with the parameter count the dry run
    gives them (the JAX ``active_param_count_shapes``; the port's equals
    it)."""
    jcfg, pcfg = _cfgs(arch)
    spec = jconfigs.SHAPES[shape]
    n = jt.active_param_count_shapes(jcfg)
    assert pt.active_param_count_shapes(pcfg) == n
    b, s, kind = spec.global_batch, spec.seq_len, spec.kind
    assert pa.forward_flops(pcfg, b * s, s / 2, b) == ja.forward_flops(jcfg, b * s, s / 2, b)
    assert pa.cell_flops(pcfg, kind, b, s) == ja.cell_flops(jcfg, kind, b, s)
    assert pa.cell_hbm_bytes(pcfg, kind, b, s, n) == ja.cell_hbm_bytes(jcfg, kind, b, s, n)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
@pytest.mark.parametrize("variant", [
    dict(kv_cache_dtype="int8"), dict(remat="none"), dict(remat="dots"),
    dict(opt_bytes_per_param=4.0)])
def test_variants_equal_jax_exactly(arch, variant):
    """The int8 cache's decode bytes, the remat multipliers and another
    optimizer state size, at a 4 x 2,048 cell of each kind."""
    variant = dict(variant)
    over = {k: variant.pop(k) for k in ("kv_cache_dtype",) if k in variant}
    jcfg, pcfg = _cfgs(arch, **over)
    n = 123_456_789
    for kind in ("train", "prefill", "decode"):
        remat = {k: variant[k] for k in ("remat",) if k in variant}
        opt = {k: variant[k] for k in ("opt_bytes_per_param",) if k in variant}
        assert pa.cell_flops(pcfg, kind, 4, 2048, **remat) == ja.cell_flops(
            jcfg, kind, 4, 2048, **remat)
        assert pa.cell_hbm_bytes(pcfg, kind, 4, 2048, n, **remat, **opt) == ja.cell_hbm_bytes(
            jcfg, kind, 4, 2048, n, **remat, **opt)


def test_jamba_one_card_cut():
    """Jamba-1.5-Large at one 8-layer group with 4 experts (top-2 kept),
    the cut served on one card: 16.25 B parameters; the 4 x 2,048 prefill
    198.4 TFLOP and 45.4 GB, a 4 x 2,080 decode step 32.6 GB, as the JAX
    counts give them; the prefill's bound is set by the tensor cores, the
    decode step's by HBM."""
    jcfg, pcfg = _cfgs("jamba-1.5-large-398b", num_layers=8, n_experts=4)
    n = pt.param_count(pt.param_shapes(pcfg))
    assert n == 16_246_923_264
    f = pa.cell_flops(pcfg, "prefill", 4, 2048)
    b = pa.cell_hbm_bytes(pcfg, "prefill", 4, 2048, n)
    assert (f, b) == (ja.cell_flops(jcfg, "prefill", 4, 2048),
                      ja.cell_hbm_bytes(jcfg, "prefill", 4, 2048, n))
    assert round(f / 1e12, 1) == 198.4 and round(b / 1e9, 1) == 45.4
    d = pa.cell_hbm_bytes(pcfg, "decode", 4, 2080, n)
    assert round(d / 1e9, 1) == 32.6
    pre = roofline_terms(f, b, 0.0, 1)
    dec = roofline_terms(pa.cell_flops(pcfg, "decode", 4, 2080), d, 0.0, 1)
    assert pre["bottleneck"] == "compute" and dec["bottleneck"] == "memory"
    assert pre["step_time_s"] == f / 989e12 and dec["step_time_s"] == d / 3.35e12


def test_hw_is_one_h100_sxm():
    assert asdict(HW) == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "ici_bw": 900e9}
    assert pr.HW is HW and HWConsts() == HW
    assert [f.name for f in pr.HWConsts.__dataclass_fields__.values()] == [
        f.name for f in jr.HWConsts.__dataclass_fields__.values()]
    assert asdict(jr.HW) != asdict(HW)  # the JAX package's are a TPU v5e's


@pytest.mark.parametrize("case", [
    dict(hlo_flops=198e12, hlo_bytes=45e9, wire_bytes=0.0, chips=1),
    dict(hlo_flops=1e11, hlo_bytes=33e9, wire_bytes=0.0, chips=1),
    dict(hlo_flops=5e15, hlo_bytes=2e12, wire_bytes=3e9, chips=4, model_flops=4e15),
    dict(hlo_flops=0.0, hlo_bytes=0.0, wire_bytes=0.0, chips=1),
    dict(hlo_flops=1e12, hlo_bytes=1e9, wire_bytes=1e12, chips=8, model_flops=5e11),
])
@pytest.mark.parametrize("consts", ["jax", "h100"])
def test_roofline_terms_equal_jax_given_the_same_constants(case, consts):
    """Every returned term equals the JAX function's, given the JAX
    package's constants or the H100's; with no ``hw`` the port uses the
    H100's."""
    values = asdict(jr.HW) if consts == "jax" else asdict(HW)
    got = roofline_terms(**case, hw=pr.HWConsts(**values))
    assert got == jr.roofline_terms(**case, hw=jr.HWConsts(**values))
    if consts == "h100":
        assert roofline_terms(**case) == got
