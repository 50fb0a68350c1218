"""Roofline terms of a step on one NVIDIA H100 SXM (a copy of
:mod:`repro.roofline.report` with the card's constants).

    compute    = FLOPs / (chips x peak_FLOP/s)
    memory     = bytes / (chips x HBM_bw)
    collective = wire_bytes_per_device / link_bw

Hardware constants: one H100 SXM 80 GB, from NVIDIA's H100 datasheet
(SXM form factor): 989 TFLOP/s dense bfloat16 on the tensor cores (1,979
with sparsity, not used), 3.35 TB/s of HBM3, and 900 GB/s of NVLink (the
card's 18 fourth-generation links together, both directions). These are
the card's numbers, not the TPU v5e's that the JAX package's copy holds.
The field names stay the JAX package's, so a ``HWConsts`` given the same
values gives the same terms. One card has no collective: the port's
callers pass ``wire_bytes = 0``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HWConsts:
    peak_flops: float = 989e12  # dense bf16 on the tensor cores, per card
    hbm_bw: float = 3.35e12  # B/s of HBM3 per card
    ici_bw: float = 900e9  # B/s of NVLink per card (the link term)


HW = HWConsts()


def roofline_terms(
    hlo_flops: float,
    hlo_bytes: float,
    wire_bytes: float,
    chips: int,
    model_flops: float | None = None,
    hw: HWConsts = HW,
) -> dict:
    """All quantities are *global* (whole-step, all devices) except
    wire_bytes, which is already per-device link traffic."""
    t_compute = hlo_flops / (chips * hw.peak_flops)
    t_memory = hlo_bytes / (chips * hw.hbm_bw)
    t_coll = wire_bytes / hw.ici_bw
    terms = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
    }
    dom = max(terms, key=terms.get)
    out = dict(terms)
    out["bottleneck"] = dom.replace("t_", "").replace("_s", "")
    out["step_time_s"] = max(terms.values())
    # how close the step is to its *intrinsic* (compute/memory) roofline —
    # 1.0 unless collectives dominate
    intrinsic = max(t_compute, t_memory)
    out["intrinsic_fraction"] = (
        intrinsic / out["step_time_s"] if out["step_time_s"] > 0 else 0.0
    )
    if model_flops:
        out["model_flops"] = model_flops
        out["useful_flops_ratio"] = model_flops / hlo_flops if hlo_flops else 0.0
        # fraction of the compute roofline actually achieved at the modeled
        # step time (MFU — the score axis for compute-bound cells)
        out["roofline_fraction"] = (
            model_flops / (chips * hw.peak_flops) / out["step_time_s"]
            if out["step_time_s"] > 0
            else 0.0
        )
    # memory-roofline fraction (the score axis for bandwidth-bound cells,
    # i.e. decode): useful HBM traffic over achievable at the step time
    out["memory_roofline_fraction"] = (
        t_memory / out["step_time_s"] if out["step_time_s"] > 0 else 0.0
    )
    return out
