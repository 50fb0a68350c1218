"""The numbers that decide ``correct``, each held to its limit."""

from __future__ import annotations

import math
import statistics

import torch


def gap(ref_logits, served) -> float:
    """The widest gap by which a served token's reference logit lies below
    the reference's best, over the rows of ``ref_logits`` (n, V) float32."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, served.reshape(-1, 1).to(ref_logits.device).long())[:, 0]
    return float((best - got).max())


def rel_l2(logits, ref_logits) -> float:
    """The largest relative L2 distance of a row of ``logits`` from the
    reference's row."""
    d = (logits.float() - ref_logits).norm(dim=-1) / ref_logits.norm(dim=-1)
    return float(d.max())


def leaf_gap(prog: dict, ref: dict, names=None) -> float:
    """The worst leaf's |program's norm - reference's norm|, over the larger
    of the reference's norm of that leaf and of the median leaf."""
    names = list(ref) if names is None else list(names)
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def judge(values: dict, limits: dict) -> list:
    """[{"name", "value", "limit"}] for every number the cell's limits name
    (a number without a limit is read but not compared: ``PERF.md`` says
    why); a number that is not finite fails."""
    return [{"name": k, "value": float(v), "limit": float(limits[k])}
            for k, v in values.items() if k in limits]


def passed(checks: list) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks)


def free(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
