"""On the card, at a size a test run holds: a traced window of each cell
with the program's spans on puts at least 98% of its device seconds under
a span, program or benchmark; every ``indexing_backward_kernel`` of the
MoE step lands in its dispatch or combine, or in the embedding's backward
(the gather of the token rows differentiates into the same accumulating
scatter); each program-span metric reads a number; and the decode cell's
traced set-up puts its fill under ``rt.prefill``. Decided inside
the test whether there is a card."""

import pytest
import torch

from bench.harness import attribute, spec
from bench.tests import tiny

CELLS = {"qwen3-1.7b.decode-32k": (None, {"decode_attention_ms", "decode_host_ms"}),
         "deepseek-moe-16b-l8.train-2k": ("moe", {"adamw_ms.moe", "loss_head_ms.moe",
                                                  "moe_dispatch_ms", "moe_combine_ms",
                                                  "moe_slot_use", "moe_dropped_share"}),
         "qwen3-1.7b.train-4k": ("dense", {"adamw_ms.dense", "loss_head_ms.dense"})}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_kernels_land_in_spans_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    entry = spec.cell(spec.load(), cell)
    mix = tiny.mix(entry["traffic"])
    run = attribute.trace_cell(cell, tiny.config(entry["config"]), mix, 5, 2.0,
                               torch.device("cuda", 0))
    prog = run["trace"]["program"]
    assert prog["total_s"] > 0
    assert prog["bench_alone"].get("", 0.0) <= 0.02 * prog["total_s"], prog["bench_alone"]
    part, names = CELLS[cell]
    got = attribute.metrics(run, part)
    assert set(got) == names, got
    assert all(v > 0 for k, v in got.items() if k != "moe_dropped_share")
    setup = run["setup_trace"]["program"]
    if part is None:
        assert setup["top"].get("rt.prefill", 0.0) > 0, setup["top"]
        assert len(setup["host_s"]["rt.prefill"]) == mix["batch"]
    where = attribute.kernel_split(prog, "indexing_backward")
    if part == "moe":
        assert where and all(w.split()[0] in ("rt.moe.dispatch", "rt.moe.combine", "rt.embed")
                             for w in where), where
        assert {"rt.moe.dispatch fwd", "rt.moe.dispatch recompute",
                "rt.moe.combine bwd", "rt.embed bwd"} <= set(where)
