"""train_mfu (``.moe``, ``.dense``): the training step's share of the card's
bf16 peak: the useful FLOPs of the traced window's steps
(``counts.flops.train_step_flops``: 6 a weight a token, top-k experts,
causal attention pairs) over its seconds x 989 TFLOP/s, in %."""

from bench.counts import flops


def read(run):
    m, mix = run["traced"], run["mix"]
    if not m["steps"]:
        return None
    work = flops.train_step_flops(run["arch"], mix["batch"], mix["seq_len"]) * m["steps"]
    return 100.0 * work / (m["window_s"] * flops.PEAK_FLOPS)
