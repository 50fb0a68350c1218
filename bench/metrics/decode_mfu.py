"""decode_mfu: the whole decode step's roofline share: over the traced
window's steps, the sum of each step's bound (the larger of its FLOPs over
989 TFLOP/s and its bytes over 3.35 TB/s: weights once, the valid cache
once, the new keys and values written) over the sum of the steps' times, in
%. At these contexts the bytes set the bound."""

from bench.counts import flops


def read(run):
    m, a = run["traced"], run["arch"]
    if not m["step_s"]:
        return None
    B = m["batch"]
    bound = sum(flops.roofline_s(flops.decode_step_flops(a, B, c), flops.decode_step_bytes(a, B, c))
                for c in m["contexts"])
    return 100.0 * bound / sum(m["step_s"])
