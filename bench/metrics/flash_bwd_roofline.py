"""flash_bwd_roofline: the flash-attention backward's share of its bound at
the cell's shapes: the bound of one layer's backward
(``counts.flops.flash_bwd_bound_s``, B x S causal, the configuration's
heads) over the mean device time of one launch of each backward kernel in
the trace (names holding ``flash_bwd``), summed over the kernels, in %. The
profiler may lose launches: the mean is over those it found, and the count
found against the count expected (a launch of each kernel a layer a step)
goes to standard error. A kernel found by no event leaves the metric out."""

import collections
import sys

from bench.counts import flops
from bench.harness.trace import found


def read(run):
    if not run["trace"]:
        return None
    a, mix, m = run["arch"], run["mix"], run["traced"]
    by_name = collections.defaultdict(list)
    for name, s in found(run["trace"], "flash_bwd"):
        by_name[name].append(s)
    expected = a.layers * m["steps"]
    print(f"flash_bwd_roofline: launches found {dict((k[:40], len(v)) for k, v in by_name.items())}"
          f" of {expected} each", file=sys.stderr)
    if not by_name:
        return None
    per_call = sum(sum(v) / len(v) for v in by_name.values())
    bound = flops.flash_bwd_bound_s(mix["batch"], mix["seq_len"], a.heads, a.kv_heads, a.hd)
    return 100.0 * bound / per_call
