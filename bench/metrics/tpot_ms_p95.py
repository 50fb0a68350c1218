"""tpot_ms_p95: the 95th percentile, over every decode step of the window,
of the time from the step's start until its sampled tokens are on the host,
in ms."""

import numpy as np


def read(run):
    t = run["measured"]["step_s"]
    return float(np.percentile(t, 95)) * 1e3 if t else None
