"""idle_share (read as ``idle_share.<kind>`` in each kind's cells): the
card's idle share of the traced window, 1 - (the union of its device
events' intervals) / the window, in %."""


def read(run):
    t = run["trace"]
    if not t or not t["events"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
