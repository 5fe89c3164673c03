"""device_idle_pct: the share of the profiled window in which no operation
ran on the card (the union of the device intervals, not their sum)."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
