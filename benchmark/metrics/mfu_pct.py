"""mfu_pct: the window's analytic FLOPs (``flops.py``, each step by the
regularizers it ran) over its wall time and the H100's dense bf16 peak."""

from benchmark.peaks import PEAK_BF16_FLOPS


def read(r):
    if not r.window_steps or r.window_s <= 0:
        return None
    work = sum(r.step_flops(c) for c in r.window_steps)
    return 100.0 * work / (r.window_s * PEAK_BF16_FLOPS)
