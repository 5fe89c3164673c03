"""handwritten_roofline: the hand-written kernels' bound (the bytes their
launches have to move, worked out by ``benchmark/launch_bytes.py`` from
each launch's arguments, over the H100's 3.35 TB/s) over their device time
in the profiled steps.  Left out where a kernel that ran has no byte count
(its entry point's arguments changed form)."""

from benchmark.peaks import PEAK_BYTES
from benchmark.trace import HANDWRITTEN


def read(r):
    if r.trace is None:
        return None
    seconds = r.trace.family_s()
    busy = sum(seconds.get(f, 0.0) for f in HANDWRITTEN)
    if any(seconds.get(f, 0.0) > 0 and r.kernel_bytes.get(f) is None
           for f in HANDWRITTEN):
        return None
    moved = sum(r.kernel_bytes.get(f) or 0 for f in HANDWRITTEN)
    if busy <= 0 or moved <= 0:
        return None
    return 100.0 * (moved / PEAK_BYTES) / busy
