"""conv_roofline: the profiled steps' analytic FLOPs (``flops.py``) over the
device time of the convolution and matrix-product kernels (cuDNN, cuBLAS)
at the H100's dense bf16 peak."""

from benchmark.peaks import PEAK_BF16_FLOPS
from benchmark.trace import LIBRARY_COMPUTE


def read(r):
    if r.trace is None:
        return None
    seconds = r.trace.family_s()
    busy = sum(seconds.get(f, 0.0) for f in LIBRARY_COMPUTE)
    if busy <= 0:
        return None
    work = sum(r.step_flops(c) for c in r.cell.traffic['profile_steps'])
    return 100.0 * work / (busy * PEAK_BF16_FLOPS)
