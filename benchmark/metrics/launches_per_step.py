"""launches_per_step: device kernels in the profiled steps, a step (copies
and fills by the copy engine left out), from the trace."""


def read(r):
    if r.trace is None or not r.trace.steps:
        return None
    return r.trace.launches() / r.trace.steps
