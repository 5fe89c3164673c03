"""Timing of calls on the card, shared by ``chip_smoke.py`` and the tools.

* ``device_ms``: the card's time for one call, with L2 cold.  Before each
  sample 256 MB are read (five times the H100's 50 MB L2), so the call
  reads its inputs from memory, as a bound in bytes over the memory rate
  assumes; read, not written, so that L2 holds no dirty lines whose write
  back the call would pay for.  CUDA events bracket the call alone.  The
  samples are queued behind a sleep kernel that outlasts the host's time
  to queue them, so the host's launch time is hidden.
* ``host_us``: the host's time to issue one call (the Python wrapper, the
  C call, the launch), with no wait on the card.
* ``card_line``: the card's name and power limit, as ``nvidia-smi`` gives
  them, to stand beside every time.

``PEAK_BYTES`` is the memory rate that bounds in bytes are taken over.
"""

from __future__ import annotations

import functools
import statistics
import subprocess
import time

import torch

PEAK_BYTES = 3.35e12           # H100 SXM HBM3 (NVIDIA's data sheet)
L2_FLUSH_BYTES = 256 << 20


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports them."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def _flush_buffer(device: int) -> torch.Tensor:
    """The buffer read to flush L2 on ``device``, made once."""
    return torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                       device=device)


def device_ms(fn, samples: int = 25, per_sleep: int = 5) -> float:
    """Median device time of one call of ``fn``, L2 flushed before each of
    ``samples`` samples; ``per_sleep`` samples are queued behind each
    sleep kernel (fewer launches pending than the driver's queue holds)."""
    flush = _flush_buffer(torch.cuda.current_device())
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(per_sleep):
        flush.max()
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(4e9 * host) + 2_000_000     # twice the host time at 2 GHz
    times = []
    for _ in range(-(-samples // per_sleep)):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(per_sleep)]
        torch.cuda._sleep(cycles)
        for start, end in events:
            flush.max()
            start.record()
            fn()
            end.record()
        events[-1][1].synchronize()
        times += [start.elapsed_time(end) for start, end in events]
    return statistics.median(times)


def host_us(fn, calls: int = 100, repeats: int = 5) -> float:
    """The host's time per call of ``fn`` in µs: ``calls`` calls issued
    back to back (the card runs behind them), the median of ``repeats``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)
