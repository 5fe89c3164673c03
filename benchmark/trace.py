"""The reduction of a ``torch.profiler`` trace to device intervals, busy
time, idle gaps and kernel families.

Device operations are the trace's CUDA events that are not ranges marked by
``record_function``; busy time is the length of the union of their
intervals inside the profiled window (streams that overlap count once).
An idle gap is a stretch of the window with no device operation; it is
named by what the host's main thread was doing at its middle (the
innermost operation or span open there).  The family table is a copy of the
port's ``tools/profile.py`` table."""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

FAMILIES = (
    ("K1' bias_act grad", ('bias_act_grad',)),
    ("K1' bias_act", ('bias_act',)),
    ("K2' upfirdn2d", ('upfirdn2d',)),
    ("K3' warp forward", ('warp_forward',)),
    ("K4' warp transpose", ('warp_transpose',)),
    ("K5' composite", ('composite_kernel',)),
    # before the library families: 'AllReduce' and 'AllGather' would match
    # 'reduce' and 'gather'
    ('collectives (NCCL)', ('nccl',)),
    ('convolution (cuDNN)', ('conv', 'fprop', 'dgrad', 'wgrad', 'cudnn',
                             'winograd', 'implicit_gemm')),
    ('matrix products (cuBLAS)', ('gemm', 'gemv')),
    ('optimizer (Adam)', ('adam', 'multi_tensor_apply')),
    ('reductions', ('reduce',)),
    ('gather and scatter', ('index', 'gather', 'scatter', 'grid_sampler')),
    ('elementwise and copies', ('elementwise', 'copy', 'fill', 'cat',
                                'memcpy', 'memset')),
)
HANDWRITTEN = tuple(f for f, _ in FAMILIES[:6])
LIBRARY_COMPUTE = ('convolution (cuDNN)', 'matrix products (cuBLAS)')
NAME_CHARS = 160          # a kernel's name as the breakdown gives it

Interval = Tuple[int, int]


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return 'other'


@dataclasses.dataclass
class Trace:
    """What a profiled window left: device operations ``(name, start_ns,
    end_ns)``, the host main thread's operations and spans (same form),
    the window ``(start_ns, end_ns)`` and the steps it holds."""
    device: List[Tuple[str, int, int]]
    host: List[Tuple[str, int, int]]
    window: Interval
    steps: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e in self.device],
                        self.window) / 1e9

    def family_s(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.Counter()
        for name, s, e in self.device:
            out[family(name)] += (e - s) / 1e9
        return out

    def launches(self) -> int:
        return sum(1 for name, _, _ in self.device
                   if not name.lower().startswith(('memcpy', 'memset')))


def union_ns(intervals: Iterable[Interval], window: Interval) -> int:
    """Length of the union of ``intervals`` clipped to ``window``."""
    lo, hi = window
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: Iterable[Interval], window: Interval
              ) -> List[Interval]:
    """The stretches of ``window`` that no interval covers."""
    lo, hi = window
    gaps, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def innermost(host: Sequence[Tuple[str, int, int]], points: Sequence[int]
              ) -> List[Optional[str]]:
    """For each point, the name of the innermost host event open there
    (events of one thread nest)."""
    events = sorted(host, key=lambda ev: (ev[1], -ev[2]))
    order = sorted(range(len(points)), key=lambda i: points[i])
    out: List[Optional[str]] = [None] * len(points)
    stack: List[Tuple[str, int, int]] = []
    k = 0
    for i in order:
        p = points[i]
        while k < len(events) and events[k][1] <= p:
            ev = events[k]
            while stack and stack[-1][2] <= ev[1]:
                stack.pop()
            stack.append(ev)
            k += 1
        while stack and stack[-1][2] <= p:
            stack.pop()
        out[i] = stack[-1][0] if stack else None
    return out


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle time by
    what the host was doing, in seconds, ``top`` of each."""
    ops: Dict[str, float] = collections.Counter()
    for name, s, e in trace.device:
        ops[name[:NAME_CHARS]] += (e - s) / 1e9
    gaps = idle_gaps([(s, e) for _, s, e in trace.device], trace.window)
    labels = innermost(trace.host, [(s + e) // 2 for s, e in gaps])
    idle: Dict[str, float] = collections.Counter()
    for (s, e), label in zip(gaps, labels):
        idle[label or 'no host operation'] += (e - s) / 1e9
    return {'device_ops': [[k, v] for k, v in ops.most_common(top)],
            'idle_gaps': [[k, v] for k, v in idle.most_common(top)]}


def read_profile(prof, window_span: str, steps: int) -> Trace:
    """The ``Trace`` of a stopped ``torch.profiler.profile``; the window is
    the host span named ``window_span``, whose thread is the main one."""
    import torch
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    device, host_all, window, main = [], [], None, None
    for ev in events:
        name = ev.name()
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == cuda:
            if ev.is_user_annotation() or name.startswith(
                    ('ProfilerStep', 'Optimizer.')):
                continue
            device.append((name, start, start + dur))
        else:
            host_all.append((name, start, start + dur, ev.start_thread_id()))
            if name == window_span:
                window, main = (start, start + dur), ev.start_thread_id()
    if window is None:
        raise RuntimeError(f'the trace has no span {window_span!r}')
    host = [(n, s, e) for n, s, e, t in host_all if t == main]
    return Trace(device=device, host=host, window=window, steps=steps)
