"""Training statistics: moment accumulation and sinks.

Port of ``montage_gan_tpu/utils/training_stats.py`` (the reference's
torch_utils/training_stats.py): per-name moment triples [n, Σx, Σx²], a
Collector exposing mean/std, and the ``stats.jsonl`` and TensorBoard sinks,
with the same names and records.  The loop reads a step's stats from the
device once (``training/loop_aio.py``).  Under data parallelism a
``Collector`` sums every name's moments over the ranks when it updates (the
reference's ``training_stats.py:261-262``), so rank 0 writes the ranks'
statistics.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from .config import EasyDict


class StatsAccumulator:
    """Per-name [n, Σx, Σx²] accumulation."""

    def __init__(self):
        self._moments: Dict[str, np.ndarray] = defaultdict(
            lambda: np.zeros(3, np.float64))

    def report(self, name: str, value) -> None:
        v = np.asarray(value, dtype=np.float64).ravel()
        if v.size == 0:
            return
        self._moments[name] += np.array([v.size, v.sum(), np.square(v).sum()])

    def report_dict(self, stats: Dict[str, object]) -> None:
        for k, v in stats.items():
            self.report(k, v)

    def pop(self) -> Dict[str, np.ndarray]:
        out = dict(self._moments)
        self._moments = defaultdict(lambda: np.zeros(3, np.float64))
        return out


class Collector:
    """Snapshot view over an accumulator
    (reference contract: torch_utils/training_stats.py:150-215).  With
    ``data_parallel`` (a ``parallel.mesh.DataParallel``) ``update`` is a
    collective: every rank calls it, and every rank sees the moments summed
    over the ranks."""

    def __init__(self, accumulator: StatsAccumulator, regex: str = '.*',
                 data_parallel: Optional[object] = None):
        self._acc = accumulator
        self._regex = re.compile(regex)
        self._dp = data_parallel
        self._moments: Dict[str, np.ndarray] = {}

    def _reduce(self, fresh: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The moments of every name any rank reported, summed over the
        ranks."""
        import torch
        import torch.distributed as dist
        dp = self._dp
        names = [None] * dp.world
        dist.all_gather_object(names, sorted(fresh))
        names = sorted(set().union(*names))
        zero = np.zeros(3, np.float64)
        m = torch.from_numpy(np.stack([fresh.get(n, zero) for n in names])
                             if names else np.zeros((0, 3)))
        m = m.to(dp.device)
        dist.all_reduce(m)
        return dict(zip(names, m.cpu().numpy()))

    def update(self) -> None:
        fresh = self._acc.pop()
        if self._dp is not None:
            fresh = self._reduce(fresh)
        for name, m in fresh.items():
            if self._regex.fullmatch(name):
                self._moments[name] = m
            else:
                # put back what we don't collect
                self._acc._moments[name] += m

    def names(self):
        return list(self._moments)

    def mean(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0:
            return float('nan')
        return float(m[1] / m[0])

    def std(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0 or not np.isfinite(m[1] / m[0]):
            return 0.0
        if m[0] == 1:
            return 0.0
        mean = m[1] / m[0]
        raw_var = m[2] / m[0]
        return float(np.sqrt(max(raw_var - mean ** 2, 0)))

    def __getitem__(self, name: str) -> float:
        return self.mean(name)

    def as_dict(self) -> EasyDict:
        out = EasyDict()
        for name in self.names():
            out[name] = EasyDict(num=int(self._moments[name][0]),
                                 mean=self.mean(name), std=self.std(name))
        return out


class JsonlWriter:
    """stats.jsonl sink (reference: custom/training_loop_aio.py:871-874)."""

    def __init__(self, path: str):
        self._f = open(path, 'at')

    def write(self, stats: EasyDict, **extra) -> None:
        record = {k: dict(v) for k, v in stats.items()}
        record.update(extra)
        self._f.write(json.dumps(record) + '\n')
        self._f.flush()

    def close(self):
        self._f.close()


def make_tensorboard_writer(run_dir: str):
    """Optional TensorBoard sink; returns None when unavailable."""
    try:
        from torch.utils import tensorboard
        return tensorboard.SummaryWriter(run_dir)
    except ImportError:
        return None
