"""The step's random draws, keyed so that two programs get the same.

Each draw is made by a generator on the device seeded from ``(seed, step,
kind, n)``, ``n`` counting the draws of that kind in the step, so the port
and the reference draw the same numbers however they interleave kinds.
``draws_for(base)`` makes the class for one side: ``base`` is that side's
``Draws`` (the port's ``training/draws.py`` seam, or the reference's copy),
whose ``scoped`` and ``blocks`` route back here."""

from __future__ import annotations

import collections
import hashlib
from typing import Sequence

import torch


def draw_key(*parts) -> int:
    """A 63-bit seed from the parts' text."""
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, 'little') >> 1


class _Keyed:
    def __init__(self, seed: int, step: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.seed, self.step = int(seed), int(step)
        self.counts: collections.Counter = collections.Counter()

    def _next(self, kind: str) -> torch.Generator:
        n = self.counts[kind]
        self.counts[kind] += 1
        return self.generator.manual_seed(draw_key(self.seed, self.step,
                                                   kind, n))

    def normal(self, shape: Sequence[int], kind: str) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self._next(kind),
                           device=self.device)

    def uniform(self, shape: Sequence[int], kind: str) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._next(kind),
                          device=self.device)

    def permutation(self, n: int, kind: str) -> torch.Tensor:
        return torch.randperm(n, generator=self._next(kind),
                              device=self.device)


def draws_for(base: type) -> type:
    """The keyed draws as a subclass of ``base``."""
    return type(f'Keyed{base.__name__}', (_Keyed, base), {})
