"""The one source of a training step's random tensors.

Every random tensor of a step comes from a ``Draws``: the latent z of each
phase, the style-mixing draws, the path-length noise, the synthesis noise
(passed to the synthesis nets as their ``generator``) and every draw of the
augment pipe.  The default draws from the caller's ``torch.Generator``.
JAX's key streams and PyTorch's generators cannot give the same numbers, so
a test that holds the port to the JAX package subclasses ``Draws`` and hands
back the reference's draws instead.

With data parallelism each rank draws through ``RankDraws``: from the same
seeded generator on every rank it draws every per-sample draw in the global
batch's shape and keeps its own rows, and draws a per-batch draw (the
style-mixing cutoff) whole, so R ranks consume the same random numbers as
one process at the global batch.
"""

from __future__ import annotations

from typing import Sequence

import torch

# Kinds drawn once for the whole batch (every other draw has the batch
# first): the same on every rank.
PER_BATCH_KINDS = ('style_mixing_cutoff',)


class Draws:
    """N(0, 1) and U[0, 1) float32 tensors on the generator's device.

    ``kind`` says what a draw is for: ``'z'``, ``'style_mixing'`` (the
    second z), ``'style_mixing_cutoff'`` (one pair for the batch),
    ``'pl_noise'``, ``'synthesis_noise'`` or ``'augment'`` in the local
    phases; a conditional step also draws a permutation of its label pool
    per phase (``permutation``, kind ``'gen_c'``), over the global batch
    and the same on every rank.  The renderer phase and the global phases draw through
    ``scoped('renderer_')`` and ``scoped('global_')``, which prefix the kind
    (``'renderer_z'``, ``'global_synthesis_noise'``, ``'global_augment'``,
    ...).  A subclass may answer each kind differently."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def normal(self, shape: Sequence[int], kind: str) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device)

    def uniform(self, shape: Sequence[int], kind: str) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device)

    def permutation(self, n: int, kind: str) -> torch.Tensor:
        """A random permutation of ``range(n)`` (int64)."""
        return torch.randperm(n, generator=self.generator,
                              device=self.device)

    def scoped(self, prefix: str) -> 'Draws':
        """These draws, with ``prefix`` before every kind."""
        return _Scoped(self, prefix)

    def blocks(self, count: int) -> 'Draws':
        """These draws for a batch made of ``count`` equal blocks of the
        global batch laid end to end (accumulation rounds, or fakes and
        reals through one augment call): a rank's rows are its rows of
        each block.  The same draws for one process."""
        return self


class RankDraws(Draws):
    """The draws of rank ``rank`` of ``world``: a per-sample draw of a
    ``[n, ...]`` batch is drawn as ``[n * world, ...]``, the global batch of
    ``blocks`` blocks of ``world`` ranks' rows each, and the rank keeps its
    rows of every block; a per-batch draw (``PER_BATCH_KINDS``) is drawn
    whole.  Every rank gets the numbers one process draws at the global
    batch."""

    def __init__(self, generator: torch.Generator, rank: int, world: int,
                 blocks: int = 1):
        super().__init__(generator)
        self.rank, self.world, self._blocks = rank, world, blocks

    def _rows(self, draw, shape: Sequence[int], kind: str) -> torch.Tensor:
        shape = tuple(shape)
        if kind.endswith(PER_BATCH_KINDS):
            return draw(shape)
        n, rest = shape[0], shape[1:]
        if n % self._blocks:
            raise ValueError(f'{kind}: batch {n} in {self._blocks} blocks')
        full = draw((n * self.world, *rest))
        full = full.reshape(self._blocks, self.world, n // self._blocks,
                            *rest)
        return full[:, self.rank].reshape(shape)

    def normal(self, shape: Sequence[int], kind: str) -> torch.Tensor:
        return self._rows(lambda s: Draws.normal(self, s, kind), shape, kind)

    def uniform(self, shape: Sequence[int], kind: str) -> torch.Tensor:
        return self._rows(lambda s: Draws.uniform(self, s, kind), shape,
                          kind)

    def blocks(self, count: int) -> 'Draws':
        return RankDraws(self.generator, self.rank, self.world, count)


class _Scoped(Draws):
    def __init__(self, base: Draws, prefix: str):
        self.base = base
        self.prefix = prefix
        self.device = base.device

    def normal(self, shape: Sequence[int], kind: str) -> torch.Tensor:
        return self.base.normal(shape, self.prefix + kind)

    def uniform(self, shape: Sequence[int], kind: str) -> torch.Tensor:
        return self.base.uniform(shape, self.prefix + kind)

    def permutation(self, n: int, kind: str) -> torch.Tensor:
        return self.base.permutation(n, self.prefix + kind)

    def blocks(self, count: int) -> 'Draws':
        return _Scoped(self.base.blocks(count), self.prefix)
