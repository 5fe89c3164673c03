"""The one source of a training step's random tensors.

Every random tensor of the local phases comes from a ``Draws``: the latent
z of each phase, the style-mixing draws, the path-length noise, the
synthesis noise (passed to the synthesis nets as their ``generator``) and
every draw of the augment pipe.  The default draws from the caller's
``torch.Generator``.  JAX's key streams and PyTorch's generators cannot give
the same numbers, so a test that holds the port to the JAX package
subclasses ``Draws`` and hands back the reference's draws instead.
"""

from __future__ import annotations

from typing import Sequence

import torch


class Draws:
    """N(0, 1) and U[0, 1) float32 tensors on the generator's device.

    ``kind`` says what a draw is for: ``'z'``, ``'style_mixing'``,
    ``'pl_noise'``, ``'synthesis_noise'`` or ``'augment'``; a subclass may
    answer each differently."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def normal(self, shape: Sequence[int], kind: str) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device)

    def uniform(self, shape: Sequence[int], kind: str) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device)
