"""One process, no ranks: the identity of every collective the copied
modules call (the port's ``parallel/mesh.py`` without an active group)."""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch


@contextlib.contextmanager
def activate(dp):
    yield


def gather_batch(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    return x, 0


def global_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def global_mean(x: torch.Tensor) -> torch.Tensor:
    return x


@torch.no_grad()
def leading_rows(x: torch.Tensor, shrink: int) -> torch.Tensor:
    return x[:x.shape[0] // shrink]


def global_rows(x: torch.Tensor, rounds: int = 1) -> torch.Tensor:
    return x


def own_rows(x: torch.Tensor, rounds: int = 1) -> torch.Tensor:
    return x


def all_reduce_grads(grads: Sequence[Optional[torch.Tensor]]
                     ) -> List[Optional[torch.Tensor]]:
    return list(grads)
