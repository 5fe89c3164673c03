"""Infinite rank-strided shuffled index stream.

Copy of ``montage_gan_tpu/data/sampler.py`` (the reference's
InfiniteSampler, torch_utils/misc.py:117-148): an endless shuffled
permutation of dataset indices, strided by (rank, num_replicas) for data
parallelism, with window-swap reshuffling; the same seed gives the same
stream in both packages.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class InfiniteSampler:
    def __init__(self, dataset_size: int, rank: int = 0, num_replicas: int = 1,
                 shuffle: bool = True, seed: int = 0,
                 window_size: float = 0.5):
        if not (dataset_size > 0 and 0 <= rank < num_replicas
                and 0 <= window_size <= 1):
            raise ValueError(f'InfiniteSampler({dataset_size}, rank={rank}, '
                             f'num_replicas={num_replicas}, '
                             f'window_size={window_size})')
        self.dataset_size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.dataset_size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))

        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1
