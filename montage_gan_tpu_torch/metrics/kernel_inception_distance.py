"""Kernel Inception Distance: the polynomial-kernel MMD over feature
subsets (reference contract: metrics/kernel_inception_distance.py:19-45;
port of ``montage_gan_tpu/metrics/kernel_inception_distance.py``).

The subsets are the numpy ``RandomState(seed)`` draws of the JAX package;
the kernel sums run in torch in float64 on the features' device
(``compute_kid_torch``)."""

from __future__ import annotations

import numpy as np
import torch

from . import metric_utils


def compute_kid_torch(real: torch.Tensor, gen: torch.Tensor,
                      num_subsets: int = 100, max_subset_size: int = 1000,
                      seed: int = 0) -> float:
    """The unbiased MMD² of the cubic polynomial kernel, averaged over
    ``num_subsets`` subsets of ``min(rows, max_subset_size)`` rows of each
    set, on the features' device in float64."""
    real, gen = real.to(torch.float64), gen.to(torch.float64)
    n = real.shape[1]
    m = min(min(real.shape[0], gen.shape[0]), max_subset_size)
    rng = np.random.RandomState(seed)
    t = torch.zeros((), dtype=torch.float64, device=real.device)
    for _ in range(num_subsets):
        ix = torch.from_numpy(rng.choice(gen.shape[0], m, replace=False))
        iy = torch.from_numpy(rng.choice(real.shape[0], m, replace=False))
        x, y = gen[ix.to(gen.device)], real[iy.to(real.device)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - a.diagonal().sum()) / (m - 1) - b.sum() * 2 / m
    return float(t.item() / num_subsets / m)


def compute_kid(opts, max_real, num_gen) -> float:
    stats_real = metric_utils.compute_feature_stats_for_dataset(
        opts.dataset, opts.extractor, max_items=max_real,
        cache_dir=opts.cache_dir, capture_all=True,
        batch_size=opts.batch_size, device=opts.device,
        progress_fn=opts.progress_fn)
    stats_gen = metric_utils.compute_feature_stats_for_generator(
        opts.sample_fn, opts.z_dim, opts.extractor, num_items=num_gen,
        capture_all=True, batch_size=opts.batch_size, seed=opts.seed,
        device=opts.device, draw_fn=opts.draw_fn,
        progress_fn=opts.progress_fn)
    return metric_utils.on_primary(
        lambda: compute_kid_torch(stats_real.get_all_torch(),
                                  stats_gen.get_all_torch()),
        metric_utils.data_parallel(opts.device))
