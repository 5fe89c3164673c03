"""Improved precision and recall by k-NN manifold estimation (reference
contract: metrics/precision_recall.py:20-65; port of
``montage_gan_tpu/metrics/precision_recall.py``).

The pairwise distances run in torch on the features' device, a block of
rows at a time (at 50k × 50k the whole matrix would be 10 GB), in float64
rounded to float32 before the comparisons, where the JAX package's numpy
path keeps the float32 matrix on the host."""

from __future__ import annotations

import torch

from . import metric_utils

# Rows of the distance matrix a block (50k columns of float64: 3.3 GB).
BLOCK_ROWS = 8192


def _dist_blocks(a: torch.Tensor, b: torch.Tensor):
    """``(first row, float32 squared distances of a block of rows of a to
    every row of b)``, the sums in float64."""
    b_sq = b.square().sum(dim=1)
    for i in range(0, a.shape[0], BLOCK_ROWS):
        aa = a[i:i + BLOCK_ROWS]
        d = aa.square().sum(dim=1)[:, None] - 2 * aa @ b.T + b_sq[None]
        yield i, d.to(torch.float32)


def manifold_radii_torch(feats: torch.Tensor,
                         nhood_size: int) -> torch.Tensor:
    radii = torch.empty(feats.shape[0], dtype=torch.float32,
                        device=feats.device)
    for i, d in _dist_blocks(feats, feats):
        radii[i:i + d.shape[0]] = d.kthvalue(nhood_size + 1, dim=1).values
    return radii


def fraction_in_manifold_torch(probes: torch.Tensor, manifold: torch.Tensor,
                               radii: torch.Tensor) -> float:
    inside = 0
    for _, d in _dist_blocks(probes, manifold):
        inside += int((d <= radii[None, :]).any(dim=1).sum().item())
    return inside / probes.shape[0]


def compute_pr_torch(real: torch.Tensor, gen: torch.Tensor,
                     nhood_size: int = 3):
    """(precision, recall) of ``gen`` against ``real``: the share of each
    set's rows inside the other's k-NN manifold (``nhood_size``-th nearest
    neighbour radii), on the features' device."""
    real, gen = real.to(torch.float64), gen.to(torch.float64)
    precision = fraction_in_manifold_torch(
        gen, real, manifold_radii_torch(real, nhood_size))
    recall = fraction_in_manifold_torch(
        real, gen, manifold_radii_torch(gen, nhood_size))
    return precision, recall


def compute_pr(opts, max_real, num_gen, nhood_size: int = 3):
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
        lambda: compute_pr_torch(stats_real.get_all_torch(),
                                 stats_gen.get_all_torch(), nhood_size),
        metric_utils.data_parallel(opts.device))
