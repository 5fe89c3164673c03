"""Inception Score (reference contract: metrics/inception_score.py:19-38;
port of ``montage_gan_tpu/metrics/inception_score.py``).

As in the JAX package, the class probabilities are a softmax of the pool3
features (there is no classifier head), so the score is a relative
diversity proxy."""

from __future__ import annotations

import numpy as np

from . import metric_utils


def compute_is_from_probs(probs: np.ndarray, num_splits: int = 10):
    scores = []
    n = probs.shape[0]
    for i in range(num_splits):
        part = probs[i * n // num_splits:(i + 1) * n // num_splits]
        kl = part * (np.log(part + 1e-12)
                     - np.log(np.mean(part, axis=0, keepdims=True) + 1e-12))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))


def softmax_np(feats: np.ndarray) -> np.ndarray:
    e = np.exp(feats - feats.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def compute_is(opts, num_gen, num_splits: int = 10):
    stats_gen = metric_utils.compute_feature_stats_for_generator(
        opts.sample_fn, opts.z_dim, opts.extractor, num_items=num_gen,
        capture_all=True, batch_size=opts.batch_size, seed=opts.seed,
        device=opts.device, draw_fn=opts.draw_fn,
        progress_fn=opts.progress_fn)
    return metric_utils.on_primary(
        lambda: compute_is_from_probs(softmax_np(stats_gen.get_all()),
                                      num_splits),
        metric_utils.data_parallel(opts.device))
