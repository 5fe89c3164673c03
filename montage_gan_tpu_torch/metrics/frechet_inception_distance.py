"""Fréchet distance between feature distributions (reference contract:
metrics/frechet_inception_distance.py:21-40; port of
``montage_gan_tpu/metrics/frechet_inception_distance.py``).

The mean and covariance accumulate on the device in float64
(``metric_utils.FeatureStats``); the matrix square root runs on the host
through ``scipy.linalg.sqrtm``, as in the JAX package."""

from __future__ import annotations

import numpy as np
import scipy.linalg

from . import metric_utils


def compute_fid_from_stats(mu_real, sigma_real, mu_gen, sigma_gen) -> float:
    m = np.square(mu_gen - mu_real).sum()
    s = scipy.linalg.sqrtm(np.dot(sigma_gen, sigma_real))
    fid = np.real(m + np.trace(sigma_gen + sigma_real - s * 2))
    return float(fid)


def compute_fid(opts, max_real, num_gen) -> float:
    stats_real = metric_utils.compute_feature_stats_for_dataset(
        opts.dataset, opts.extractor, max_items=max_real,
        cache_dir=opts.cache_dir, capture_mean_cov=True,
        batch_size=opts.batch_size, device=opts.device,
        progress_fn=opts.progress_fn)
    stats_gen = metric_utils.compute_feature_stats_for_generator(
        opts.sample_fn, opts.z_dim, opts.extractor, num_items=num_gen,
        capture_mean_cov=True, batch_size=opts.batch_size, seed=opts.seed,
        device=opts.device, draw_fn=opts.draw_fn,
        progress_fn=opts.progress_fn)

    def fid():
        mu_r, sig_r = stats_real.get_mean_cov()
        mu_g, sig_g = stats_gen.get_mean_cov()
        return compute_fid_from_stats(mu_r, sig_r, mu_g, sig_g)
    return metric_utils.on_primary(fid, metric_utils.data_parallel(
        opts.device))
