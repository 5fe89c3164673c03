"""The metric registry and dispatcher.

Port of ``montage_gan_tpu/metrics/metric_main.py`` (the reference's
metrics/metric_main.py:24-176): ``@register_metric``, ``calc_metric(metric,
**options) → result dict`` and ``report_metric``, which appends the JSON
record to ``metric-<name>.jsonl``, with the same 13 names and record keys.

``MetricOptions`` carries the dataset (``DatasetAIO``), ``sample_fn`` (z →
the composited RGBA ``[B, H, W, 4]`` in [0, 1] on ``device``), ``z_dim``,
the extractor, the cache directory, the batch size, the seed, the
mapping/synthesis split for PPL (``map_fn``, ``synth_fn``), PPL's sample
budget (``ppl_samples``), the device, and injected draws (``draw_fn`` for
the generator's z, ``ppl_draw_fn`` for PPL's z0, z1, t; the tests pass the
JAX package's through them).  With a process group up every rank calls
``calc_metric``: the ranks share the batches and all return rank 0's
result (``metric_utils``); ``report_metric`` writes on rank 0 only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import torch

from ..parallel.distributed import process_info
from ..utils.config import EasyDict
from .features import build_extractor

_metric_dict: Dict[str, Callable] = {}


def register_metric(fn: Callable) -> Callable:
    assert fn.__name__ not in _metric_dict
    _metric_dict[fn.__name__] = fn
    return fn


def is_valid_metric(metric: str) -> bool:
    return metric in _metric_dict


def list_valid_metrics():
    return list(_metric_dict)


def check_metrics(metrics) -> list:
    """``metrics`` as a list; an unknown name raises, listing the valid
    ones."""
    metrics = list(metrics or [])
    for m in metrics:
        if not is_valid_metric(m):
            raise ValueError(f'unknown metric {m!r}; valid: '
                             f'{", ".join(list_valid_metrics())}')
    return metrics


class MetricOptions(EasyDict):
    def __init__(self, dataset=None, sample_fn=None, z_dim=512,
                 extractor=None, cache_dir=None, batch_size=16, seed=0,
                 progress_fn=None, map_fn=None, synth_fn=None,
                 ppl_samples=None, device='cuda', draw_fn=None,
                 ppl_draw_fn=None):
        super().__init__()
        self.dataset = dataset
        self.sample_fn = sample_fn
        self.z_dim = z_dim
        self.device = torch.device(device)
        self.extractor = (extractor if extractor is not None else
                          build_extractor('auto', device=self.device))
        self.cache_dir = cache_dir
        self.batch_size = batch_size
        self.seed = seed
        # progress_fn(tag, items done, items in all) after each batch of a
        # feature loop ('dataset', 'generator')
        self.progress_fn = progress_fn
        # The mapping/synthesis split of the generator (map_fn(z) → ws,
        # synth_fn(ws) → img [0, 1]): required by the w-space PPL variants
        # (reference perceptual_path_length.py:57-60).
        self.map_fn = map_fn
        self.synth_fn = synth_fn
        # PPL sample budget; None → the reference's 50k
        self.ppl_samples = ppl_samples
        self.draw_fn = draw_fn
        self.ppl_draw_fn = ppl_draw_fn

    @property
    def lpips_extractor(self):
        """The perceptual distance of PPL: VGG16-LPIPS where its weights are
        found (the reference's detector, perceptual_path_length.py:44-47),
        else the shared extractor."""
        if '_lpips_extractor' not in self:
            from .features import RandomFeatures
            ex = build_extractor('auto_lpips', device=self.device)
            if isinstance(ex, RandomFeatures):
                ex = self.extractor
            self['_lpips_extractor'] = ex
        return self['_lpips_extractor']


def calc_metric(metric: str, **kwargs) -> EasyDict:
    assert is_valid_metric(metric), metric
    opts = MetricOptions(**kwargs)
    start = time.time()
    with torch.no_grad():
        results = _metric_dict[metric](opts)
    return EasyDict(results=EasyDict(results), metric=metric,
                    total_time=time.time() - start,
                    num_gpus=process_info()[1])


def report_metric(result_dict: EasyDict, run_dir: Optional[str] = None,
                  snapshot_pkl: Optional[str] = None) -> None:
    """Print the record and append it to ``run_dir/metric-<name>.jsonl``
    (rank 0 only)."""
    if process_info()[0] != 0:
        return
    metric = result_dict.metric
    record = dict(result_dict, snapshot_pkl=snapshot_pkl,
                  timestamp=time.time())
    print(json.dumps(record, default=str))
    if run_dir is not None:
        with open(os.path.join(run_dir, f'metric-{metric}.jsonl'), 'at') as f:
            f.write(json.dumps(record, default=str) + '\n')


# ---------------------------------------------------------------------------
# Registered metrics (names and budgets of reference metric_main.py:88-176)
# ---------------------------------------------------------------------------

@register_metric
def fid50k_full(opts):
    from .frechet_inception_distance import compute_fid
    fid = compute_fid(opts, max_real=None, num_gen=50000)
    return {'fid50k_full': fid}


@register_metric
def fid50k(opts):
    from .frechet_inception_distance import compute_fid
    fid = compute_fid(opts, max_real=50000, num_gen=50000)
    return {'fid50k': fid}


@register_metric
def fid2k(opts):
    """Small-budget variant for in-training tracking."""
    from .frechet_inception_distance import compute_fid
    fid = compute_fid(opts, max_real=None, num_gen=2000)
    return {'fid2k': fid}


@register_metric
def kid50k_full(opts):
    from .kernel_inception_distance import compute_kid
    kid = compute_kid(opts, max_real=1000000, num_gen=50000)
    return {'kid50k_full': kid}


@register_metric
def is50k(opts):
    from .inception_score import compute_is
    mean, std = compute_is(opts, num_gen=50000)
    return {'is50k_mean': mean, 'is50k_std': std}


@register_metric
def ppl2_wend(opts):
    """PPL, w-space, endpoint sampling, 50k samples (reference:
    metric_main.py:95); ``opts.ppl_samples`` overrides the budget.  Needs
    ``opts.map_fn`` and ``opts.synth_fn``."""
    return _ppl_variant(opts, 'ppl2_wend', 'w', 'end', crop=False)


@register_metric
def pr50k3_full(opts):
    from .precision_recall import compute_pr
    precision, recall = compute_pr(opts, max_real=None, num_gen=50000,
                                   nhood_size=3)
    return {'pr50k3_full_precision': precision,
            'pr50k3_full_recall': recall}


# ---------------------------------------------------------------------------
# Legacy metrics (reference: metric_main.py:125-176): capped real sets and
# cropped PPL variants
# ---------------------------------------------------------------------------

@register_metric
def kid50k(opts):
    from .kernel_inception_distance import compute_kid
    kid = compute_kid(opts, max_real=50000, num_gen=50000)
    return {'kid50k': kid}


@register_metric
def pr50k3(opts):
    from .precision_recall import compute_pr
    precision, recall = compute_pr(opts, max_real=50000, num_gen=50000,
                                   nhood_size=3)
    return {'pr50k3_precision': precision, 'pr50k3_recall': recall}


def _ppl_variant(opts, name, space, sampling, crop):
    from .perceptual_path_length import compute_ppl
    map_fn, synth_fn = opts.map_fn, opts.synth_fn
    pair_fn = None
    if map_fn is None:
        if space == 'w':
            # never a w-space metric interpolated in z under its name
            raise ValueError(
                f"{name} requires the mapping/synthesis split "
                "(opts.map_fn + opts.synth_fn)")

        def pair_fn(z0, z1):
            return opts.sample_fn(z0), opts.sample_fn(z1)
    ppl = compute_ppl(pair_fn, opts.z_dim, opts.lpips_extractor,
                      num_samples=opts.ppl_samples or 50000,
                      epsilon=1e-4, space=space,
                      sampling=sampling, crop=crop,
                      batch_size=opts.batch_size, seed=opts.seed,
                      map_fn=map_fn, synth_fn=synth_fn, device=opts.device,
                      draw_fn=opts.ppl_draw_fn)
    return {name: ppl}


@register_metric
def ppl_zfull(opts):
    return _ppl_variant(opts, 'ppl_zfull', 'z', 'full', crop=True)


@register_metric
def ppl_wfull(opts):
    return _ppl_variant(opts, 'ppl_wfull', 'w', 'full', crop=True)


@register_metric
def ppl_zend(opts):
    return _ppl_variant(opts, 'ppl_zend', 'z', 'end', crop=True)


@register_metric
def ppl_wend(opts):
    return _ppl_variant(opts, 'ppl_wend', 'w', 'end', crop=True)
