"""Shared metric machinery: feature statistics, the dataset and generator
feature loops, the options-hash cache, and the ranks' share of the work.

Port of ``montage_gan_tpu/metrics/metric_utils.py`` (the reference's
metrics/metric_utils.py): ``FeatureStats`` accumulates raw features and/or
the streaming mean and covariance (:62-138); dataset features are cached by
an options hash (:199-218); a layered sample is composited and blended on
white into RGB in [0, 255] (:231-236); generated images are the EMA
ensemble's composited RGBA (:265-280).

On the card: the generator's images stay on the device, where they are
blended on white, run through the extractor and accumulated; a dataset
batch is decoded on the host (a thread pool, as the training loop's
prefetcher does) and composited on the device.  ``FeatureStats`` keeps its
float64 sums (and, with ``capture_all``, the float32 features) on the
device; only the final statistics reach the host.

Draws: the z of generator batch ``k`` comes from a ``torch.Generator`` on
the host seeded from ``(seed, k)`` (``generator_draws``), so a batch's
draws do not depend on how many ranks share the loop.  JAX key streams
cannot be matched; the loops take an injected ``draw_fn(k, n)`` instead,
through which the tests hand them the JAX package's z.

Ranks: with a process group up (``parallel/distributed.py``), rank ``r`` of
``R`` computes the batches ``k ≡ r (mod R)``; each round's rows are
all-gathered and put back in batch order (``gather_in_order``), so every
rank accumulates exactly what one process would, in the same order.
``on_primary`` computes a result on rank 0 and hands it to the others.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.composite import alpha_composite
from ..parallel import mesh
from ..utils.image_utils import blend_white_bg

# Threads decoding a dataset batch (the training loop's DECODE_THREADS).
DECODE_THREADS = 4


class FeatureStats:
    """Raw features and/or the streaming mean and covariance, on
    ``device`` (reference contract: metrics/metric_utils.py:62-138)."""

    def __init__(self, capture_all: bool = False,
                 capture_mean_cov: bool = False,
                 max_items: Optional[int] = None, device='cpu'):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.device = torch.device(device)
        self.num_items = 0
        self.num_features = None
        self.all_features = []
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features: int):
        if self.num_features is not None:
            assert num_features == self.num_features
            return
        self.num_features = num_features
        self.raw_mean = torch.zeros([num_features], dtype=torch.float64,
                                    device=self.device)
        self.raw_cov = torch.zeros([num_features, num_features],
                                   dtype=torch.float64, device=self.device)

    def is_full(self) -> bool:
        return self.max_items is not None and self.num_items >= self.max_items

    def append(self, x):
        """``x``: ``[N, D]`` features (a tensor, or a numpy array)."""
        x = torch.as_tensor(x).to(self.device, torch.float32)
        assert x.ndim == 2
        if self.max_items is not None:
            if self.num_items >= self.max_items:
                return
            x = x[:self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.to(torch.float64)
            self.raw_mean += x64.sum(dim=0)
            self.raw_cov += x64.T @ x64

    def get_all_torch(self) -> torch.Tensor:
        """The captured features, ``[num_items, D]`` float32 on the
        device."""
        assert self.capture_all
        return torch.cat(self.all_features, dim=0)

    def get_all(self) -> np.ndarray:
        return self.get_all_torch().cpu().numpy()

    def get_mean_cov(self):
        """(mean, covariance), float64 numpy, from the device's sums."""
        assert self.capture_mean_cov
        raw_mean = self.raw_mean.cpu().numpy()
        raw_cov = self.raw_cov.cpu().numpy()
        mean = raw_mean / self.num_items
        cov = raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov

    def _host_state(self) -> dict:
        """The JAX package's pickled ``__dict__``: numpy arrays."""
        def host(t):
            return None if t is None else t.cpu().numpy()
        return dict(capture_all=self.capture_all,
                    capture_mean_cov=self.capture_mean_cov,
                    max_items=self.max_items, num_items=self.num_items,
                    num_features=self.num_features,
                    all_features=[host(x) for x in self.all_features],
                    raw_mean=host(self.raw_mean), raw_cov=host(self.raw_cov))

    def save(self, path: str):
        tmp = path + '.tmp'
        with open(tmp, 'wb') as f:
            pickle.dump(self._host_state(), f)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str, device='cpu') -> 'FeatureStats':
        with open(path, 'rb') as f:
            state = pickle.load(f)
        obj = FeatureStats(capture_all=state['capture_all'],
                           capture_mean_cov=state['capture_mean_cov'],
                           max_items=state['max_items'], device=device)
        obj.num_items = state['num_items']
        obj.num_features = state['num_features']

        def dev(a):
            return None if a is None else torch.from_numpy(
                np.asarray(a)).to(obj.device)
        obj.all_features = [dev(np.asarray(x, np.float32))
                            for x in state['all_features']]
        obj.raw_mean, obj.raw_cov = dev(state['raw_mean']), dev(
            state['raw_cov'])
        return obj


# ---------------------------------------------------------------------------
# Preprocessing: layered or RGBA images → RGB in [0, 255]
# ---------------------------------------------------------------------------

def layers_to_metric_rgb(layers01: torch.Tensor) -> torch.Tensor:
    """``[B, L, H, W, 4]`` in [0, 1] → ``[B, H, W, 3]`` in [0, 255]: the
    layers composited, blended on white (reference metric_utils.py:
    231-236), on the tensor's device."""
    rgb = blend_white_bg(alpha_composite(layers01))
    return rgb.clamp(0, 1) * 255.0


def images_to_metric_rgb(imgs01: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C]`` in [0, 1] → ``[B, H, W, 3]`` in [0, 255]: RGBA is
    blended on white, RGB passes, grey is repeated."""
    if imgs01.shape[-1] == 4:
        rgb = blend_white_bg(imgs01)
    else:
        rgb = imgs01[..., :3]
    if rgb.shape[-1] == 1:
        rgb = rgb.repeat_interleave(3, dim=-1)
    return rgb.clamp(0, 1) * 255.0


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------

def data_parallel(device) -> Optional[mesh.DataParallel]:
    """This process's place among the ranks where a process group is up."""
    if not dist.is_initialized():
        return None
    return mesh.DataParallel.from_process_group(device)


def gather_in_order(num_batches: int, compute: Callable[[int], torch.Tensor],
                    dp: Optional[mesh.DataParallel]) -> Iterator[torch.Tensor]:
    """``compute(k)`` for ``k`` in ``range(num_batches)``, yielded in batch
    order on every rank.  Without ranks this process computes every batch;
    with ``R`` ranks rank ``r`` computes ``k ≡ r (mod R)`` and each round's
    ``R`` results (float32 tensors whose leading dimension may differ) are
    all-gathered from ``dp.device``."""
    if dp is None:
        for k in range(num_batches):
            yield compute(k)
        return
    world = dp.world
    for first in range(0, num_batches, world):
        k = first + dp.rank
        local = compute(k).to(dp.device, torch.float32) \
            if k < num_batches else None
        # each rank's shape (rows first; 0 rows where it had no batch)
        meta = torch.zeros(8, dtype=torch.int64, device=dp.device)
        if local is not None:
            meta[0] = local.ndim
            meta[1:1 + local.ndim] = torch.tensor(local.shape)
        metas = [torch.empty_like(meta) for _ in range(world)]
        dist.all_gather(metas, meta)
        metas = torch.stack(metas).cpu().tolist()
        ndim = max(m[0] for m in metas)
        rows = [m[1] for m in metas]
        trail = next(m[2:1 + ndim] for m in metas if m[0])
        buf = torch.zeros([max(rows), *trail], dtype=torch.float32,
                          device=dp.device)
        if local is not None:
            buf[:local.shape[0]] = local
        parts = [torch.empty_like(buf) for _ in range(world)]
        dist.all_gather(parts, buf)
        for i in range(world):
            if first + i < num_batches:
                yield parts[i][:rows[i]]


def on_primary(fn: Callable[[], object], dp: Optional[mesh.DataParallel]):
    """``fn()`` computed on rank 0 and handed to every rank."""
    if dp is None:
        return fn()
    box = [fn() if dp.rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# ---------------------------------------------------------------------------
# The feature loops
# ---------------------------------------------------------------------------

def _draw_seed(seed: int, k: int) -> int:
    return int(np.random.SeedSequence([seed, k]).generate_state(1)[0])


def generator_draws(seed: int, k: int, batch_size: int,
                    z_dim: int) -> torch.Tensor:
    """The z of generator batch ``k``: ``[batch_size, z_dim]`` float32 from
    a host generator seeded from ``(seed, k)``."""
    g = torch.Generator().manual_seed(_draw_seed(seed, k))
    return torch.randn([batch_size, z_dim], generator=g)


def ppl_draws(seed: int, k: int, batch_size: int, z_dim: int,
              sampling: str):
    """``(z0, z1, t)`` of PPL batch ``k``, from a host generator seeded from
    ``(seed, k)``; ``t`` is 0 for endpoint sampling."""
    g = torch.Generator().manual_seed(_draw_seed(seed, k))
    z0 = torch.randn([batch_size, z_dim], generator=g)
    z1 = torch.randn([batch_size, z_dim], generator=g)
    t = (torch.rand([batch_size, 1], generator=g) if sampling == 'full'
         else torch.zeros([batch_size, 1]))
    return z0, z1, t


def dataset_cache_file(dataset, extractor, max_items, cache_dir,
                       stats_kwargs) -> str:
    """The cache file of a dataset's statistics: an md5 of the options
    (reference metric_utils.py:199-218; the JAX package's key)."""
    key = json.dumps(dict(dataset=getattr(dataset, 'path', str(dataset)),
                          n=len(dataset), extractor=extractor.name,
                          max_items=max_items, stats=sorted(stats_kwargs)),
                     sort_keys=True)
    tag = hashlib.md5(key.encode()).hexdigest()
    return os.path.join(cache_dir, f'dataset-features-{tag}.pkl')


def _report(progress_fn, tag, done, total):
    if progress_fn is not None:
        progress_fn(tag, done, total)


@torch.no_grad()
def compute_feature_stats_for_dataset(dataset, extractor,
                                      batch_size: int = 16,
                                      max_items: Optional[int] = None,
                                      cache_dir: Optional[str] = None,
                                      device='cuda',
                                      progress_fn=None,
                                      **stats_kwargs) -> FeatureStats:
    """Features of the first ``max_items`` samples (all where None) of a
    ``DatasetAIO`` (or an ``ImageFolderDataset``, whose images are not
    composited) in batches of ``batch_size``, the last one ragged,
    through ``extractor`` on ``device`` (reference contract:
    metric_utils.py:192-246); cached in ``cache_dir`` by options hash,
    written by rank 0.  Each batch is decoded to uint8 on the host and
    mapped to [0, 1] (``/ 255`` in float32, as ``DatasetAIO[i]`` does) and
    composited on the device.  Where rank 0 holds the cache file, rank 0
    alone loads it and the other ranks get empty statistics: a metric reads
    the real data's statistics on rank 0 only (``on_primary``)."""
    dev = torch.device(device)
    dp = data_parallel(dev)
    n = len(dataset) if max_items is None else min(len(dataset), max_items)
    cache_file = None
    if cache_dir is not None:
        cache_file = dataset_cache_file(dataset, extractor, max_items,
                                        cache_dir, stats_kwargs)
        if mesh.broadcast_flag(os.path.exists(cache_file), dp):
            if dp is None or dp.rank == 0:
                return FeatureStats.load(cache_file, device=dev)
            # the file is rank 0's: another rank's cache_dir may be another
            # run directory, or on another host
            return FeatureStats(max_items=n, device=dev, **stats_kwargs)

    stats = FeatureStats(max_items=n, device=dev, **stats_kwargs)
    num_batches = math.ceil(n / batch_size)
    with ThreadPoolExecutor(max_workers=DECODE_THREADS,
                            thread_name_prefix='mgt-metric-decode') as pool:
        def batch(k):
            idx = range(k * batch_size, min((k + 1) * batch_size, n))
            u8 = torch.from_numpy(np.stack(list(pool.map(dataset.load_u8,
                                                         idx)))).to(dev)
            to_rgb = (layers_to_metric_rgb if u8.ndim == 5
                      else images_to_metric_rgb)
            return extractor(to_rgb(u8.to(torch.float32) / 255.0))
        for k, feats in enumerate(gather_in_order(num_batches, batch, dp)):
            stats.append(feats)
            _report(progress_fn, 'dataset', stats.num_items, n)

    if cache_file is not None and (dp is None or dp.rank == 0):
        os.makedirs(cache_dir, exist_ok=True)
        stats.save(cache_file)
    return stats


@torch.no_grad()
def compute_feature_stats_for_generator(sample_fn: Callable, z_dim: int,
                                        extractor, num_items: int,
                                        batch_size: int = 16, seed: int = 0,
                                        device='cuda',
                                        draw_fn: Optional[Callable] = None,
                                        progress_fn=None,
                                        **stats_kwargs) -> FeatureStats:
    """Features of ``num_items`` generated images: batch ``k`` is
    ``sample_fn(z)`` (``[B, H, W, 4]`` RGBA in [0, 1] on ``device``; the
    composited EMA ensemble, reference contract: metric_utils.py:251-310)
    for ``z = draw_fn(k, batch_size)`` (default ``generator_draws``), every
    batch whole, the last cut to ``num_items``."""
    dev = torch.device(device)
    dp = data_parallel(dev)
    stats = FeatureStats(max_items=num_items, device=dev, **stats_kwargs)
    if draw_fn is None:
        def draw_fn(k, n):
            return generator_draws(seed, k, n, z_dim)

    def batch(k):
        z = torch.as_tensor(draw_fn(k, batch_size), dtype=torch.float32)
        return extractor(images_to_metric_rgb(sample_fn(z.to(dev))))
    num_batches = math.ceil(num_items / batch_size)
    for feats in gather_in_order(num_batches, batch, dp):
        stats.append(feats)
        _report(progress_fn, 'generator', stats.num_items, num_items)
    return stats


def ensemble_fns(model):
    """``(sample_fn, map_fn, synth_fn)`` of a ``MontageEnsemble`` with its
    STN (the EMA ensemble the loop scores, or a loaded snapshot): z → the
    composited RGBA in [0, 1] (the STN's placement, clipped, then the alpha
    composite; the JAX loop's ``_metric_synth``), z → ws, and ws → the same
    RGBA, with constant synthesis noise."""
    from ..utils.image_utils import normalize_zero1

    def composite(placed):
        return alpha_composite(normalize_zero1(placed.clamp(-1, 1)))

    def sample_fn(z):
        return composite(model.run_global_g(z, noise_mode='const')[0])

    def synth_fn(ws):
        return composite(model.run_global_g_from_ws(ws,
                                                    noise_mode='const')[0])
    return sample_fn, model.mapping, synth_fn


def generator_fns(mapping, synthesis):
    """``(sample_fn, map_fn, synth_fn)`` of one generator (a mapping and a
    synthesis network: a reference ``.pkl``'s, or the single G of a 1-layer
    ensemble, ``cli/train.py``'s): z → the image in [0, 1], z → ws, and
    ws → the image, with constant synthesis noise (the JAX package's
    ``cli/calc_metrics.py:66-77`` and ``cli/train.py:162-180``)."""
    def synth_fn(ws):
        return (synthesis(ws, noise_mode='const') * 0.5 + 0.5).clamp(0, 1)

    def sample_fn(z):
        return synth_fn(mapping(z))
    return sample_fn, mapping, synth_fn


def snapshot_fns(model):
    """``(sample_fn, map_fn, synth_fn)`` of a ``MontageEnsemble``: its
    single G's (``generator_fns``) where the config is a single GAN
    (``MontageConfig.single_gan``), else the composite through its STN
    (``ensemble_fns``).  An ensemble of several layers without the global
    path makes no one image, and raises."""
    cfg = model.cfg
    if cfg.single_gan:
        return generator_fns(model.mapping, model.local_g[0])
    if not cfg.train_global:
        raise ValueError(
            f'a snapshot of {cfg.num_layers} layers without the global path '
            '(train_global=False) has no composite image to score')
    return ensemble_fns(model)
