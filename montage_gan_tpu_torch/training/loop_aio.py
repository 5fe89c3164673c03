"""Host-side all-in-one training loop.

Port of ``montage_gan_tpu/training/loop_aio.py`` (the reference's
training_loop, custom/training_loop_aio.py:131-896): the dataset and its
infinite sampler, the step (``MontageTrainer.train_step``) on one card, the
per-tick status line and stat sinks (``stats.jsonl``, TensorBoard), the
reals and fakes grids and the interpolation sheet, train-state and EMA
snapshots, ``abort_fn``/``progress_fn``/``run_once``, resume.

The data path: a prefetch thread draws the sampler's indices and decodes
each sample's layer PNGs on a small thread pool (``utils/png.py``, whose
native unfilter releases the GIL), with the per-layer centred crops of the
local Ds (reference image_utils.py:246-266) computed there too.  It hands
over uint8 tensors, pinned when the step runs on the card, which the step
copies with ``non_blocking=True`` and maps to [-1, 1] on the device.

The step's draws come from a generator on the device seeded from
``(random_seed, cur_nimg)`` (the JAX loop's ``fold_in(PRNGKey(seed + 2),
cur_nimg)``).  A step's stats leave the device as one stacked tensor, copied
without waiting; the loop reads them at the tick's end.

Data parallelism: where a process group is up
(``parallel/distributed.py``; ``cli/train_aio.py --gpus N`` or
``--coordinator``), every rank runs this loop on its card with its stride
of the sampler stream at ``batch_size / world`` a step
(``parallel/mesh.py``).  A fresh state is broadcast from rank 0; a resumed
one is read by every rank.  Rank 0 alone prints and writes the options,
``stats.jsonl``, TensorBoard, the grids and the snapshots; every network
snapshot first checks that the ranks' train states are identical, and the
ranks wait for it at a barrier.

Metrics (``metrics``, names of ``metrics/metric_main.py``): at each
network snapshot the EMA ensemble is scored on the training dataset, as the
JAX loop does (``montage_gan_tpu/training/loop_aio.py:410-474``): only with
the global phases (FID needs the STN), PPL at 2000 samples, the dataset's
statistics cached under ``<run_dir>/metric-cache``, each result appended to
``metric-<name>.jsonl`` and reported as ``Metrics/<key>``.  Every rank runs
the metric on its share of the batches (``metrics/metric_utils.py``), so
no rank waits at the next collective for a whole evaluation.

Not ported: the phase executor with its AOT precompile and
``merge_locals`` (the TPU's dispatch machinery).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import DatasetAIO
from ..data.sampler import InfiniteSampler
from ..models.ensemble import MontageConfig, MontageEnsemble
from ..parallel import mesh
from ..parallel.distributed import process_info
from ..utils import checkpoint as ckpt
from ..utils.grid import save_image_grid
from ..utils.image_utils import (alpha_composite_np, crop_to_content_np,
                                 pad_center_np)
from ..utils.logging_utils import format_time
from ..utils.png import write_png_rgba
from ..utils.summary import ensemble_summary
from ..utils.training_stats import (Collector, JsonlWriter, StatsAccumulator,
                                    make_tensorboard_writer)
from .train_step import MontageTrainer, MontageTrainState, TrainHyper

# uint8 → [-1, 1] float32 with the JAX loop's rounding: u / 255, then
# · 2 - 1, each in float32.
U8_TO_MINUS11 = torch.from_numpy(
    np.arange(256, dtype=np.float32) / np.float32(255.0) * np.float32(2.0)
    - np.float32(1.0))


# Threads decoding a batch's samples (the card's machine has 8 cores; the
# PNG unfilter and zlib release the GIL).
DECODE_THREADS = 4


class BatchPrefetcher:
    """Background thread producing ``(stack, crops)`` uint8 batches: the
    layer stack ``[B, L, H, W, 4]`` and the local Ds' centred crops
    ``[B, h_l, w_l, 4]`` of each layer, in the order of the sampler's
    stream (the JAX ``BatchPrefetcher``'s; its values are these through
    ``to_device``), rank ``rank`` of ``num_replicas`` taking its stride of
    the stream.  ``pin_memory`` pins them for asynchronous copies to the
    card."""

    def __init__(self, dataset: DatasetAIO, batch_size: int,
                 layer_targets: Sequence[Sequence[int]], seed: int = 0,
                 depth: int = 3, pin_memory: bool = False, rank: int = 0,
                 num_replicas: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.layer_targets = [tuple(t) for t in layer_targets]
        self.pin_memory = pin_memory
        self.sampler = iter(InfiniteSampler(len(dataset), rank=rank,
                                            num_replicas=num_replicas,
                                            seed=seed))
        dataset.item_paths()          # list the files before the threads
        self.pool = ThreadPoolExecutor(max_workers=DECODE_THREADS,
                                       thread_name_prefix='mgt-decode')
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = False
        self._error: Optional[Exception] = None
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _empty(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.uint8,
                           pin_memory=self.pin_memory)

    def _load(self, index: int, stack: np.ndarray,
              crops: List[np.ndarray]) -> None:
        """One sample into ``stack`` and its crops into ``crops``
        (``generate_pseudo_fake_np`` and ``make_batch_for_local_d_np``,
        sample by sample)."""
        self.dataset.load_u8(index, out=stack)
        h, w = stack.shape[1:3]
        for layer, (bh, bw) in enumerate(self.layer_targets):
            centred = pad_center_np(crop_to_content_np(stack[layer]), h)
            y0, x0 = (h - bh) // 2, (w - bw) // 2
            crops[layer][...] = centred[y0:y0 + bh, x0:x0 + bw]

    def _fetch(self) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        idxs = [next(self.sampler) for _ in range(self.batch_size)]
        h, w = self.dataset.image_shape
        stack = self._empty((self.batch_size, self.dataset.num_layers, h, w,
                             4))
        crops = [self._empty((self.batch_size, bh, bw, 4))
                 for bh, bw in self.layer_targets]
        stack_np, crops_np = stack.numpy(), [c.numpy() for c in crops]
        futures = [self.pool.submit(self._load, i, stack_np[b],
                                    [c[b] for c in crops_np])
                   for b, i in enumerate(idxs)]
        for f in futures:
            f.result()
        return stack, tuple(crops)

    def _worker(self):
        try:
            while not self._stop:
                self.q.put(self._fetch())
        except Exception as e:  # surface in next(), don't hang the loop
            self._error = e
            self.q.put(None)

    def next(self) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        # Check the error flag BEFORE blocking on the queue: the dead worker
        # enqueued a single None sentinel, and every later next() must keep
        # raising instead of hanging on the empty queue.
        if self._error is not None:
            raise RuntimeError('BatchPrefetcher worker failed') \
                from self._error
        item = self.q.get()
        if item is None and self._error is not None:
            raise RuntimeError('BatchPrefetcher worker failed') \
                from self._error
        return item

    def stop(self):
        self._stop = True
        try:
            self.q.get_nowait()       # unblock a put on a full queue
        except queue.Empty:
            pass
        self.thread.join(timeout=60)
        self.pool.shutdown(wait=True)


class ImageBatchPrefetcher(BatchPrefetcher):
    """``BatchPrefetcher`` for a flat dataset (``ImageFolderDataset``, the
    single-GAN ``train``): batches ``(images, real_c, gen_c)``, the images
    ``[B, H, W, C]`` uint8 in the sampler's stream order, rank ``rank``
    taking its stride, decoded on the thread pool.  With ``labels`` the
    reals' labels and a pool of generated samples' labels (float32
    ``[B, c_dim]``; else None): the pool is drawn from the dataset's labels
    by a ``RandomState(seed + 2)``, as the JAX package's ``cli/train.py:201``
    draws it, ``batch_size * num_replicas`` indices a step, the same on
    every rank, of which each rank keeps its ``batch_size`` rows in rank
    order (the trainer's row layout, ``parallel/mesh.py``)."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 depth: int = 3, pin_memory: bool = False, rank: int = 0,
                 num_replicas: int = 1, labels: bool = False):
        self.labels = labels
        self.rank = rank
        self.global_batch = batch_size * num_replicas
        self.label_rng = np.random.RandomState(seed + 2)
        super().__init__(dataset, batch_size, (), seed=seed, depth=depth,
                         pin_memory=pin_memory, rank=rank,
                         num_replicas=num_replicas)

    def _load(self, index: int, out: np.ndarray) -> None:
        self.dataset.load_u8(index, out=out)

    def _fetch(self):
        idxs = [next(self.sampler) for _ in range(self.batch_size)]
        images = self._empty((self.batch_size, *self.dataset.image_shape))
        out = images.numpy()
        futures = [self.pool.submit(self._load, i, out[b])
                   for b, i in enumerate(idxs)]
        for f in futures:
            f.result()
        if not self.labels:
            return images, None, None
        real_c = torch.from_numpy(np.stack(
            [self.dataset.get_label(i) for i in idxs]).astype(np.float32))
        pool = self.label_rng.randint(len(self.dataset),
                                      size=self.global_batch)
        mine = pool[self.rank * self.batch_size:
                    (self.rank + 1) * self.batch_size]
        gen_c = torch.from_numpy(np.stack(
            [self.dataset.get_label(i) for i in mine]).astype(np.float32))
        return images, real_c, gen_c


def to_device(batch, lut: torch.Tensor
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """A prefetched ``(stack, crops)`` batch in [-1, 1] float32 on the
    device of ``lut`` (``U8_TO_MINUS11`` there, moved once: a copy from
    pageable memory would wait for the card), by non-blocking copies from
    pinned memory."""
    def one(u8):
        return lut[u8.to(lut.device, non_blocking=True).int()]
    stack, crops = batch
    return one(stack), [one(c) for c in crops]


def config_from_dataset(dataset: DatasetAIO, **overrides) -> MontageConfig:
    """Derive the ensemble config from dataset statistics
    (reference: custom/training_loop_aio.py:251-297)."""
    from ..models.stn import auto_stn_stages
    kwargs = dict(
        layer_names=tuple(dataset.layer_names),
        layer_targets=dataset.layer_targets,
        base_resolution=dataset.resolution,
        img_channels=dataset.num_channels,
        conv_config_index=dataset.conv_config_index,
        stn_stages=auto_stn_stages(dataset.resolution),
    )
    kwargs.update(overrides)
    return MontageConfig(**kwargs)


def training_device(device) -> torch.device:
    """``device`` as a ``torch.device`` (``'cuda'``: the current card); a
    CUDA device without a card raises (training never falls back to the
    CPU)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass --device cpu (device="cpu") '
                           'to train on the CPU')
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    return dev


def step_seed(random_seed: int, cur_nimg: int) -> int:
    """The seed of the step's draws at image count ``cur_nimg``."""
    return int(np.random.SeedSequence([random_seed + 2, cur_nimg])
               .generate_state(1, np.uint64)[0])


def _stats_to_host(stats):
    """A step's stats as (names, one stacked float32 tensor copied to the
    host without waiting); read after a synchronisation."""
    names = list(stats)
    values = torch.stack([stats[k].detach().float().reshape(())
                          for k in names])
    return names, values.to('cpu', non_blocking=True)


def training_loop(
        run_dir: str,
        dataset: DatasetAIO,
        cfg: Optional[MontageConfig] = None,
        hyper: Optional[TrainHyper] = None,
        total_kimg: float = 25000,
        kimg_per_tick: float = 4,
        image_snapshot_ticks: Optional[int] = 1,
        network_snapshot_ticks: Optional[int] = 50,
        random_seed: int = 0,
        resume_path: Optional[str] = None,
        resume_kimg: float = 0.0,
        num_devices: Optional[int] = None,
        metrics: Optional[List[str]] = None,
        abort_fn: Optional[Callable[[], bool]] = None,
        progress_fn: Optional[Callable[[int, float], None]] = None,
        run_once: bool = False,
        save_all_layers: bool = False,
        run_latent_interpolation: bool = False,
        trace_dir: Optional[str] = None,
        trace_start_iter: int = 8,
        trace_num_iters: int = 3,
        device: str = 'cuda',
) -> MontageTrainState:
    """Train until ``total_kimg`` thousand images (or one tick with
    ``run_once``, or until ``abort_fn()``); returns the final state.  With
    a process group up, this process is one rank of the data-parallel run
    (``num_devices``, where given, must be its world size)."""
    from ..metrics import metric_main
    metrics = metric_main.check_metrics(metrics)
    dev = training_device(device)
    rank, world = process_info()
    if num_devices not in (None, world):
        raise ValueError(f'num_devices={num_devices}, {world} rank(s): one '
                         'process per card (cli/train_aio.py --gpus N)')
    dp = (mesh.DataParallel.from_process_group(dev)
          if torch.distributed.is_initialized() else None)
    primary = rank == 0
    say = print if primary else (lambda *a, **k: None)
    if cfg is None:
        cfg = config_from_dataset(dataset)
    if hyper is None:
        hyper = TrainHyper()
    if hyper.batch_size % world:
        raise ValueError(f'batch {hyper.batch_size} does not divide over '
                         f'{world} ranks')

    if primary:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, 'montage_gan_options.json'),
                  'w') as f:
            json.dump({'config': str(cfg), 'hyper': str(hyper)}, f, indent=2)

    ens = MontageEnsemble(cfg, with_d=True)
    trainer = MontageTrainer(ens, hyper, device=dev, data_parallel=dp)
    say(f'Constructing state ({cfg.num_layers} layers, base '
        f'{cfg.base_resolution}px, device {dev}, {world} rank(s))...')
    if resume_path is not None:
        say(f'Resuming from "{resume_path}"')
        t0 = time.time()
        state = ckpt.restore_train_state(resume_path, trainer)
        say(f'Restored {resume_path}: {os.path.getsize(resume_path)} '
            f'bytes in {time.time() - t0:.2f} s')
    else:
        state = trainer.init_state(random_seed)
        if dp is not None:
            mesh.replicate((t for _, t in ckpt.train_state_tensors(state)),
                           dp)
    say(ensemble_summary(ens, layer_names=cfg.layer_names))

    prefetcher = BatchPrefetcher(dataset, hyper.batch_size // world,
                                 cfg.layer_targets, seed=random_seed,
                                 pin_memory=dev.type == 'cuda', rank=rank,
                                 num_replicas=world)
    jsonl = tb = profiler = None
    try:
        # reals preview + fixed grid z (reference: training_loop_aio.py:
        # 521-534)
        grid_size = min(32, hyper.batch_size)
        grid_z = np.random.RandomState(random_seed + 1).randn(grid_size,
                                                              cfg.z_dim)
        if primary:
            preview = np.stack([dataset[i % len(dataset)]
                                for i in range(grid_size)])
            save_image_grid(alpha_composite_np(preview),
                            os.path.join(run_dir, 'reals.png'), nrow=8)

        @torch.no_grad()
        def sample_fn(z: np.ndarray) -> np.ndarray:
            z = torch.from_numpy(np.asarray(z, np.float32)).to(dev)
            ema = state.ema
            if cfg.train_global:
                out = ema.run_global_g(z, noise_mode='const')[0]
            else:
                out = ema.synthesize_layers(ema.mapping(z),
                                            noise_mode='const')
            return out.float().cpu().numpy()

        metric_extractor = None
        acc = StatsAccumulator()
        collector = Collector(acc, data_parallel=dp)
        if primary:
            jsonl = JsonlWriter(os.path.join(run_dir, 'stats.jsonl'))
            tb = make_tensorboard_writer(run_dir)
        generator = torch.Generator(device=dev)
        lut = U8_TO_MINUS11.to(dev)

        cur_nimg = int(resume_kimg * 1000)
        cur_tick = 0
        tick_start_nimg = cur_nimg
        start_time = time.time()
        tick_start_time = start_time
        maintenance_time = 0.0
        pending = []                  # this tick's stats, on their way
        say(f'Training for {total_kimg} kimg...')

        it = 0
        while True:
            # ---- one training iteration -------------------------------
            t0 = time.time()
            stack, crops = to_device(prefetcher.next(), lut)
            acc.report('Timing/data_fetch', time.time() - t0)

            # profiler window (reference region annotation, custom/
            # training_loop_aio.py:511-516): a few post-warmup steps
            if primary and trace_dir is not None and it == trace_start_iter:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == 'cuda':
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            generator.manual_seed(step_seed(random_seed, cur_nimg))
            state, stats = trainer.train_step(state, stack, crops, generator)
            if (profiler is not None
                    and it >= trace_start_iter + trace_num_iters - 1):
                profiler.stop()
                os.makedirs(trace_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(trace_dir,
                                                          'trace.json'))
                profiler = None
                print(f'Wrote profiler trace to {trace_dir}')
            it += 1
            cur_nimg += hyper.batch_size
            pending.append(_stats_to_host(stats))

            done = cur_nimg >= total_kimg * 1000
            if (not done) and (cur_tick != 0) \
                    and (cur_nimg < tick_start_nimg + kimg_per_tick * 1000):
                continue

            # ---- per-tick maintenance ---------------------------------
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            for names, values in pending:
                acc.report_dict(dict(zip(names, values.tolist())))
            pending = []
            tick_end_time = time.time()
            sec_per_kimg = ((tick_end_time - tick_start_time)
                            / max(cur_nimg - tick_start_nimg, 1) * 1e3)
            fields = [f"tick {cur_tick:<5d}", f"kimg {cur_nimg / 1e3:<8.1f}",
                      f"time {format_time(tick_end_time - start_time):<12s}",
                      f"sec/tick {tick_end_time - tick_start_time:<7.1f}",
                      f"sec/kimg {sec_per_kimg:<7.2f}",
                      f"maintenance {maintenance_time:<6.1f}"]
            acc.report('Progress/tick', cur_tick)
            acc.report('Progress/kimg', cur_nimg / 1e3)
            acc.report('Timing/total_sec', tick_end_time - start_time)
            acc.report('Timing/sec_per_tick', tick_end_time - tick_start_time)
            acc.report('Timing/sec_per_kimg', sec_per_kimg)
            if dev.type == 'cuda':
                # this rank's peak so far (the reference's
                # Resources/peak_gpu_mem_gb)
                peak = torch.cuda.max_memory_allocated(dev) / 2**30
                fields.append(f"gpumem {peak:<6.2f}")
                acc.report('Resources/peak_gpu_mem_gb', peak)
            say(' '.join(fields))

            if (not done) and (abort_fn is not None) and \
                    mesh.broadcast_flag(abort_fn(), dp):
                done = True
                say('Aborting...')

            # image snapshot (EMA samples, reference :750-766)
            if primary and image_snapshot_ticks is not None and \
                    (done or cur_tick % image_snapshot_ticks == 0):
                _image_snapshot(run_dir, cur_nimg, sample_fn, grid_z,
                                grid_size, cfg, random_seed, save_all_layers,
                                run_latent_interpolation)

            # network snapshot
            snapshot_path = None
            if network_snapshot_ticks is not None and \
                    (done or cur_tick % network_snapshot_ticks == 0):
                if dp is not None:
                    t0 = time.time()
                    n = mesh.assert_replicated(
                        ckpt.train_state_tensors(state), dp)
                    say(f'Checked {n} tensors replicated over {world} ranks '
                        f'in {time.time() - t0:.2f} s')
                if primary:
                    kimg = cur_nimg // 1000
                    t0 = time.time()
                    path = ckpt.save_train_state(run_dir, kimg, state)
                    print(f'Saved {path}: {os.path.getsize(path)} bytes in '
                          f'{time.time() - t0:.2f} s')
                    snapshot_path = path
                    path = os.path.join(run_dir,
                                        f'ema-snapshot-{kimg:06d}.pt')
                    t0 = time.time()
                    ckpt.save_ema_snapshot(path, cfg, state.ema,
                                           ens.renderer)
                    print(f'Saved {path}: {os.path.getsize(path)} bytes in '
                          f'{time.time() - t0:.2f} s')
                mesh.barrier(dp)

            # metrics on the EMA ensemble (reference: training_loop_aio.py:
            # 837-857; like the reference, FID needs the global path)
            if metrics and cfg.train_global and \
                    (done or (network_snapshot_ticks is not None
                              and cur_tick % network_snapshot_ticks == 0)):
                if metric_extractor is None:
                    from ..metrics.features import build_extractor
                    metric_extractor = build_extractor('auto', device=dev)
                score_snapshot(metrics, state.ema, dataset,
                               metric_extractor, run_dir, snapshot_path,
                               acc, dev)

            collector.update()
            if jsonl is not None:
                jsonl.write(collector.as_dict(), timestamp=time.time())
            if tb is not None:
                for name, v in collector.as_dict().items():
                    tb.add_scalar(name, v.mean,
                                  global_step=int(cur_nimg / 1e3))
                tb.flush()
            if progress_fn is not None:
                progress_fn(cur_nimg // 1000, total_kimg)

            cur_tick += 1
            tick_start_nimg = cur_nimg
            tick_start_time = time.time()
            maintenance_time = tick_start_time - tick_end_time
            if done or run_once:
                break
    finally:
        if profiler is not None:
            profiler.stop()
        prefetcher.stop()
        if jsonl is not None:
            jsonl.close()
        if tb is not None:
            tb.close()
    say('Exiting...')
    return state


def score_snapshot(metrics, ema, dataset, extractor, run_dir,
                   snapshot_path, acc, dev):
    """Each metric of ``metrics`` on the EMA ensemble, or its single G
    (``metric_utils.snapshot_fns``): every rank takes its share, rank 0
    writes ``metric-<name>.jsonl``, and each result is reported into
    ``acc`` as ``Metrics/<key>`` on every rank (the collector averages the
    ranks' equal values)."""
    from ..metrics import metric_main
    from ..metrics.metric_utils import snapshot_fns
    sample_fn, map_fn, synth_fn = snapshot_fns(ema)
    for metric in metrics:
        result = metric_main.calc_metric(
            metric, dataset=dataset, sample_fn=sample_fn, map_fn=map_fn,
            synth_fn=synth_fn, ppl_samples=2000,  # in-training budget
            z_dim=ema.cfg.z_dim, extractor=extractor,
            cache_dir=os.path.join(run_dir, 'metric-cache'), device=dev)
        metric_main.report_metric(result, run_dir=run_dir,
                                  snapshot_pkl=snapshot_path)
        for k, v in result.results.items():
            acc.report(f'Metrics/{k}', v)


def _image_snapshot(run_dir, cur_nimg, sample_fn, grid_z, grid_size, cfg,
                    random_seed, save_all_layers, run_latent_interpolation):
    """The fakes grids (layers and composites) from the EMA ensemble, every
    layer as its own PNG, and the interpolation sheet."""
    batch01 = (np.clip(sample_fn(grid_z), -1, 1) + 1) / 2
    b, l, h, w, c = batch01.shape
    kimg = cur_nimg // 1000
    save_image_grid(batch01.reshape(b * l, h, w, c)[:4 * l],
                    os.path.join(run_dir, f'fakes-layer{kimg:06d}.png'),
                    nrow=l)
    save_image_grid(alpha_composite_np(batch01),
                    os.path.join(run_dir, f'fakes{kimg:06d}.png'), nrow=8)
    if save_all_layers:
        # every layer as an individual image (reference:
        # training_loop_aio.py:743-748)
        d = os.path.join(run_dir, f'fakes-layer-all{kimg:06d}')
        os.makedirs(d, exist_ok=True)
        for bi in range(b):
            for li in range(l):
                arr = (np.clip(batch01[bi, li], 0, 1) * 255).astype(np.uint8)
                write_png_rgba(os.path.join(d, f'{bi:02d}_{li:02d}.png'), arr)
    if run_latent_interpolation:
        # 9 rows × 8-step lerp sheet (reference: :536-550, 768-777)
        lerp_len, lerp_num = 8, 9
        rnd = np.random.RandomState(random_seed + 3)
        z1 = rnd.randn(lerp_num, cfg.z_dim)
        z2 = rnd.randn(lerp_num, cfg.z_dim)
        zs = np.stack([z1 + (z2 - z1) * (i / (lerp_len - 1))
                       for i in range(lerp_len)], axis=1)
        zs = zs.reshape(lerp_num * lerp_len, cfg.z_dim)
        sheets = [np.clip(sample_fn(zs[off:off + grid_size]), -1, 1)
                  for off in range(0, zs.shape[0], grid_size)]
        lerped = (np.concatenate(sheets) + 1) / 2
        save_image_grid(alpha_composite_np(lerped),
                        os.path.join(run_dir, f'interpolate{kimg:06d}.png'),
                        nrow=lerp_len)
