"""Single-GAN StyleGAN2-ADA trainer.

Port of ``montage_gan_tpu/cli/train.py`` (the reference's train.py:24-555),
with ``argparse`` in place of click and a ``--device`` flag (default
``cuda``; ``cpu`` runs the plain versions of the kernels):

    python -m montage_gan_tpu_torch.cli.train --data DIR|ZIP --outdir OUT \\
        [--cfg paper256] [--cond true] [--freezed 2] [--resume PKL|PT]

One generator and discriminator pair on a flat image folder or zip
(``data/dataset.py::ImageFolderDataset``): the 1-layer, no-global case of
the all-in-one ensemble (``layer_names=('image',)``, a 4x4 start, no global
mapping, STN or renderer), trained by the port's ``MontageTrainer`` with
ADA, R1, path length and EMA; with ``--cond`` a conditional G and D fed the
dataset's labels, each phase drawing its own permutation of a label pool;
``--freezed N`` freezes D's first N layers (Freeze-D).  A tick every 4000
images prints the status line and appends ``stats.jsonl``; every ``--snap``
ticks and at the end rank 0 writes ``network-snapshot-{kimg:06d}.pt``,
``ema-snapshot-{kimg:06d}.pt`` and a 4x4 ``fakes{kimg:06d}.png`` of the EMA
(the first 16 dataset labels with ``--cond``), and ``--metrics`` scores the
EMA G there (``metric-<name>.jsonl``).  ``--resume`` takes a reference
SG2-ADA ``.pkl`` (``utils/pkl_import.py::transfer_into_train_state``: the
entries whose name and shape match), a port train-state snapshot, an alias
of ``utils/url_util.RESUME_SPECS`` or a URL.  ``--gpus N`` starts N ranks,
one per card, as ``cli/train_aio.py`` does.  Deviations from the JAX CLI:
``--kimg`` takes fractions; the fakes grid's z is numpy's
``RandomState(0)``; ``--metrics`` with ``--cond`` raises at the start (the
JAX CLI's metric functions pass no label, and fail at the first snapshot).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..data.dataset import ImageFolderDataset
from ..models.ensemble import MontageConfig, MontageEnsemble
from ..parallel import distributed, mesh
from ..training.augment import AUGPIPE_SPECS, make_augment_config
from ..training.loop_aio import (U8_TO_MINUS11, ImageBatchPrefetcher,
                                 _stats_to_host, score_snapshot, step_seed,
                                 training_device)
from ..training.train_step import MontageTrainer, TrainHyper
from ..utils import checkpoint as ckpt
from ..utils.config import EasyDict
from ..utils.grid import save_image_grid
from ..utils.logging_utils import Logger
from ..utils.training_stats import Collector, JsonlWriter, StatsAccumulator
from ..utils.url_util import resolve_resume
from .train_aio import CFG_SPECS, _bool, next_run_dir, resolve_auto_spec

IMAGES_PER_TICK = 4000
GRID = 16


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='python -m montage_gan_tpu_torch.cli.train',
        description='Train a single StyleGAN2-ADA GAN on a CUDA card (or '
                    'the CPU with --device cpu).')
    add = p.add_argument
    add('--outdir', required=True, metavar='DIR')
    add('--data', required=True, metavar='PATH')
    add('--gpus', dest='num_devices', type=int, default=None,
        help='Ranks to spawn on this host, one per card (default: every '
             'visible card; 1 with --device cpu)')
    add('--snap', type=int, default=50)
    add('--seed', type=int, default=0)
    add('--cond', type=_bool, default=False)
    add('--mirror', type=_bool, default=False)
    add('--cfg', choices=list(CFG_SPECS), default='auto')
    add('--gamma', type=float, default=None)
    add('--kimg', type=float, default=None,
        help='Thousands of images to train on (a fraction: a few steps)')
    add('--batch', type=int, default=None)
    add('--aug', choices=['ada', 'noaug', 'fixed'], default='ada')
    add('--p', type=float, default=None)
    add('--target', type=float, default=None)
    add('--augpipe', choices=list(AUGPIPE_SPECS), default='bgc')
    add('--resume', default=None, metavar='PKL|PT|ALIAS|URL')
    add('--freezed', type=int, default=0)
    add('--fp32', type=_bool, default=False)
    add('--channel-base', type=int, default=None,
        help='Override channel_base (testing/small runs)')
    add('--channel-max', type=int, default=None)
    add('--metrics', default='none',
        help='Comma-separated metric names evaluated at snapshots, or '
             '"none"')
    add('--dry-run', action='store_true', default=False)
    add('--device', default='cuda',
        help="torch device to train on (default 'cuda')")
    return p


def num_ranks(opts: EasyDict) -> int:
    if opts.num_devices is not None:
        if opts.num_devices < 1:
            raise ValueError(f'--gpus {opts.num_devices}')
        return opts.num_devices
    if torch.device(opts.device).type == 'cuda':
        return max(torch.cuda.device_count(), 1)
    return 1


def setup(opts: EasyDict, world: int) -> EasyDict:
    """The run's dataset, ensemble config, ``TrainHyper``, batch, length and
    run directory (the JAX CLI's lines 75-116)."""
    from ..metrics import metric_main
    dataset = ImageFolderDataset(opts.data, xflip=opts.mirror,
                                 use_labels=opts.cond)
    if opts.cond and not dataset.has_labels:
        raise ValueError('--cond=True requires labels in dataset.json '
                         '(reference contract: train.py --cond)')
    metrics = ([] if opts.metrics in ('none', '') else
               metric_main.check_metrics(opts.metrics.split(',')))
    if metrics and opts.cond:
        raise ValueError('--metrics with --cond: the metrics sample the G '
                         'without labels')
    res, nch = dataset.resolution, dataset.num_channels
    spec = EasyDict(CFG_SPECS[opts.cfg])
    if opts.cfg == 'auto':
        spec = resolve_auto_spec(spec, res, world)
    batch = opts.batch or spec.mb
    if batch % world:
        raise ValueError(f'--batch {batch} does not divide over {world} '
                         'ranks')
    cfg = MontageConfig(
        layer_names=('image',), layer_targets=((res, res),),
        base_resolution=res, img_channels=nch, conv_config_index=2,
        c_dim=dataset.label_dim if opts.cond else 0,
        freeze_d_layers=opts.freezed, mapping_num_layers=spec.map,
        channel_base=opts.channel_base or int(spec.fmaps * 32768),
        channel_max=opts.channel_max or 512,
        num_fp16_res=0 if opts.fp32 else 4,
        conv_clamp=None if opts.fp32 else 256,
        mbstd_group_size=spec.mbstd, use_global_mapping=False,
        train_global=False, renderer_type='none')
    augment = (make_augment_config(opts.augpipe) if opts.aug != 'noaug'
               else None)
    extra = (dict(pl_weight=0.0, style_mixing_prob=0.0)
             if opts.cfg == 'cifar' else {})
    hyper = TrainHyper(
        lrate=spec.lrate, batch_size=batch,
        r1_gamma=opts.gamma if opts.gamma is not None else spec.gamma,
        ema_kimg=spec.ema, ema_rampup=spec.ramp, augment=augment,
        ada_target=(opts.target or 0.6) if opts.aug == 'ada' else None,
        augment_p_init=opts.p or 0.0, aug_p_max=1.0, train_global=False,
        train_renderer=False, bypass_renderer=True, **extra)
    return EasyDict(
        dataset=dataset, cfg=cfg, hyper=hyper, metrics=metrics,
        total_kimg=opts.kimg or spec.kimg,
        run_dir=next_run_dir(opts.outdir, f'{dataset.name}-{opts.cfg}'))


@torch.no_grad()
def save_fakes(path: str, ema: MontageEnsemble, dataset, cond: bool,
               dev: torch.device) -> None:
    """The EMA G's 4x4 grid, ``RandomState(0)`` z, the first 16 dataset
    labels with ``cond``."""
    z = torch.from_numpy(np.random.RandomState(0).randn(
        GRID, ema.cfg.z_dim).astype(np.float32)).to(dev)
    c = None
    if cond:
        c = torch.from_numpy(np.stack([dataset.get_label(i % len(dataset))
                                       for i in range(GRID)])).to(dev)
    ws = ema.mapping(z, c)
    imgs = ema.local_g[0](ema.ws_for_layer(ws, 0), noise_mode='const')
    save_image_grid((imgs.float().cpu().numpy() + 1) / 2, path, nrow=4)


def train_loop(run_dir: str, dataset, cfg: MontageConfig, hyper: TrainHyper,
               total_kimg: float, snap: int = 50, seed: int = 0,
               resume_path: Optional[str] = None, cond: bool = False,
               metrics: Optional[List[str]] = None, device='cuda',
               step_hook: Optional[Callable] = None):
    """Train until ``total_kimg`` thousand images; returns the final state.
    With a process group up, this process is one rank.  ``step_hook(it,
    state, stats)``, where given, is called after every step."""
    dev = training_device(device)
    rank, world = distributed.process_info()
    dp = (mesh.DataParallel.from_process_group(dev)
          if torch.distributed.is_initialized() else None)
    primary = rank == 0
    say = print if primary else (lambda *a, **k: None)
    ens = MontageEnsemble(cfg, with_d=True)
    trainer = MontageTrainer(ens, hyper, device=dev, data_parallel=dp)
    state = trainer.init_state(seed)
    if dp is not None:
        mesh.replicate((t for _, t in ckpt.train_state_tensors(state)), dp)
    if resume_path is not None:
        say(f'Resuming from "{resume_path}"')
        if resume_path.endswith('.pkl'):
            from ..utils.pkl_import import transfer_into_train_state
            state = transfer_into_train_state(state, resume_path,
                                              verbose=primary)
        else:
            state = ckpt.restore_train_state(resume_path, trainer)

    prefetcher = ImageBatchPrefetcher(
        dataset, hyper.batch_size // world, seed=seed,
        pin_memory=dev.type == 'cuda', rank=rank, num_replicas=world,
        labels=cond)
    acc = StatsAccumulator()
    collector = Collector(acc, data_parallel=dp)
    jsonl = (JsonlWriter(os.path.join(run_dir, 'stats.jsonl'))
             if primary else None)
    generator = torch.Generator(device=dev)
    lut = U8_TO_MINUS11.to(dev)
    extractor = None
    cur_nimg = cur_tick = tick_start = it = 0
    pending = []
    t0 = time.time()
    say(f'Training for {total_kimg} kimg...')
    try:
        while cur_nimg < total_kimg * 1000:
            t = time.time()
            images, real_c, gen_c = prefetcher.next()
            real = lut[images.to(dev, non_blocking=True).int()]
            if cond:
                real_c = real_c.to(dev, non_blocking=True)
                gen_c = gen_c.to(dev, non_blocking=True)
            acc.report('Timing/data_fetch', time.time() - t)
            generator.manual_seed(step_seed(seed, cur_nimg))
            state, stats = trainer.train_step(state, None, [real], generator,
                                              real_c=real_c, gen_c=gen_c)
            cur_nimg += hyper.batch_size
            pending.append(_stats_to_host(stats))
            if step_hook is not None:
                step_hook(it, state, stats)
            it += 1
            done = cur_nimg >= total_kimg * 1000
            if cur_nimg - tick_start < IMAGES_PER_TICK and not done:
                continue

            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            for names, values in pending:
                acc.report_dict(dict(zip(names, values.tolist())))
            pending = []
            dt = time.time() - t0
            line = (f'tick {cur_tick:<4d} kimg {cur_nimg / 1e3:<8.1f} '
                    f'time {dt:<8.0f}s '
                    f'sec/kimg {dt / max(cur_nimg, 1) * 1e3:<6.2f}')
            if dev.type == 'cuda':
                peak = torch.cuda.max_memory_allocated(dev) / 2**30
                line += f' gpumem {peak:<6.2f}'
                acc.report('Resources/peak_gpu_mem_gb', peak)
            say(line)
            if cur_tick % snap == 0 or done:
                if dp is not None:
                    mesh.assert_replicated(ckpt.train_state_tensors(state),
                                           dp)
                snap_path = None
                if primary:
                    kimg = cur_nimg // 1000
                    snap_path = ckpt.save_train_state(run_dir, kimg, state)
                    ckpt.save_ema_snapshot(
                        os.path.join(run_dir,
                                     f'ema-snapshot-{kimg:06d}.pt'),
                        cfg, state.ema)
                if metrics:
                    if extractor is None:
                        from ..metrics.features import build_extractor
                        extractor = build_extractor('auto', device=dev)
                    score_snapshot(metrics, state.ema, dataset, extractor,
                                   run_dir, snap_path, acc, dev)
                if primary:
                    save_fakes(os.path.join(
                        run_dir, f'fakes{cur_nimg // 1000:06d}.png'),
                        state.ema, dataset, cond, dev)
                mesh.barrier(dp)
            collector.update()
            if jsonl is not None:
                jsonl.write(collector.as_dict(), timestamp=time.time())
            cur_tick += 1
            tick_start = cur_nimg
    finally:
        prefetcher.stop()
        if jsonl is not None:
            jsonl.close()
    say('Exiting...')
    return state


def _train(opts: EasyDict, run: EasyDict):
    """This process's part of the run; rank 0 tees its output into
    ``log.txt``."""
    logger = None
    if distributed.is_primary():
        os.makedirs(run.run_dir, exist_ok=True)
        logger = Logger(os.path.join(run.run_dir, 'log.txt'))
    try:
        return train_loop(run.run_dir, run.dataset, run.cfg, run.hyper,
                          run.total_kimg, snap=opts.snap, seed=opts.seed,
                          resume_path=run.resume_path, cond=opts.cond,
                          metrics=run.metrics, device=opts.device)
    finally:
        if logger is not None:
            logger.close()


def _train_rank(local_rank: int, opts: EasyDict, run: EasyDict, world: int,
                port: int) -> None:
    """One spawned rank of ``--gpus N``."""
    distributed.maybe_initialize(f'localhost:{port}', world, local_rank,
                                 local_rank, device=opts.device)
    _train(opts, run)
    distributed.shutdown()          # after success only (cli/train_aio.py)


def main(argv: Optional[Sequence[str]] = None):
    """Train; returns the final train state of this process (None for a
    dry run, and where ``--gpus N`` spawned the ranks)."""
    opts = EasyDict(vars(make_parser().parse_args(argv)))
    world = num_ranks(opts)
    run = setup(opts, world)
    print(json.dumps({'run_dir': run.run_dir, 'batch': run.hyper.batch_size,
                      'res': run.dataset.resolution,
                      'channels': run.dataset.num_channels,
                      'devices': world}, indent=2))
    if opts.dry_run:
        print('Dry run; exiting.')
        return None
    training_device(opts.device)            # no card: raise, no fallback
    run.resume_path = (None if opts.resume == 'noresume'
                       else resolve_resume(opts.resume)[0])
    if world == 1:
        return _train(opts, run)
    if torch.device(opts.device).type == 'cuda':
        if world > torch.cuda.device_count():
            raise RuntimeError(f'--gpus {world}: '
                               f'{torch.cuda.device_count()} CUDA cards '
                               'visible')
        from ..ops import cuda
        cuda.build()                        # once, before the ranks start
    distributed.launch(_train_rank, world,
                       args=(opts, run, world, distributed.free_port()),
                       device=opts.device)
    return None


if __name__ == '__main__':
    main()
