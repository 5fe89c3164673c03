"""All-in-one MontageGAN trainer CLI.

Port of ``montage_gan_tpu/cli/train_aio.py`` (the reference's train_aio.py
flags, its cfg preset table and augpipe presets), with ``argparse`` in place
of click and a ``--device`` flag (default ``cuda``; ``cpu`` runs the plain
versions of the kernels):

    python -m montage_gan_tpu_torch.cli.train_aio --data DIR --outdir OUT \\
        [--cfg aio] [--batch 32] [--batch-gpu 16] [--gpus N] [--device cuda]

It writes ``training_options.json``, ``log.txt`` and what the loop writes
(``training/loop_aio.py``) into ``OUT/{id:05d}-{dataset}-{cfg}``;
``--metrics fid2k,...`` (names of ``metrics/metric_main.py``) scores the
EMA ensemble at every network snapshot into ``metric-<name>.jsonl`` and
the stats' ``Metrics/<key>``.

Data parallelism, one process per card: ``--gpus N`` (default: every
visible card; 1 with ``--device cpu``) spawns N ranks on this host, which
train the global ``--batch`` at ``batch / N`` each (``--batch-gpu`` stays
the global microbatch of a round, as in the JAX CLI); the kernels are built
once before.  ``--coordinator HOST:PORT`` makes this process one rank of a
run whose ranks are started separately, on one host or several: its rank,
the world size and its card come from ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` (torchrun's names).  Only rank 0 writes files.  ``--resume``
takes a port train-state snapshot, a predefined alias or a URL
(``utils/url_util.py``: fetched through its md5-keyed cache, where one
that is already cached loads without the network).  The TPU's dispatch
machinery has no counterpart (``NOT_PORTED``); no flag waits for another
part of the port (``WAITING`` is empty).  ``--renderer-import`` is accepted and not read, as in
the JAX CLI, which never reads ``opts.renderer_import``: the run prints one
line saying so and trains the renderer it would train without it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Optional, Sequence

import torch

from ..data.dataset import DatasetAIO
from ..parallel import distributed
from ..training.augment import AUGPIPE_SPECS, make_augment_config
from ..training.loop_aio import (config_from_dataset, training_device,
                                 training_loop)
from ..training.train_step import TrainHyper
from ..utils.config import EasyDict
from ..utils.logging_utils import Logger
from ..utils.url_util import resolve_resume

# cfg presets (reference: train_aio.py:164-197).  'auto' is resolved at
# runtime from resolution/device count.
CFG_SPECS = {
    'auto':      dict(ref_gpus=-1, kimg=25000, mb=-1, mbstd=-1, fmaps=-1,
                      lrate=-1, gamma=-1, ema=-1, ramp=0.05, map=2),
    'stylegan2': dict(ref_gpus=8, kimg=25000, mb=32, mbstd=4, fmaps=1,
                      lrate=0.002, gamma=10, ema=10, ramp=None, map=8),
    'paper256':  dict(ref_gpus=8, kimg=25000, mb=64, mbstd=8, fmaps=0.5,
                      lrate=0.0025, gamma=1, ema=20, ramp=None, map=8),
    'paper512':  dict(ref_gpus=8, kimg=25000, mb=64, mbstd=8, fmaps=1,
                      lrate=0.0025, gamma=0.5, ema=20, ramp=None, map=8),
    'paper1024': dict(ref_gpus=8, kimg=25000, mb=32, mbstd=4, fmaps=1,
                      lrate=0.002, gamma=2, ema=10, ramp=None, map=8),
    'cifar':     dict(ref_gpus=2, kimg=100000, mb=64, mbstd=32, fmaps=1,
                      lrate=0.0025, gamma=0.01, ema=500, ramp=0.05, map=2),
    'aio':       dict(ref_gpus=8, kimg=25000, mb=32, mbstd=4, fmaps=0.5,
                      lrate=0.0025, gamma=10, ema=10, ramp=None, map=8),
}

# The JAX CLI's flags that select its TPU dispatch machinery (the phase
# executor's program granularity and its AOT precompile): not accepted.
NOT_PORTED = {'--merge-locals': 'queue 1, item 8',
              '--precompile': 'the TPU phase executor (not ported)',
              '--no-precompile': 'the TPU phase executor (not ported)'}
# Accepted flags whose values other than the default raise until the
# queue item named here is ported: none.
WAITING: dict = {}


def resolve_auto_spec(spec: EasyDict, res: int, num_devices: int) -> EasyDict:
    """'auto' heuristics (reference: train_aio.py:188-197)."""
    spec = EasyDict(spec)
    spec.ref_gpus = num_devices
    spec.mb = max(min(num_devices * min(4096 // res, 32), 64), num_devices)
    spec.mbstd = min(spec.mb // num_devices, 4)
    spec.fmaps = 1 if res >= 512 else 0.5
    spec.lrate = 0.002 if res >= 1024 else 0.0025
    spec.gamma = 0.0002 * (res ** 2) / spec.mb
    spec.ema = spec.mb * 10 / 32
    return spec


def next_run_dir(outdir: str, desc: str) -> str:
    """{id:05d}-{desc} auto-numbering (reference: train_aio.py:535-542)."""
    os.makedirs(outdir, exist_ok=True)
    ids = [int(m.group(1)) for d in os.listdir(outdir)
           if (m := re.match(r'^(\d+)-', d))]
    return os.path.join(outdir, f'{(max(ids) + 1 if ids else 0):05d}-{desc}')


def _bool(s: str) -> bool:
    """click's BOOL parameter type."""
    v = s.strip().lower()
    if v in ('1', 'true', 't', 'yes', 'y', 'on'):
        return True
    if v in ('0', 'false', 'f', 'no', 'n', 'off'):
        return False
    raise argparse.ArgumentTypeError(f'{s!r} is not a valid boolean')


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='python -m montage_gan_tpu_torch.cli.train_aio',
        description='Train MontageGAN all-in-one on a CUDA card (or the '
                    'CPU with --device cpu).')
    add = p.add_argument
    add('--outdir', required=True, metavar='DIR')
    add('--data', required=True, metavar='PATH',
        help='Directory-of-directories of layer PNGs')
    add('--gpus', dest='num_devices', type=int, default=None,
        help='Ranks to spawn on this host, one per card (default: every '
             'visible card; 1 with --device cpu)')
    add('--snap', dest='img_snap', type=int, default=1)
    add('--net-snap', type=int, default=50)
    add('--seed', type=int, default=0)
    add('--metrics', default='none',
        help='Comma-separated metrics scored at each network snapshot, or '
             '"none"')
    add('--mirror', type=_bool, default=False)
    add('--cfg', choices=list(CFG_SPECS), default='aio')
    add('--gamma', type=float, default=None)
    add('--kimg', type=float, default=None)
    add('--batch', type=int, default=None)
    add('--aug', choices=['ada', 'noaug', 'fixed'], default='ada')
    add('--p', type=float, default=None)
    add('--target', type=float, default=None)
    add('--augpipe', choices=list(AUGPIPE_SPECS), default='bgcfnc')
    add('--resume', default=None, metavar='PATH|ALIAS|URL',
        help='a train-state snapshot of the port (network-snapshot-*.pt), '
             'an alias of utils/url_util.RESUME_SPECS or a URL')
    add('--fp32', type=_bool, default=False)
    add('--conv-config-index', type=int, default=3,
        help='Pyramid start exponent (reference training_loop_aio.py:58)')
    for name in ('local', 'global', 'renderer'):
        add(f'--train-{name}', dest=f'train_{name}', action='store_true',
            default=True)
        add(f'--no-train-{name}', dest=f'train_{name}', action='store_false')
    add('--bypass-renderer', action='store_true', default=False)
    add('--renderer-type', choices=['tanh', 'subpixel'], default='tanh')
    add('--renderer-import', default=None, metavar='PTH',
        help='accepted and not read, as in the JAX CLI (a reference '
             'renderer .pth.tar checkpoint)')
    add('--global-optimize-interval', type=int, default=1)
    add('--aug-p-max', type=float, default=0.6)
    add('--dry-run', action='store_true', default=False)
    add('--run-once', action='store_true', default=False)
    add('--channel-base', type=int, default=None,
        help='Override channel_base (testing/small runs)')
    add('--channel-max', type=int, default=None)
    add('--kimg-per-tick', type=float, default=4,
        help='Thousands of images a tick (a fraction: a few steps)')
    add('--batch-gpu', dest='batch_gpu', type=int, default=None,
        help='Microbatch per accumulation round for local phases '
             '(reference --batch-gpu)')
    add('--global-batch-gpu', type=int, default=None,
        help='Microbatch for the global/renderer phases; defaults to '
             '--batch-gpu')
    add('--trace', dest='trace_dir', default=None, metavar='DIR',
        help='Write a torch.profiler trace of a few post-warmup steps')
    add('--save-all-layers', action='store_true', default=False)
    add('--run-latent-interpolation', action='store_true', default=False)
    add('--coordinator', default=None, metavar='HOST:PORT',
        help='Rendezvous of ranks started separately: this process is '
             'rank RANK of WORLD_SIZE, on card LOCAL_RANK (environment)')
    add('--device', default='cuda',
        help="torch device to train on (default 'cuda')")
    return p


def _check_unread(opts: EasyDict) -> None:
    if opts.renderer_import is not None:
        print(f'--renderer-import {opts.renderer_import}: not read (the JAX '
              'CLI accepts the flag and never reads it); the renderer '
              'starts from its own initialisation')


def metric_list(opts: EasyDict) -> list:
    """``--metrics`` as a list (``none``: empty); an unknown name raises,
    listing the valid ones."""
    from ..metrics import metric_main
    if opts.metrics == 'none':
        return []
    return metric_main.check_metrics(opts.metrics.split(','))


def num_ranks(opts: EasyDict) -> int:
    """The run's number of ranks: ``--gpus``, else every visible card (one
    process on the CPU); with ``--coordinator``, ``WORLD_SIZE``."""
    if opts.coordinator is not None:
        if opts.num_devices not in (None, 1):
            raise ValueError(f'--gpus {opts.num_devices} with --coordinator: '
                             'start one process per card, each with its '
                             'RANK, WORLD_SIZE and LOCAL_RANK')
        if not (os.environ.get('WORLD_SIZE') and os.environ.get('RANK')):
            raise ValueError('--coordinator: set RANK and WORLD_SIZE (and '
                             'LOCAL_RANK) of this process')
        return int(os.environ['WORLD_SIZE'])
    if opts.num_devices is not None:
        if opts.num_devices < 1:
            raise ValueError(f'--gpus {opts.num_devices}')
        return opts.num_devices
    if torch.device(opts.device).type == 'cuda':
        return max(torch.cuda.device_count(), 1)
    return 1


def setup_training_loop_kwargs(opts: EasyDict,
                               ranks: Optional[int] = None,
                               run_dir: Optional[str] = None) -> EasyDict:
    """The keyword arguments of ``training_loop`` for parsed options and
    ``ranks`` ranks (``num_ranks(opts)``): the dataset, the run directory
    (``run_dir``, else the next free id under ``--outdir``), the ensemble
    config and the ``TrainHyper``.  Without the global phases the renderer
    is bypassed and not trained, in ``opts`` too."""
    n_dev = num_ranks(opts) if ranks is None else ranks
    dataset = DatasetAIO(opts.data, xflip=opts.mirror,
                         conv_config_index=opts.conv_config_index)
    res = dataset.resolution

    spec = EasyDict(CFG_SPECS[opts.cfg])
    if opts.cfg == 'auto':
        spec = resolve_auto_spec(spec, res, n_dev)
    batch = opts.batch or spec.mb
    if batch % n_dev != 0:
        raise ValueError(f'--batch {batch} does not divide over {n_dev} '
                         'ranks')

    if not opts.train_global:
        # step-1 semantics (reference: custom/training_loop_aio.py:83-86)
        opts.train_renderer = False
        opts.bypass_renderer = True

    cfg = config_from_dataset(
        dataset,
        channel_base=opts.channel_base or int(spec.fmaps * 32768),
        channel_max=opts.channel_max or 512,
        num_fp16_res=0 if opts.fp32 else 4,
        conv_clamp=None if opts.fp32 else 256,
        mbstd_group_size=spec.mbstd,
        mapping_num_layers=spec.map,
        train_global=opts.train_global,
        renderer_type='none' if opts.bypass_renderer else opts.renderer_type)

    augment = None
    if opts.aug != 'noaug':
        augment = make_augment_config(opts.augpipe)
    ada_target = (opts.target or 0.6) if opts.aug == 'ada' else None
    augment_p = opts.p or 0.0

    # --resume: None | 'noresume' | alias | path | URL (reference:
    # train_aio.py:341-355 — resume re-tunes ADA and disables EMA rampup);
    # an alias or URL is fetched in main, unless it is a dry run
    resume_path, resume_desc = resolve_resume(opts.resume, fetch=False,
                                              verbose=False)
    is_resume = resume_path is not None

    hyper = TrainHyper(
        lrate=spec.lrate, batch_size=batch,
        r1_gamma=opts.gamma if opts.gamma is not None else spec.gamma,
        global_r1_gamma=opts.gamma if opts.gamma is not None else spec.gamma,
        ema_kimg=spec.ema, ema_rampup=None if is_resume else spec.ramp,
        augment=augment, ada_target=ada_target, augment_p_init=augment_p,
        aug_p_max=opts.aug_p_max,
        ada_kimg=100 if is_resume else 500,
        train_local=opts.train_local, train_global=opts.train_global,
        train_renderer=opts.train_renderer,
        bypass_renderer=opts.bypass_renderer,
        global_optimize_interval=opts.global_optimize_interval,
        microbatch=opts.batch_gpu,
        global_microbatch=opts.global_batch_gpu)
    hyper.global_accum_rounds        # raise now if a microbatch is no divisor
    for name in ('microbatch', 'global_microbatch'):
        value = getattr(hyper, name)
        if value is not None and value % n_dev:
            raise ValueError(f'{name} {value} does not divide over {n_dev} '
                             'ranks')

    desc = f'{dataset.name}-{opts.cfg}'
    if opts.mirror:
        desc += '-mirror'
    desc += resume_desc
    return EasyDict(
        run_dir=run_dir or next_run_dir(opts.outdir, desc), dataset=dataset,
        cfg=cfg,
        hyper=hyper, total_kimg=opts.kimg or spec.kimg,
        kimg_per_tick=opts.kimg_per_tick,
        image_snapshot_ticks=opts.img_snap,
        network_snapshot_ticks=opts.net_snap, random_seed=opts.seed,
        metrics=metric_list(opts),
        resume_path=resume_path, num_devices=n_dev,
        run_once=opts.run_once, save_all_layers=opts.save_all_layers,
        run_latent_interpolation=opts.run_latent_interpolation,
        trace_dir=opts.trace_dir, device=opts.device)


def parse_options(argv: Optional[Sequence[str]] = None) -> EasyDict:
    """The command line as options; flags that wait for another part of
    the port raise."""
    opts = EasyDict(vars(make_parser().parse_args(argv)))
    _check_unread(opts)
    metric_list(opts)
    return opts


def _train(opts: EasyDict, kwargs: EasyDict):
    """This process's part of the run: rank 0 writes the options and tees
    its output into ``log.txt``."""
    logger = None
    if distributed.is_primary():
        os.makedirs(kwargs.run_dir, exist_ok=True)
        logger = Logger(os.path.join(kwargs.run_dir, 'log.txt'))
        with open(os.path.join(kwargs.run_dir, 'training_options.json'),
                  'w') as f:
            json.dump({k: (v if isinstance(v, (int, float, bool, str,
                                               type(None))) else str(v))
                       for k, v in opts.items()}, f, indent=2)
    try:
        return training_loop(**kwargs)
    finally:
        if logger is not None:
            logger.close()


def _train_rank(local_rank: int, opts: EasyDict, kwargs: EasyDict,
                world: int, port: int) -> None:
    """One spawned rank of ``--gpus N`` (``parallel.distributed.launch``)."""
    distributed.maybe_initialize(f'localhost:{port}', world, local_rank,
                                 local_rank, device=opts.device)
    _train(opts, kwargs)
    # only after success: leaving the group waits for the other ranks, so a
    # rank that raised leaves without it (the launcher ends the others)
    distributed.shutdown()


def main(argv: Optional[Sequence[str]] = None):
    """Train MontageGAN all-in-one; returns the final train state of this
    process (None for a dry run, and where ``--gpus N`` spawned the ranks:
    they write the snapshots)."""
    opts = parse_options(argv)
    world = num_ranks(opts)
    # fetch an alias or URL before anything is written (not in a dry run)
    resume_path = None if opts.dry_run else resolve_resume(opts.resume)[0]
    kwargs = setup_training_loop_kwargs(opts, world)
    kwargs.resume_path = resume_path
    print(json.dumps({'run_dir': kwargs.run_dir,
                      'batch': kwargs.hyper.batch_size, 'devices': world,
                      'resolution': kwargs.dataset.resolution,
                      'layers': kwargs.dataset.layer_names}, indent=2))
    if opts.dry_run:
        print('Dry run; exiting.')
        return None

    training_device(opts.device)          # no card: raise, no fallback
    if opts.coordinator is not None:
        distributed.maybe_initialize(opts.coordinator, device=opts.device)
        state = _train(opts, kwargs)
        distributed.shutdown()            # after success only, as above
        return state
    if world == 1:
        return _train(opts, kwargs)
    if torch.device(opts.device).type == 'cuda':
        if world > torch.cuda.device_count():
            raise RuntimeError(f'--gpus {world}: '
                               f'{torch.cuda.device_count()} CUDA cards '
                               'visible')
        from ..ops import cuda
        cuda.build()                      # once, before the ranks start
    distributed.launch(_train_rank, world,
                       args=(opts, kwargs, world, distributed.free_port()),
                       device=opts.device)
    return None


if __name__ == '__main__':
    main()
