"""Stage-0 STN pretraining as an R1 GAN.

Port of ``montage_gan_tpu/cli/pretrain_stn.py`` (the reference's
fukuwarai/main_tanh.py:16-179): a discriminator judges real composites
against STN placements of pseudo-fakes (each real layer's content
re-centred) rendered by a frozen pretrained renderer; non-saturating
softplus losses, R1 on the reals (a double backward every step), the
theta-constraint penalty; a three-way batch split (D reals, D fakes, the
STN); Adam, learning rate 1e-3, betas (0.9, 0.999), for both nets.
``--renderer-ckpt`` takes a port renderer checkpoint (``.pt`` of
``pretrain-renderer``, or a snapshot holding ``renderer.*``), a JAX
``.msgpack`` or a reference ``.pth``/``.pth.tar``.  Every ``--snap-every``
steps (step 0 included) ``r1gan{step:06d}.pt`` holds D, the STN and both
optimizers.  Runs on the card unless ``--device cpu``.

    python -m montage_gan_tpu_torch pretrain-stn --data DIR --outdir OUT \\
        --renderer-ckpt renderer032000.pt [--discriminator sg2]
"""

from __future__ import annotations

import argparse
import os
import statistics
import time
from typing import Optional, Sequence

import torch

from .. import set_fp32_precision
from ..data.dataset import DatasetAIO
from ..models.renderer import build_renderer
from ..models.stn import STN, auto_stn_stages
from ..training.loop_aio import training_device
from ..training.pretrain import (DISCRIMINATORS, Stage0Batches,
                                 build_discriminator, peak_memory, stn_d_step,
                                 stn_g_step)
from ..utils.config import EasyDict
from .compare_renderers import renderer_state


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description='Pretrain the STN position '
                                            'estimator adversarially.')
    p.add_argument('--data', required=True, metavar='DIR')
    p.add_argument('--outdir', required=True, metavar='DIR')
    p.add_argument('--renderer-ckpt', required=True, metavar='PATH',
                   help='pretrained renderer: port .pt, JAX .msgpack or '
                        'reference .pth.tar')
    p.add_argument('--renderer-type', choices=['tanh', 'subpixel'],
                   default='tanh')
    p.add_argument('--batch', type=int, default=16)
    p.add_argument('--steps', type=int, default=26000)
    p.add_argument('--lr', type=float, default=1e-3)
    p.add_argument('--r1-gamma', type=float, default=10.0)
    p.add_argument('--discriminator', choices=DISCRIMINATORS, default='sg2')
    p.add_argument('--snap-every', type=int, default=1000)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda',
                   help="torch device (default 'cuda')")
    return p


def main(argv: Optional[Sequence[str]] = None) -> EasyDict:
    """Pretrain; returns D, the STN, the step records (losses, seconds),
    the data wait and the peak memory."""
    args = make_parser().parse_args(argv)
    device = training_device(args.device)          # no card: raise
    set_fp32_precision()
    os.makedirs(args.outdir, exist_ok=True)
    dataset = DatasetAIO(args.data, xflip=True)
    res, nch, nl = (dataset.resolution, dataset.num_channels,
                    dataset.num_layers)

    renderer = build_renderer(args.renderer_type, img_resolution=res,
                              img_channels=nch, img_layers=nl)
    renderer.load_state_dict(renderer_state(args.renderer_ckpt,
                                            args.renderer_type))
    renderer.to(device).eval().requires_grad_(False)
    g = torch.Generator().manual_seed(args.seed)
    stn = STN(img_resolution=res, img_channels=nch, img_layers=nl,
              num_stages=auto_stn_stages(res))
    stn.reset_parameters(g)
    d = build_discriminator(args.discriminator, res, nch)
    d.reset_parameters(g)
    stn.to(device).train()
    d.to(device).train()
    opt_d = torch.optim.Adam(d.parameters(), lr=args.lr, betas=(0.9, 0.999))
    opt_stn = torch.optim.Adam(stn.parameters(), lr=args.lr,
                               betas=(0.9, 0.999))
    batches = Stage0Batches(dataset, 3 * args.batch, device, seed=args.seed,
                            pseudo=True)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    out = EasyDict(d=d, stn=stn, renderer=renderer, records=[], step_s=[],
                   snapshots=[])
    b = args.batch
    print(f'Pretraining STN ({args.discriminator} D) for {args.steps} steps '
          f'on {device}...')
    t_start = time.perf_counter()
    try:
        for step in range(args.steps + 1):
            t0 = time.perf_counter()
            stack01, pseudo01 = batches.next()
            rec = stn_d_step(d, opt_d, stn, renderer, stack01[:b],
                             pseudo01[b:2 * b], args.r1_gamma)
            rec.update(stn_g_step(stn, opt_stn, d, renderer,
                                  pseudo01[2 * b:]))
            rec = {k: float(v) for k, v in rec.items()}   # waits for the step
            out.step_s.append(time.perf_counter() - t0)
            out.records.append(rec)
            if step % 100 == 0:
                print(f'Step: {step}, D Loss: {rec["d_loss"]:.4f}, G Loss: '
                      f'{rec["g_loss"]:.4f}, gp: {rec["gp"]:.4f}, '
                      f'renderer_mse: {rec["r_loss"]:.6f}, Time: '
                      f'{time.perf_counter() - t_start:.0f}s')
            if step % args.snap_every == 0 or step == args.steps:
                path = os.path.join(args.outdir, f'r1gan{step:06d}.pt')
                torch.save({'global_step': step,
                            'discriminator': args.discriminator,
                            'D': d.state_dict(), 'stn': stn.state_dict(),
                            'opt_d': opt_d.state_dict(),
                            'opt_stn': opt_stn.state_dict()}, path)
                out.snapshots.append(path)
    finally:
        batches.stop()
    out.data_wait_s = batches.wait_s
    out.peak_bytes = peak_memory(device)
    later = out.step_s[1:] or out.step_s
    print(f'Done: {statistics.median(later):.4f} s a step after step 0, '
          f'data wait {batches.wait_s:.3f} s in all.')
    return out


if __name__ == '__main__':
    main()
