"""Stage-0 renderer pretraining.

Port of ``montage_gan_tpu/cli/pretrain_renderer.py`` (the reference's
diff_rendering/main_united.py:17-159): real layer stacks moved to random
positions, the renderer fitted to their alpha composite by MSE or L1,
optax's AMSGrad (``training/train_step.AMSGrad``, not ``torch.optim.Adam(
amsgrad=True)``) at learning rate 1e-3, PSNR every step, and every
``--snap-every`` steps ``renderer{step:06d}.pt`` holding the renderer's and
the optimizer's state.  The offsets come from CPU generators seeded by
(seed, step) (``training/pretrain.draw_translations``).  Runs on the card
unless ``--device cpu``.

    python -m montage_gan_tpu_torch pretrain-renderer --data DIR \\
        --outdir OUT [--renderer-type tanh] [--batch 64] [--steps 32000]
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
from ..training.loop_aio import training_device
from ..training.pretrain import (Stage0Batches, draw_translations,
                                 peak_memory, renderer_step)
from ..training.train_step import AMSGrad
from ..utils.config import EasyDict


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description='Pretrain the differentiable '
                                            'renderer on randomly placed '
                                            'real layers.')
    p.add_argument('--data', required=True, metavar='DIR')
    p.add_argument('--outdir', required=True, metavar='DIR')
    p.add_argument('--renderer-type', choices=['tanh', 'sigmoid', 'subpixel'],
                   default='tanh')
    p.add_argument('--loss-type', choices=['mse', 'l1'], default='mse')
    p.add_argument('--batch', type=int, default=64)
    p.add_argument('--steps', type=int, default=32000)
    p.add_argument('--lr', type=float, default=1e-3)
    p.add_argument('--snap-every', type=int, default=4000)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda',
                   help="torch device (default 'cuda')")
    return p


def main(argv: Optional[Sequence[str]] = None) -> EasyDict:
    """Pretrain; returns the renderer, the optimizer and each step's loss,
    PSNR and seconds, the data wait and the peak memory."""
    args = make_parser().parse_args(argv)
    device = training_device(args.device)          # no card: raise
    set_fp32_precision()
    os.makedirs(args.outdir, exist_ok=True)
    dataset = DatasetAIO(args.data)
    renderer = build_renderer(args.renderer_type,
                              img_resolution=dataset.resolution,
                              img_channels=dataset.num_channels,
                              img_layers=dataset.num_layers)
    renderer.reset_parameters(torch.Generator().manual_seed(args.seed))
    renderer.to(device).train()
    opt = AMSGrad(renderer.parameters(), lr=args.lr, betas=(0.9, 0.999),
                  eps=1e-8)
    sigmoid_range = args.renderer_type == 'sigmoid'
    batches = Stage0Batches(dataset, args.batch, device, seed=args.seed)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    out = EasyDict(renderer=renderer, opt=opt, loss=[], psnr=[], step_s=[],
                   snapshots=[])
    print(f'Pretraining renderer ({args.renderer_type}, {args.loss_type}) '
          f'for {args.steps} steps, batch {args.batch} on {device}...')
    t_start = time.perf_counter()
    try:
        for step in range(1, args.steps + 1):
            t0 = time.perf_counter()
            stack01 = batches.next()
            translations = draw_translations(
                args.seed, step, stack01.shape[0] * stack01.shape[1], device)
            loss, psnr = renderer_step(renderer, opt, stack01, translations,
                                       args.loss_type, sigmoid_range)
            loss, psnr = float(loss), float(psnr)    # waits for the step
            out.step_s.append(time.perf_counter() - t0)
            out.loss.append(loss)
            out.psnr.append(psnr)
            if step % 100 == 0 or step == 1:
                print(f'step {step:6d} loss {loss:.6f} psnr {psnr:.2f} dB '
                      f'({time.perf_counter() - t_start:.0f}s)')
            if step % args.snap_every == 0 or step == args.steps:
                path = os.path.join(args.outdir, f'renderer{step:06d}.pt')
                torch.save({'global_step': step,
                            'renderer_type': args.renderer_type,
                            'renderer': renderer.state_dict(),
                            'opt_state': opt.state_dict()}, path)
                out.snapshots.append(path)
    finally:
        batches.stop()
    out.data_wait_s = batches.wait_s
    out.peak_bytes = peak_memory(device)
    later = out.step_s[1:] or out.step_s
    print(f'Done: {statistics.median(later):.4f} s a step after step 1, '
          f'data wait {batches.wait_s:.3f} s in all.')
    return out


if __name__ == '__main__':
    main()
