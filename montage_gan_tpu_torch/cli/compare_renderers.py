"""Renderer checkpoint evaluation: average PSNR over a layered dataset.

Port of ``montage_gan_tpu/cli/compare_renderers.py``: every sample of the
dataset (randomly placed with ``--random-place``) is rendered through each
checkpoint's renderer and scored by its PSNR against the alpha composite of
the same layers; the average over the samples is reported per checkpoint.
A checkpoint is a JAX ``.msgpack`` renderer checkpoint (``{'renderer':
{...}}`` or the bare variable tree), a reference ``.pth``/``.pth.tar``
(its ``renderer`` entry or a bare state dict, ``utils/torch_import.py``),
a port renderer checkpoint of ``cli/pretrain_renderer.py`` or a port
snapshot holding ``renderer.*`` (an EMA snapshot of ``train_aio``).

    python -m montage_gan_tpu_torch.cli.compare_renderers --data DIR \\
        --ckpt a.msgpack --ckpt ema-snapshot-000100.pt [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import set_fp32_precision
from ..data.dataset import DatasetAIO
from ..models.renderer import build_renderer
from ..ops.composite import alpha_composite
from ..utils.image_utils import normalize_minus11, random_position


def renderer_state(path: str, renderer_type: str) -> Dict[str, torch.Tensor]:
    """The renderer's state dict from a JAX ``.msgpack``, a reference
    ``.pth``/``.pth.tar``, a port renderer checkpoint (``renderer`` entry)
    or a port snapshot."""
    if path.endswith(('.pth', '.pth.tar')):
        from ..utils import torch_import
        return torch_import.renderer_state(torch_import.load_torch_file(path))
    if path.endswith('.msgpack'):
        from ..utils.checkpoint import read_flax_msgpack
        from ..utils.weights import renderer_state_dict
        raw = read_flax_msgpack(path)
        if isinstance(raw, dict) and 'renderer' in raw:
            raw = raw['renderer']
        return renderer_state_dict(raw, renderer_type)
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    if 'renderer' in ckpt:                 # cli/pretrain_renderer.py
        return ckpt['renderer']
    state = {k[len('renderer.'):]: v for k, v in ckpt['state_dict'].items()
             if k.startswith('renderer.')}
    if not state:
        raise ValueError(f'{path}: the snapshot holds no renderer')
    return state


def psnr_per_sample(renderer, stack01: torch.Tensor, sigmoid_range: bool,
                    random_place: bool,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """PSNR in dB of each sample's rendering of ``stack01`` (``[B, L, H, W,
    4]`` in [0, 1]) against its alpha composite."""
    placed01 = (random_position(stack01, generator, pad_value=0.0)
                if random_place else stack01)
    target = alpha_composite(placed01)
    out = renderer(placed01 if sigmoid_range else normalize_minus11(placed01))
    out01 = out if sigmoid_range else (out + 1.0) / 2.0
    mse = (out01 - target).square().mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(1.0 / mse.clamp_min(1e-12))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description='Average-PSNR comparison of '
                                            'renderer checkpoints over a '
                                            'dataset.')
    p.add_argument('--data', required=True, metavar='DIR',
                   help='layered dataset directory (directory of per-sample '
                        'dirs)')
    p.add_argument('--ckpt', dest='ckpts', required=True, action='append',
                   metavar='PATH',
                   help='renderer checkpoint: JAX .msgpack, reference '
                        '.pth.tar or port .pt; repeatable')
    p.add_argument('--renderer-type', choices=['tanh', 'sigmoid', 'subpixel'],
                   default='tanh')
    p.add_argument('--batch', type=int, default=16)
    p.add_argument('--random-place', action=argparse.BooleanOptionalAction,
                   default=True,
                   help='randomly translate layers before compositing')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--max-samples', type=int, default=None,
                   help='cap the number of dataset samples (default: all)')
    p.add_argument('--device', default='cuda',
                   help="torch device (default 'cuda')")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    set_fp32_precision()
    dataset = DatasetAIO(args.data)
    n = len(dataset) if args.max_samples is None else min(args.max_samples,
                                                          len(dataset))
    renderer = build_renderer(args.renderer_type,
                              img_resolution=dataset.resolution,
                              img_channels=dataset.num_channels,
                              img_layers=dataset.num_layers).to(device).eval()
    sigmoid_range = args.renderer_type == 'sigmoid'

    results = {}
    for path in args.ckpts:
        renderer.load_state_dict(renderer_state(path, args.renderer_type))
        psnrs = []
        for start in range(0, n, args.batch):
            idxs = range(start, min(start + args.batch, n))
            stack01 = torch.from_numpy(np.stack([dataset[i] for i in idxs]))
            seed = np.random.SeedSequence([args.seed, start]).generate_state(1)
            generator = torch.Generator(device=device).manual_seed(
                int(seed[0]))
            with torch.inference_mode():
                psnrs.append(psnr_per_sample(
                    renderer, stack01.to(device), sigmoid_range,
                    args.random_place, generator).cpu())
        avg = float(torch.cat(psnrs).double().mean())
        results[path] = avg
        print(f'{os.path.basename(path):40s} avg PSNR {avg:7.2f} dB '
              f'({n} samples)')
    if len(results) > 1:
        best = max(results, key=results.get)
        print(f'best: {best} ({results[best]:.2f} dB)')
    return results


if __name__ == '__main__':
    main()
