"""Sample montages from a snapshot.

Port of the seeds path of ``montage_gan_tpu/cli/generate.py:171-194``: seed
list → z → ensemble → the composited montage as an RGBA PNG and, with
``--save-layers``, each placed layer.  ``--network`` takes a port checkpoint
(``utils.checkpoint.save_checkpoint``) or a JAX EMA snapshot (``.msgpack``
with its ``.json``).

    python -m montage_gan_tpu_torch.cli.generate --network CKPT \\
        --seeds 0-7 --outdir out [--device cuda]

PNGs are written by a small zlib encoder here, so the CLI needs neither PIL
nor click.
"""

from __future__ import annotations

import argparse
import os
import re
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils.checkpoint import load_network
from ..utils.serving import build_inference_fn


def parse_range(s: str) -> List[int]:
    """'1,2,5-10' → [1, 2, 5, …, 10]."""
    out: List[int] = []
    for part in s.split(','):
        m = re.match(r'^(\d+)-(\d+)$', part)
        if m:
            out.extend(range(int(m.group(1)), int(m.group(2)) + 1))
        else:
            out.append(int(part))
    return out


def write_png_rgba(path: str, u8: np.ndarray) -> None:
    """Write an ``[H, W, 4]`` uint8 array as an 8-bit RGBA PNG."""
    h, w, c = u8.shape
    assert c == 4 and u8.dtype == np.uint8
    raw = np.concatenate([np.zeros((h, 1), np.uint8),   # filter type 0
                          u8.reshape(h, w * 4)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack('>I', len(data)) + tag + data
                + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))

    header = struct.pack('>IIBBBBB', w, h, 8, 6, 0, 0, 0)  # 8-bit RGBA
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', header)
                + chunk(b'IDAT', zlib.compress(raw, 6)) + chunk(b'IEND', b''))


def to_u8(x01: np.ndarray) -> np.ndarray:
    """[0, 1] float → uint8 with the JAX CLI's quantization."""
    return (np.clip(x01, 0, 1) * 255 + 0.5).astype(np.uint8)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description='Generate montage images (RGBA) '
                                            'from a snapshot.')
    p.add_argument('--network', required=True, metavar='PATH',
                   help='port checkpoint, or JAX EMA snapshot (.msgpack + .json)')
    p.add_argument('--seeds', type=parse_range, required=True)
    p.add_argument('--trunc', dest='truncation_psi', type=float, default=1.0)
    p.add_argument('--noise-mode', choices=['const', 'random', 'none'],
                   default='const')
    p.add_argument('--outdir', required=True, metavar='DIR')
    p.add_argument('--save-layers', action='store_true')
    p.add_argument('--composite', choices=['alpha'], default='alpha')
    p.add_argument('--device', default='cuda',
                   help="torch device to sample on (default 'cuda')")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    cfg, model = load_network(args.network, device=device)
    sample = build_inference_fn(cfg, model,
                                truncation_psi=args.truncation_psi,
                                noise_mode=args.noise_mode,
                                composite=args.composite)
    for seed in args.seeds:
        print(f'Generating image for seed {seed} ...')
        z = torch.from_numpy(np.random.RandomState(seed).randn(1, cfg.z_dim)
                             .astype(np.float32)).to(device)
        placed, img = sample(z, seed)
        write_png_rgba(f'{args.outdir}/seed{seed:04d}.png',
                       to_u8(img[0].cpu().numpy()))
        if args.save_layers:
            layers01 = (np.clip(placed[0].cpu().numpy(), -1, 1) + 1) / 2
            for li, name in enumerate(cfg.layer_names):
                write_png_rgba(f'{args.outdir}/seed{seed:04d}-{li}_{name}.png',
                               (layers01[li] * 255 + 0.5).astype(np.uint8))


if __name__ == '__main__':
    main()
