"""W-space style-mixing grid.

Port of ``montage_gan_tpu/cli/style_mixing.py``: a row-seeds × col-seeds
grid where the styles in ``--styles`` come from the column seed and the rest
from the row seed, rendered through the local synthesis nets, the STN and
the alpha composite.  Writes ``grid.png`` and ``{row}-{col}.png``.

    python -m montage_gan_tpu_torch.cli.style_mixing --network CKPT \\
        --rows 0-3 --cols 4-7 --outdir out [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import set_fp32_precision
from ..ops.composite import alpha_composite
from ..utils.checkpoint import load_network
from ..utils.grid import make_grid, to_uint8
from ..utils.image_utils import normalize_zero1
from ..utils.png import write_png_rgba
from .generate import parse_range


def style_mix(model, ws_row: torch.Tensor, ws_col: torch.Tensor,
              col_styles: Sequence[int], noise_mode: str = 'const',
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One mixed montage ``[1, H, W, 4]`` in [0, 1]: ``ws_row`` (``[(L,)
    num_ws, w]``) with the styles ``col_styles`` taken from ``ws_col``."""
    idx = list(col_styles)
    w = ws_row.clone()
    w[..., idx, :] = ws_col[..., idx, :]
    stack = model.synthesize_layers(w[None], noise_mode=noise_mode,
                                    generator=generator)
    if model.stn is not None:
        stack, _ = model.stn(stack)
    return alpha_composite(normalize_zero1(stack.clamp(-1, 1)))


def main(argv: Optional[Sequence[str]] = None
         ) -> Dict[Tuple[int, int], np.ndarray]:
    p = argparse.ArgumentParser(description='Generate a style-mixing grid '
                                            'image.')
    p.add_argument('--network', required=True, metavar='PATH',
                   help='port checkpoint, or JAX EMA snapshot (.msgpack + .json)')
    p.add_argument('--rows', dest='row_seeds', type=parse_range,
                   required=True)
    p.add_argument('--cols', dest='col_seeds', type=parse_range,
                   required=True)
    p.add_argument('--styles', dest='col_styles', type=parse_range,
                   default=parse_range('0-6'))
    p.add_argument('--trunc', dest='truncation_psi', type=float, default=1.0)
    p.add_argument('--noise-mode', choices=['const', 'random', 'none'],
                   default='const')
    p.add_argument('--outdir', required=True)
    p.add_argument('--device', default='cuda',
                   help="torch device (default 'cuda')")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    set_fp32_precision()
    os.makedirs(args.outdir, exist_ok=True)
    cfg, model = load_network(args.network, device=device)

    all_seeds = list(dict.fromkeys(args.row_seeds + args.col_seeds))
    z = torch.from_numpy(np.stack([np.random.RandomState(s).randn(cfg.z_dim)
                                   for s in all_seeds]).astype(np.float32))
    print('Computing W vectors...')
    with torch.inference_mode():
        ws = model.mapping(z.to(device), truncation_psi=args.truncation_psi)
    w_by_seed = {seed: ws[i] for i, seed in enumerate(all_seeds)}

    print('Generating mixed images...')
    images = {}
    with torch.inference_mode():
        for rs in args.row_seeds:
            for cs in args.col_seeds:
                generator = None
                if args.noise_mode == 'random':
                    generator = torch.Generator(device=device).manual_seed(
                        rs * 10007 + cs)
                img = style_mix(model, w_by_seed[rs], w_by_seed[cs],
                                args.col_styles, args.noise_mode, generator)
                images[(rs, cs)] = img[0].cpu().numpy()

    print('Saving grid...')
    rows = [images[(rs, cs)] for rs in args.row_seeds
            for cs in args.col_seeds]
    write_png_rgba(os.path.join(args.outdir, 'grid.png'),
                   to_uint8(make_grid(np.stack(rows),
                                      nrow=len(args.col_seeds))))
    for (rs, cs), img in images.items():
        write_png_rgba(os.path.join(args.outdir, f'{rs}-{cs}.png'),
                       to_uint8(img))
    return images


if __name__ == '__main__':
    main()
