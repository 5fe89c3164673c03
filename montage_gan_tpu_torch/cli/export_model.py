"""Export a trained snapshot as a frozen serving artifact.

Port of ``montage_gan_tpu/cli/export_model.py``: the whole inference
composition (``utils/serving.py``) is traced once with ``torch.export`` and
saved with its metadata, so a serving host loads it with ``torch.export.load``
and the port's kernel operators, without the model code.  A torch export is
traced on one device, so the port takes ``--device`` where the JAX CLI takes
``--platforms``.

    python -m montage_gan_tpu_torch.cli.export_model \\
        --network runs/.../ema-snapshot-000100.pt --out montage.pt2 --verify
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.checkpoint import load_network
from ..utils.serving import (COMPOSITES, build_inference_fn, export_file,
                             load_file)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description='Freeze a generator snapshot '
                                            'into a serving artifact.')
    p.add_argument('--network', required=True, metavar='PATH',
                   help='port checkpoint, or JAX EMA snapshot (.msgpack + .json)')
    p.add_argument('--out', required=True, metavar='FILE')
    p.add_argument('--platforms', default=None,
                   help='not taken: a torch export is traced on one device '
                        '(--device)')
    p.add_argument('--batch', type=int, default=None,
                   help='pin the batch dimension; default: symbolic (any '
                        'batch)')
    p.add_argument('--trunc', dest='truncation_psi', type=float, default=1.0)
    p.add_argument('--noise-mode', choices=['const', 'random', 'none'],
                   default='const')
    p.add_argument('--composite', choices=COMPOSITES, default='alpha')
    p.add_argument('--verify', action='store_true',
                   help='reload the artifact and check it against direct '
                        'execution on --device')
    p.add_argument('--device', default='cuda',
                   help="the device the program is traced and runs on "
                        "(default 'cuda')")
    args = p.parse_args(argv)
    if args.platforms is not None:
        p.error('--platforms: a torch export is traced on one device; '
                'choose it with --device')

    device = torch.device(args.device)
    cfg, model = load_network(args.network, device=device)
    kw = dict(truncation_psi=args.truncation_psi, noise_mode=args.noise_mode,
              composite=args.composite)
    meta = export_file(args.out, cfg, model, batch=args.batch, **kw)
    print(f'exported {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB): '
          f'{meta}')

    if args.verify:
        _, call = load_file(args.out)
        b = args.batch or 2
        z = torch.from_numpy(np.random.RandomState(0).randn(b, cfg.z_dim)
                             .astype(np.float32)).to(device)
        placed_a, img_a = call(z, 7)
        placed_b, img_b = build_inference_fn(cfg, model, **kw)(z, 7)
        torch.testing.assert_close(img_a, img_b, rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(placed_a, placed_b, rtol=2e-4, atol=2e-5)
        print(f'verify OK: artifact matches direct execution at batch {b}')
    return meta


if __name__ == '__main__':
    main()
