"""Sample montages from a snapshot, or replay a projection.

Port of ``montage_gan_tpu/cli/generate.py``: seed list → z → ensemble → the
montage as an RGBA PNG (the alpha composite, or the learned renderer with
``--composite renderer``) and, with ``--save-layers``, each placed layer;
``--projected-w`` replays a projector result (``projected_w.npz``) through
synthesis and the STN instead (``proj{idx:02d}.png``).  ``--network`` takes
a port checkpoint (``utils.checkpoint.save_checkpoint``), a JAX EMA
snapshot (``.msgpack`` with its ``.json``) or a reference SG2-ADA ``.pkl``
(read by the allowlist unpickler of ``utils/pkl_import.py``): its one
generator writes ``seed{seed:04d}.png`` (RGBA or RGB), with ``--class`` the
label of a conditional network.  A 1-layer snapshot without the global path
whose G is conditional or whose image is not RGBA (``cli/train.py``'s) is
sampled the same way, its single G's image.

    python -m montage_gan_tpu_torch.cli.generate --network CKPT \\
        --seeds 0-7 --outdir out [--device cuda]
    python -m montage_gan_tpu_torch.cli.generate --network CKPT \\
        --projected-w proj/projected_w.npz --outdir out

PNGs are written by the port's zlib encoder (``utils/png.py``), so the CLI
needs neither PIL nor click.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.composite import alpha_composite
from ..utils.checkpoint import load_network
from ..utils.image_utils import normalize_zero1
from ..utils.png import write_png, write_png_rgba
from ..utils.serving import COMPOSITES, build_inference_fn


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


def to_u8(x01: np.ndarray) -> np.ndarray:
    """[0, 1] float → uint8 with the JAX CLI's quantization."""
    return (np.clip(x01, 0, 1) * 255 + 0.5).astype(np.uint8)


def write_layers(prefix: str, placed: np.ndarray, layer_names) -> None:
    """Each placed layer ``[L, H, W, 4]`` in [-1, 1] as
    ``{prefix}-{li}_{name}.png``."""
    layers01 = (np.clip(placed, -1, 1) + 1) / 2
    for li, name in enumerate(layer_names):
        write_png_rgba(f'{prefix}-{li}_{name}.png',
                       (layers01[li] * 255 + 0.5).astype(np.uint8))


def replay(model, ws: torch.Tensor, composite: str = 'alpha'):
    """(placed layers in [-1, 1], montage in [0, 1]) of ``ws`` with constant
    noise: through the STN where the model has one, the renderer where
    ``composite='renderer'`` and the model has one, else the alpha composite
    of the clipped layers (``montage_gan_tpu/cli/generate.py:100-111``)."""
    if model.stn is not None:
        placed, _ = model.run_global_g_from_ws(ws, noise_mode='const')
    else:
        placed = model.synthesize_layers(ws, noise_mode='const')
    if composite == 'renderer' and model.renderer is not None:
        img = normalize_zero1(model.blend(placed, use_renderer=True))
    else:
        img = alpha_composite(normalize_zero1(placed.clamp(-1, 1)))
    return placed, img.clamp(0, 1)


def pkl_label(c_dim: int, class_idx: Optional[int], error) -> Optional[
        torch.Tensor]:
    """The one-hot label ``[1, c_dim]`` of ``--class`` (the reference's
    contract, generate.py:110-118): a conditional network needs a label in
    range (``error`` is called otherwise); on an unconditional one
    ``--class`` warns and is ignored."""
    if c_dim == 0:
        if class_idx is not None:
            print('warn: --class=lbl ignored when running on an '
                  'unconditional network')
        return None
    if class_idx is None:
        error('Must specify class label with --class when using a '
              'conditional network')
    if not 0 <= class_idx < c_dim:
        error(f'--class={class_idx} out of range for c_dim={c_dim}')
    label = torch.zeros(1, c_dim)
    label[0, class_idx] = 1
    return label


def write_image(path: str, img01: np.ndarray) -> None:
    """An ``[H, W, 4|3]`` image in [0, 1] as an RGBA or RGB PNG."""
    write_png(path, to_u8(img01))


def generate_pkl(args, device: torch.device, error) -> None:
    """The monolithic generator of a reference ``.pkl`` (reference flow:
    generate.py:86-124): z from ``RandomState(seed)`` → mapping (with the
    label, ``--trunc``) → synthesis (``--noise-mode``) → ``seed{seed:04d}
    .png``; or ``--projected-w`` replayed through its synthesis."""
    from ..utils.pkl_import import generator_from_pkl
    mapping, synthesis, kw = generator_from_pkl(args.network)
    mapping, synthesis = mapping.to(device), synthesis.to(device)
    if args.projected_w is not None:
        ws_all = np.load(args.projected_w)['w']
        if ws_all.ndim != 3 or ws_all.shape[1:] != (synthesis.num_ws,
                                                    kw['w_dim']):
            raise ValueError(f'projected_w shape {ws_all.shape} does not '
                             f'match the generator ({synthesis.num_ws}, '
                             f'{kw["w_dim"]})')
        for idx in range(ws_all.shape[0]):
            print(f'Replaying projected w {idx} ...')
            ws = torch.from_numpy(ws_all[idx:idx + 1].astype(np.float32))
            with torch.inference_mode():
                img = synthesis(ws.to(device), noise_mode=args.noise_mode)
            write_image(f'{args.outdir}/proj{idx:02d}.png',
                        (img[0] * 0.5 + 0.5).cpu().numpy())
        return
    sample_seeds(args, mapping, synthesis, int(kw.get('c_dim', 0) or 0),
                 kw['z_dim'], device, error)


def sample_seeds(args, mapping, synthesis, c_dim: int, z_dim: int,
                 device: torch.device, error) -> None:
    """One generator's image per seed: z from ``RandomState(seed)`` →
    mapping (with the ``--class`` label, ``--trunc``) → synthesis
    (``--noise-mode``) → ``seed{seed:04d}.png`` (RGBA or RGB)."""
    label = pkl_label(c_dim, args.class_idx, error)
    if label is not None:
        label = label.to(device)
    generator = torch.Generator(device=device)
    for seed in args.seeds:
        print(f'Generating image for seed {seed} ...')
        z = torch.from_numpy(np.random.RandomState(seed).randn(1, z_dim)
                             .astype(np.float32)).to(device)
        generator.manual_seed(seed)
        with torch.inference_mode():
            ws = mapping(z, label, truncation_psi=args.truncation_psi)
            img = synthesis(ws, noise_mode=args.noise_mode,
                            generator=generator)
        write_image(f'{args.outdir}/seed{seed:04d}.png',
                    (img[0] * 0.5 + 0.5).cpu().numpy())


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description='Generate montage images (RGBA) '
                                            'from a snapshot.')
    p.add_argument('--network', required=True, metavar='PATH',
                   help='port checkpoint, JAX EMA snapshot (.msgpack + .json) '
                        'or reference SG2-ADA .pkl')
    p.add_argument('--seeds', type=parse_range, default=None)
    p.add_argument('--projected-w', metavar='FILE', default=None,
                   help='replay a projector result (projected_w.npz) '
                        'through synthesis instead of sampling seeds')
    p.add_argument('--trunc', dest='truncation_psi', type=float, default=1.0)
    p.add_argument('--class', dest='class_idx', type=int, default=None,
                   help='class label of a conditional .pkl network')
    p.add_argument('--noise-mode', choices=['const', 'random', 'none'],
                   default='const')
    p.add_argument('--outdir', required=True, metavar='DIR')
    p.add_argument('--save-layers', action='store_true')
    p.add_argument('--composite', choices=COMPOSITES, default='alpha')
    p.add_argument('--device', default='cuda',
                   help="torch device to sample on (default 'cuda')")
    args = p.parse_args(argv)
    if args.projected_w is None and args.seeds is None:
        p.error('--seeds is required when --projected-w is not given')
    device = torch.device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    if args.network.endswith('.pkl'):
        return generate_pkl(args, device, p.error)

    cfg, model = load_network(args.network, device=device)
    if (cfg.single_gan and (cfg.c_dim > 0 or cfg.img_channels != 4)
            and args.projected_w is None):
        # a single G that the montage composition cannot take (labels, or
        # no alpha: cli/train.py's snapshots), sampled as a .pkl's G is
        return sample_seeds(args, model.mapping, model.local_g[0],
                            cfg.c_dim, cfg.z_dim, device, p.error)
    if args.class_idx is not None:
        print('warn: --class=lbl ignored when running on an unconditional '
              'network')

    if args.projected_w is not None:
        ws_all = np.load(args.projected_w)['w']
        for idx in range(ws_all.shape[0]):
            print(f'Replaying projected w {idx} ...')
            ws = torch.from_numpy(ws_all[idx:idx + 1].astype(np.float32))
            with torch.inference_mode():
                placed, img = replay(model, ws.to(device), args.composite)
            write_png_rgba(f'{args.outdir}/proj{idx:02d}.png',
                           to_u8(img[0].cpu().numpy()))
            if args.save_layers:
                write_layers(f'{args.outdir}/proj{idx:02d}',
                             placed[0].cpu().numpy(), cfg.layer_names)
        return

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
            write_layers(f'{args.outdir}/seed{seed:04d}',
                         placed[0].cpu().numpy(), cfg.layer_names)


if __name__ == '__main__':
    main()
