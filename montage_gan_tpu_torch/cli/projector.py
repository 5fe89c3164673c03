"""Latent inversion: project a target image into W space.

Port of ``montage_gan_tpu/cli/projector.py``: w starts at the mapping's
average over 10,000 samples, with their spread as the scale of a ramped-down
noise added to w; Adam optimizes w and, with ``--optimize-noise``, every
synthesis layer's noise buffer under a cosine-ramped learning rate, with a
multi-scale autocorrelation penalty on the buffers, which are renormalized
after each step.  The distance is VGG16-LPIPS where its weights are found
(``metrics/features.py``), else a pixel distance plus 1e-4 times that of a
seeded random feature pyramid.

    python -m montage_gan_tpu_torch.cli.projector --network CKPT \\
        --target target.png --outdir out [--num-steps 1000] [--device cuda]

Writes ``proj.png``, ``target.png`` (the target at the model's resolution,
resized as PIL's LANCZOS does) and ``projected_w.npz`` (``w``), which
``cli/generate.py --projected-w`` replays.  ``project`` is the function the
CLI runs; ``ProjectorDraws`` lets a caller give it every random number.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import set_fp32_precision
from ..ops.composite import alpha_composite
from ..utils.image_utils import normalize_zero1, resize_lanczos_rgba

# The schedule (montage_gan_tpu/cli/projector.py:115-124).
INITIAL_LR = 0.1
INITIAL_NOISE_FACTOR = 0.05
LR_RAMPDOWN_LENGTH = 0.25
LR_RAMPUP_LENGTH = 0.05
NOISE_RAMP_LENGTH = 0.75
REGULARIZE_NOISE_WEIGHT = 1e5
W_STAT_SAMPLES = 10000


def noise_buffers(model) -> Dict[str, torch.Tensor]:
    """Every synthesis layer's ``noise_const`` by its name in the model."""
    return {f'local_g.{i}.{name}': buf
            for i, net in enumerate(model.local_g)
            for name, buf in net.named_buffers()
            if name.endswith('noise_const')}


@dataclasses.dataclass
class ProjectorDraws:
    """The projector's random numbers: ``z`` ``[W_STAT_SAMPLES, z_dim]``
    for the w statistics, ``noise`` (buffer name → initial value) for the
    trainable noise buffers, and ``w_noise(i)`` → step ``i``'s N(0, 1) noise
    of w's shape."""
    z: torch.Tensor
    noise: Dict[str, torch.Tensor]
    w_noise: Callable[[int], torch.Tensor]


def _generator(*key: int) -> torch.Generator:
    seed = np.random.SeedSequence(list(key)).generate_state(1)[0]
    return torch.Generator().manual_seed(int(seed))


def default_draws(model, seed: int) -> ProjectorDraws:
    """Draws from CPU generators keyed by ``seed``: z by ``seed``, each
    noise buffer by ``(seed + 7, its size)`` (buffers of one size start
    equal, as in the JAX projector), step i's w noise by ``(seed + 1,
    i)``."""
    cfg = model.cfg
    w_shape = (1, cfg.num_layers, model.num_ws, cfg.w_dim) \
        if cfg.use_global_mapping else (1, model.num_ws, cfg.w_dim)
    z = torch.randn(W_STAT_SAMPLES, cfg.z_dim, generator=_generator(seed))
    noise = {name: torch.randn(buf.numel(), generator=_generator(
                 seed + 7, buf.numel())).reshape(buf.shape)
             for name, buf in noise_buffers(model).items()}
    return ProjectorDraws(z, noise, lambda i: torch.randn(
        w_shape, generator=_generator(seed + 1, i)))


def noise_reg(noise: Sequence[torch.Tensor]) -> torch.Tensor:
    """Squared autocorrelation at offset 1 along each axis of each buffer,
    at every scale down to 8 pixels (``montage_gan_tpu/cli/projector.py:
    126-139``)."""
    reg = 0.0
    for n in noise:
        x = n[None, None]                                   # [1, 1, H, W]
        while True:
            reg = reg + (x * torch.roll(x, 1, 3)).mean() ** 2
            reg = reg + (x * torch.roll(x, 1, 2)).mean() ** 2
            if min(x.shape[2], x.shape[3]) <= 8:
                break
            x = F.avg_pool2d(x, 2)
    return reg


def projector_extractor(device='cuda'):
    """The distance's features: VGG16-LPIPS where its weights are found,
    else the random pyramid of seed 1 (``montage_gan_tpu/cli/projector.py:
    69-75``)."""
    from ..metrics.features import RandomFeatures, build_extractor
    extractor = build_extractor('auto_lpips', device=device)
    if isinstance(extractor, RandomFeatures):
        extractor = RandomFeatures(seed=1, device=device)
    return extractor


class _Render(nn.Module):
    """ws → the montage ``[B, H, W, 4]`` in [0, 1] with constant noise (the
    STN's placement and the alpha composite), or layer ``layer_idx`` alone
    without the STN."""

    def __init__(self, model, layer_idx: Optional[int] = None):
        super().__init__()
        self.model = model
        self.layer_idx = layer_idx

    def forward(self, ws: torch.Tensor) -> torch.Tensor:
        stack = self.model.synthesize_layers(ws, noise_mode='const')
        if self.layer_idx is not None:
            return normalize_zero1(stack[:, self.layer_idx].clamp(-1, 1))
        if self.model.stn is not None:
            stack, _ = self.model.stn(stack)
        return alpha_composite(normalize_zero1(stack.clamp(-1, 1)))


class Projector:
    """The state of one projection of ``target01`` (``[1, H, W, 4]`` in [0,
    1] on the model's device) and its step: ``loss(i, num_steps)`` builds
    step ``i``'s distance (with its graph), ``step(i, num_steps)`` takes one
    Adam step and returns the distance, ``render()`` the current image.
    The model's weights and buffers are read, never changed: the trainable
    noise buffers go in through ``torch.func.functional_call``."""

    def __init__(self, model, target01: torch.Tensor, *, seed: int = 303,
                 optimize_noise: bool = True,
                 layer_idx: Optional[int] = None, extractor=None,
                 draws: Optional[ProjectorDraws] = None):
        set_fp32_precision()
        self.model = model
        self.device = target01.device
        self.render_module = _Render(model, layer_idx)
        self.draws = draws = (default_draws(model, seed) if draws is None
                              else draws)
        self.extractor = extractor = (projector_extractor(self.device)
                                      if extractor is None else extractor)
        self.use_lpips = extractor.name == 'vgg16_lpips'
        self.target01 = target01
        with torch.no_grad():
            ws = model.mapping(draws.z.to(self.device))
            w_avg = ws.mean(dim=0, keepdim=True)
            self.w_std = (ws - w_avg).square().mean().sqrt().item()
            del ws
            self.target_features = extractor(target01[..., :3] * 255.0)
        self.w = w_avg.clone().requires_grad_(True)
        self.noise: Dict[str, torch.Tensor] = {}
        if optimize_noise:
            self.noise = {name: draws.noise[name].to(self.device).clone()
                          .requires_grad_(True)
                          for name in noise_buffers(model)}
        self.params: List[torch.Tensor] = [self.w, *self.noise.values()]
        self.optimizer = torch.optim.Adam(self.params, lr=INITIAL_LR,
                                          betas=(0.9, 0.999), eps=1e-8)

    def render(self, ws: Optional[torch.Tensor] = None) -> torch.Tensor:
        ws = self.w if ws is None else ws
        if not self.noise:
            return self.render_module(ws)
        return torch.func.functional_call(
            self.render_module, {f'model.{k}': v for k, v in
                                 self.noise.items()}, (ws,))

    def distance(self, img01: torch.Tensor) -> torch.Tensor:
        features = self.extractor(img01[..., :3] * 255.0)
        if self.use_lpips:   # squared L2 of LPIPS features: LPIPS distance
            return (features - self.target_features).square().sum()
        d = (img01 - self.target01).square().mean()
        return d + (features - self.target_features).square().mean() * 1e-4

    @staticmethod
    def schedule(i: int, num_steps: int):
        """(w noise scale factor, learning rate) of step ``i``."""
        t = i / num_steps
        noise_factor = (INITIAL_NOISE_FACTOR
                        * max(0.0, 1.0 - t / NOISE_RAMP_LENGTH) ** 2)
        ramp = min(1.0, (1.0 - t) / LR_RAMPDOWN_LENGTH)
        ramp = 0.5 - 0.5 * math.cos(ramp * math.pi)
        ramp = ramp * min(1.0, t / LR_RAMPUP_LENGTH)
        return noise_factor, INITIAL_LR * ramp

    def loss(self, i: int, num_steps: int) -> torch.Tensor:
        noise_factor, _ = self.schedule(i, num_steps)
        w_noise = self.draws.w_noise(i).to(self.device)
        d = self.distance(self.render(
            self.w + w_noise * (self.w_std * noise_factor)))
        if self.noise:
            d = d + noise_reg(list(self.noise.values())) \
                * REGULARIZE_NOISE_WEIGHT
        return d

    def step(self, i: int, num_steps: int) -> torch.Tensor:
        loss = self.loss(i, num_steps)
        grads = torch.autograd.grad(loss, self.params)
        for p, g in zip(self.params, grads):
            p.grad = g
        lr = self.schedule(i, num_steps)[1]
        for group in self.optimizer.param_groups:
            group['lr'] = lr
        self.optimizer.step()
        with torch.no_grad():
            for n in self.noise.values():
                n.copy_((n - n.mean()) / (n.std(correction=0) + 1e-8))
        return loss.detach()


@dataclasses.dataclass
class Projection:
    """What ``project`` returns."""
    w: torch.Tensor                 # [1, (L,) num_ws, w_dim]
    noise: Dict[str, torch.Tensor]  # the optimized buffers (empty without)
    image: torch.Tensor             # [1, H, W, 4] in [0, 1]
    losses: torch.Tensor            # [num_steps] on the host, each distance
    seconds: float                  # the steps' wall time, to the last loss


def project(model, target01: torch.Tensor, *, num_steps: int = 1000,
            seed: int = 303, optimize_noise: bool = True,
            layer_idx: Optional[int] = None, extractor=None,
            draws: Optional[ProjectorDraws] = None) -> Projection:
    """Project ``target01`` (``[1, H, W, 4]`` RGBA in [0, 1] at the
    model's resolution, on its device) into W in ``num_steps`` Adam steps
    (``montage_gan_tpu/cli/projector.py:36-185``).  ``extractor``: the
    distance's features (``projector_extractor()`` when None); ``draws``:
    every random number (``default_draws(model, seed)`` when None)."""
    proj = Projector(model, target01, seed=seed,
                     optimize_noise=optimize_noise, layer_idx=layer_idx,
                     extractor=extractor, draws=draws)
    losses = []
    t0 = time.perf_counter()
    for i in range(num_steps):
        losses.append(proj.step(i, num_steps))
        if (i + 1) % 100 == 0:
            print(f'step {i + 1:4d}/{num_steps}: dist '
                  f'{losses[-1].item():.4f}')
    losses = torch.stack(losses).cpu() if losses else torch.zeros(0)
    seconds = time.perf_counter() - t0
    with torch.no_grad():
        image = proj.render()
    return Projection(proj.w.detach(), {k: v.detach() for k, v in
                                         proj.noise.items()}, image, losses,
                      seconds)


def load_target(path: str, resolution: int) -> np.ndarray:
    """The target PNG as ``[res, res, 4]`` uint8, resized as PIL's
    ``Image.open(path).convert('RGBA').resize((res, res), LANCZOS)``."""
    from ..utils.png import read_png_rgba
    return resize_lanczos_rgba(read_png_rgba(path), resolution, resolution)


def main(argv: Optional[Sequence[str]] = None) -> Projection:
    from ..utils.checkpoint import load_network
    from ..utils.png import write_png_rgba

    p = argparse.ArgumentParser(description='Project a target image into '
                                            'the latent space of a snapshot.')
    p.add_argument('--network', required=True, metavar='PATH',
                   help='port checkpoint, or JAX EMA snapshot (.msgpack + .json)')
    p.add_argument('--target', required=True, metavar='FILE',
                   help='target image (8-bit RGBA or RGB PNG)')
    p.add_argument('--layer', dest='layer_idx', type=int, default=None,
                   help='project into a single local G (default: the full '
                        'ensemble)')
    p.add_argument('--num-steps', type=int, default=1000)
    p.add_argument('--seed', type=int, default=303)
    p.add_argument('--save-video', action='store_true')
    p.add_argument('--optimize-noise', action=argparse.BooleanOptionalAction,
                   default=True,
                   help='co-optimize the per-layer noise buffers')
    p.add_argument('--outdir', required=True)
    p.add_argument('--device', default='cuda',
                   help="torch device (default 'cuda')")
    args = p.parse_args(argv)
    if args.save_video:
        raise NotImplementedError('--save-video: the progress GIF needs a '
                                  'GIF writer without PIL, ROADMAP queue 1, '
                                  'item 5')

    device = torch.device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    cfg, model = load_network(args.network, device=device)
    target_u8 = load_target(args.target, cfg.base_resolution)
    target01 = torch.from_numpy(target_u8.astype(np.float32) / 255.0)[None]

    print(f'Projecting for {args.num_steps} steps...')
    result = project(model, target01.to(device), num_steps=args.num_steps,
                     seed=args.seed, optimize_noise=args.optimize_noise,
                     layer_idx=args.layer_idx,
                     extractor=projector_extractor(device))
    out01 = result.image[0].cpu().numpy()
    write_png_rgba(os.path.join(args.outdir, 'proj.png'),
                   (np.clip(out01, 0, 1) * 255).astype(np.uint8))
    write_png_rgba(os.path.join(args.outdir, 'target.png'), target_u8)
    np.savez(os.path.join(args.outdir, 'projected_w.npz'),
             w=result.w.cpu().numpy())
    print('Done.')
    return result


if __name__ == '__main__':
    main()
