"""The local-GAN phase losses.

Port of the local part of ``montage_gan_tpu/training/losses.py`` (lines
50-253): non-saturating logistic losses, style mixing, the path-length
regularizer and R1 through the augment pipe.  Each function reads the
modules' parameters directly; the trainer asks autograd for the gradients
of the parameters its phase trains.  Path length and R1 keep the
double-backward structure (``create_graph=True``): the outer gradient
differentiates the inner one, as the reference does.  Every random tensor
comes from a ``Draws``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.ensemble import MontageEnsemble
from .augment import AugmentConfig, augment_pipe
from .draws import Draws

Stats = Dict[str, torch.Tensor]


def run_mapping_with_mixing(ens: MontageEnsemble, z: torch.Tensor,
                            draws: Draws, style_mixing_prob: float,
                            update_w_avg: bool = True) -> torch.Tensor:
    """z → ws with style mixing: with probability ``style_mixing_prob`` the
    ws from a cutoff on (one cutoff for the batch, uniform in
    ``[1, num_ws)``) come from a second z."""
    ws = ens.mapping(z, update_w_avg=update_w_avg)
    if style_mixing_prob > 0:
        num_ws = ws.shape[-2]
        u = draws.uniform([2], 'style_mixing')
        cutoff = 1 + torch.floor(u[0] * (num_ws - 1))
        cutoff = torch.where(u[1] < style_mixing_prob, cutoff,
                             torch.full_like(cutoff, num_ws))
        ws2 = ens.mapping(draws.normal(z.shape, 'style_mixing'))
        idx = torch.arange(num_ws, device=ws.device)
        mask = (idx >= cutoff).reshape((1,) * (ws.ndim - 2) + (num_ws, 1))
        ws = torch.where(mask, ws2, ws)
    return ws


def run_local_g(ens: MontageEnsemble, layer: int, z: torch.Tensor,
                draws: Draws, style_mixing_prob: float,
                update_w_avg: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """run_G for one layer: (img, ws of the layer)."""
    ws = run_mapping_with_mixing(ens, z, draws, style_mixing_prob,
                                 update_w_avg)
    ws_l = ens.ws_for_layer(ws, layer)
    return ens.local_g[layer](ws_l, noise_mode='random', generator=draws), ws_l


def run_d(d, img: torch.Tensor, aug_cfg: Optional[AugmentConfig], aug_p,
          draws: Draws) -> torch.Tensor:
    """AugmentPipe → D."""
    if aug_cfg is not None:
        img = augment_pipe(img, aug_p, aug_cfg, draws)
    return d(img)


def local_gmain_loss(ens: MontageEnsemble, layer: int, z: torch.Tensor,
                     draws: Draws, aug_cfg: Optional[AugmentConfig], aug_p,
                     style_mixing_prob: float = 0.9) -> Tuple[torch.Tensor, Stats]:
    """G's non-saturating loss against the (not trained) local D."""
    img, _ = run_local_g(ens, layer, z, draws, style_mixing_prob)
    logits = run_d(ens.local_d[layer], img, aug_cfg, aug_p, draws)
    loss = F.softplus(-logits).mean()
    return loss, {'Loss/scores/fake': logits.mean(),
                  'Loss/signs/fake': logits.sign().mean(),
                  'Loss/G/loss': loss}


def local_gpl_loss(ens: MontageEnsemble, layer: int, z: torch.Tensor,
                   draws: Draws, pl_mean: torch.Tensor,
                   pl_batch_shrink: int = 2, pl_decay: float = 0.01,
                   pl_weight: float = 2.0, style_mixing_prob: float = 0.9
                   ) -> Tuple[torch.Tensor, torch.Tensor, Stats]:
    """Path-length regularizer: the gradient of ``sum(img · noise)`` with
    respect to the layer's ws (no weight gradients in the inner pass), its
    length's deviation from the running mean.  Returns (loss, new pl_mean,
    stats)."""
    batch = z.shape[0] // pl_batch_shrink
    ws = run_mapping_with_mixing(ens, z[:batch], draws, style_mixing_prob)
    ws_l = ens.ws_for_layer(ws, layer)
    th, tw = ens.cfg.layer_targets[layer]
    pl_noise = draws.normal([batch, th, tw, ens.cfg.img_channels],
                            'pl_noise') / math.sqrt(th * tw)
    img = ens.local_g[layer](ws_l, noise_mode='random', generator=draws)
    pl_grads, = torch.autograd.grad((img * pl_noise).sum(), ws_l,
                                    create_graph=True)
    pl_lengths = pl_grads.square().sum(dim=2).mean(dim=1).sqrt()
    new_pl_mean = (pl_mean + pl_decay * (pl_lengths.mean() - pl_mean)).detach()
    pl_penalty = (pl_lengths - new_pl_mean).square()
    loss = pl_penalty.mean() * pl_weight
    return loss, new_pl_mean, {'Loss/pl_penalty': pl_penalty.mean(),
                               'Loss/G/reg': loss}


def local_dmain_loss(ens: MontageEnsemble, layer: int, z: torch.Tensor,
                     real_img: torch.Tensor, draws: Draws,
                     aug_cfg: Optional[AugmentConfig], aug_p,
                     style_mixing_prob: float = 0.9
                     ) -> Tuple[torch.Tensor, Stats, torch.Tensor]:
    """Dgen + Dreal.  The fakes (no gradient) and the reals ride through one
    augment call (every draw in the pipe is per sample); D runs on each half
    apart, since the minibatch-std groups must not mix them.  Returns (loss,
    stats, mean sign of the real logits)."""
    with torch.no_grad():
        gen_img, _ = run_local_g(ens, layer, z, draws, style_mixing_prob)
    if aug_cfg is not None:
        both = augment_pipe(torch.cat([gen_img, real_img]), aug_p, aug_cfg,
                            draws)
        gen_in, real_in = both.chunk(2)
    else:
        gen_in, real_in = gen_img, real_img
    d = ens.local_d[layer]
    gen_logits, real_logits = d(gen_in), d(real_in)
    loss = F.softplus(gen_logits).mean() + F.softplus(-real_logits).mean()
    sign_real = real_logits.sign().mean()
    return loss, {'Loss/scores/fake': gen_logits.mean(),
                  'Loss/signs/fake': gen_logits.sign().mean(),
                  'Loss/scores/real': real_logits.mean(),
                  'Loss/signs/real': sign_real,
                  'Loss/D/loss': loss}, sign_real


def local_dr1_loss(ens: MontageEnsemble, layer: int, real_img: torch.Tensor,
                   draws: Draws, aug_cfg: Optional[AugmentConfig], aug_p,
                   r1_gamma: float = 10.0
                   ) -> Tuple[torch.Tensor, Stats, torch.Tensor]:
    """R1: the gradient of D's logits with respect to the real image,
    through the augment pipe; the outer gradient reaches D's weights through
    it.  Returns (loss, stats, mean sign of the real logits)."""
    real = real_img.detach().requires_grad_(True)
    logits = run_d(ens.local_d[layer], real, aug_cfg, aug_p, draws)
    r1_grads, = torch.autograd.grad(logits.sum(), real, create_graph=True)
    r1_penalty = r1_grads.square().sum(dim=(1, 2, 3))
    loss = r1_penalty.mean() * (r1_gamma / 2)
    return loss, {'Loss/r1_penalty': r1_penalty.mean(),
                  'Loss/D/reg': loss}, logits.sign().mean()
