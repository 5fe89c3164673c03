"""Stage-0 pretraining steps: the renderer, and the STN as an R1 GAN.

The steps of ``montage_gan_tpu/cli/pretrain_renderer.py:64-84`` and
``montage_gan_tpu/cli/pretrain_stn.py:99-146`` (closures there), as
functions that ``cli/pretrain_renderer.py``, ``cli/pretrain_stn.py``, the
tests and ``chip_smoke.py`` share.  Each step leaves its gradients in the
parameters' ``.grad`` (the tests read them) and updates in place.  Batches
come from the training loop's prefetcher (threaded PNG decode into pinned
uint8) as ``[B, L, H, W, 4]`` in [0, 1] on the device.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.dataset import DatasetAIO
from ..ops.composite import alpha_composite
from ..utils.image_utils import (calc_psnr, normalize_minus11,
                                 normalize_zero1, random_position)
from .losses import theta_constrain_loss

DISCRIMINATORS = ('sg2', 'simple', 'simplev2')


# ---------------------------------------------------------------------------
# The renderer
# ---------------------------------------------------------------------------

def draw_translations(seed: int, step: int, count: int,
                      device) -> torch.Tensor:
    """``random_position``'s offsets ``[count, 2]`` in [-1, 1) of a step,
    from a CPU generator seeded by (seed, step) (the JAX CLI folds the step
    into a key; the port draws from torch generators, as its loop does)."""
    s = int(np.random.SeedSequence([seed + 1, step]).generate_state(
        1, np.uint64)[0])
    g = torch.Generator().manual_seed(s)
    return (torch.rand((count, 2), generator=g) * 2.0 - 1.0).to(device)


def renderer_step(renderer: torch.nn.Module, opt: torch.optim.Optimizer,
                  stack01: torch.Tensor, translations: torch.Tensor,
                  loss_type: str = 'mse', sigmoid_range: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: the layers ``[B, L, H, W, C]`` in [0, 1] moved by
    ``translations`` ``[B·L, 2]``, the renderer fitted to their alpha
    composite (no gradient through the target) by MSE or L1 on [0, 1];
    returns (loss, PSNR in dB of the output before the update)."""
    placed01 = random_position(stack01, pad_value=0.0,
                               translations=translations)
    target = alpha_composite(placed01).detach()
    out = renderer(placed01 if sigmoid_range else normalize_minus11(placed01))
    out01 = out if sigmoid_range else (out + 1.0) / 2.0
    diff = out01 - target
    loss = diff.square().mean() if loss_type == 'mse' else diff.abs().mean()
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach(), calc_psnr(out01.detach(), target)


# ---------------------------------------------------------------------------
# The STN, adversarially
# ---------------------------------------------------------------------------

def build_discriminator(kind: str, img_resolution: int, img_channels: int):
    """The STN pretrainer's D: the SG2 ``Discriminator`` with the JAX
    package's defaults (channel_base 32768, channel_max 512, float32), or a
    simple global D."""
    from ..models.discriminator import Discriminator
    from ..models.simple_d import (SimpleGlobalDiscriminator,
                                   SimpleGlobalDiscriminatorV2)
    if kind == 'sg2':
        return Discriminator(img_resolution=img_resolution,
                             img_channels=img_channels)
    if kind == 'simple':
        return SimpleGlobalDiscriminator(img_resolution=img_resolution,
                                         img_channels=img_channels)
    if kind == 'simplev2':
        return SimpleGlobalDiscriminatorV2(img_resolution=img_resolution,
                                           img_channels=img_channels)
    raise ValueError(f'unknown discriminator {kind!r}; one of '
                     f'{DISCRIMINATORS}')


def _set_grads(params: Sequence[torch.Tensor], loss: torch.Tensor) -> None:
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g


def stn_d_step(d: torch.nn.Module, opt_d: torch.optim.Optimizer,
               stn: torch.nn.Module, renderer: torch.nn.Module,
               real01: torch.Tensor, pseudo01: torch.Tensor,
               r1_gamma: float = 10.0) -> Dict[str, torch.Tensor]:
    """The D step (``cli/pretrain_stn.py:99-125``): the reals' composite
    against the STN's placement of the pseudo-fakes rendered by the frozen
    renderer, softplus losses and R1 on the reals (their input gradient
    differentiated again)."""
    x_real = normalize_minus11(alpha_composite(real01)).detach()
    with torch.no_grad():
        placed, _ = stn(normalize_minus11(pseudo01))
        rendered = renderer(placed)
    x = x_real.requires_grad_(True)
    real_logits = d(x)
    grads_real, = torch.autograd.grad(real_logits.sum(), x,
                                      create_graph=True)
    gp = 0.5 * r1_gamma * grads_real.square().sum(dim=(1, 2, 3)).mean()
    fake_logits = d(rendered)
    loss = (F.softplus(-real_logits).mean() + gp
            + F.softplus(fake_logits).mean())
    params = [p for p in d.parameters() if p.requires_grad]
    _set_grads(params, loss)
    opt_d.step()
    return dict(d_loss=loss.detach(), score_real=real_logits.detach().mean(),
                gp=gp.detach())


def stn_g_step(stn: torch.nn.Module, opt_stn: torch.optim.Optimizer,
               d: torch.nn.Module, renderer: torch.nn.Module,
               pseudo01: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The STN step (``cli/pretrain_stn.py:127-146``): the non-saturating G
    loss of the rendered placement plus ``theta_constrain_loss``; the
    renderer's MSE against the alpha composite of the placement is a
    metric."""
    placed, theta = stn(normalize_minus11(pseudo01))
    rendered = renderer(placed)
    logits = d(rendered)
    g_loss = F.softplus(-logits).mean()
    c_loss = theta_constrain_loss(theta)
    target = alpha_composite(normalize_zero1(placed.detach()))
    r_loss = (normalize_zero1(rendered) - target).square().mean()
    loss = g_loss + c_loss
    _set_grads(list(stn.parameters()), loss)
    opt_stn.step()
    return dict(g_loss=loss.detach(), g_r1=g_loss.detach(),
                g_con=c_loss.detach(), r_loss=r_loss.detach(),
                score_fake=logits.detach().mean())


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

class Stage0Batches:
    """Batches of ``DatasetAIO`` on ``device`` in [0, 1] through the
    loop's ``BatchPrefetcher`` (threaded decode, pinned uint8 on the card,
    the sampler's stream).  With ``pseudo`` each batch also carries its
    pseudo-fakes (every layer's content re-centred,
    ``generate_pseudo_fake_np``), made by the prefetcher's threads as the
    local Ds' full-size crops.  ``wait_s`` sums the seconds ``next`` waited
    for the host."""

    def __init__(self, dataset: DatasetAIO, batch: int, device,
                 seed: int = 0, pseudo: bool = False):
        from .loop_aio import BatchPrefetcher
        h, w = dataset.image_shape
        self.device = torch.device(device)
        self.pseudo = pseudo
        self.prefetcher = BatchPrefetcher(
            dataset, batch, [(h, w)] * dataset.num_layers if pseudo else [],
            seed=seed, pin_memory=self.device.type == 'cuda')
        self.lut = (torch.arange(256, dtype=torch.float32)
                    / np.float32(255.0)).to(self.device)
        self.wait_s = 0.0

    def _f(self, u8: torch.Tensor) -> torch.Tensor:
        return self.lut[u8.to(self.device, non_blocking=True).int()]

    def next(self):
        """``stack01`` ``[B, L, H, W, 4]``, and with ``pseudo`` also its
        pseudo-fakes of the same shape."""
        t0 = time.perf_counter()
        stack, crops = self.prefetcher.next()
        self.wait_s += time.perf_counter() - t0
        if not self.pseudo:
            return self._f(stack)
        return self._f(stack), torch.stack([self._f(c) for c in crops],
                                           dim=1)

    def stop(self) -> None:
        self.prefetcher.stop()


def peak_memory(device) -> Optional[int]:
    """The card's peak allocated bytes since the last reset (None on the
    CPU)."""
    device = torch.device(device)
    if device.type != 'cuda':
        return None
    return int(torch.cuda.max_memory_allocated(device))
