"""The MontageGAN all-in-one (AIO) training step.

Port of ``montage_gan_tpu/training/train_step.py`` (``TrainHyper``,
``MontageTrainer``; the order and semantics of lines 419-818):

1. the renderer phase: the renderer against the exact composite, one
   AMSGrad step (optax's rule, ``AMSGrad`` below);
2. for each layer, Gmain, then Greg every ``g_reg_interval`` steps, then
   Dmain, then Dr1 every ``d_reg_interval`` steps, each regularizer's loss
   scaled by its interval; one Adam per phase pair with the
   lazy-regularization lr/β rebalance ``mb_ratio = r/(r+1)``; the shared
   mapping is a parameter of each of the 9 local-G optimizers, each holding
   its own moments, as in the reference;
3. every ``global_optimize_interval`` (goi) steps global Gmain (the mapping,
   the STN and, with ``global_g_optimize_synthesis``, all local Gs, through
   the renderer and the global D) and global Dmain, each loss scaled by goi,
   and every ``d_reg_interval · goi`` steps global R1 scaled by that
   interval; the global G and D have Adams of their own, rebalanced with
   ``g_reg_interval · goi`` and ``d_reg_interval · goi``;
4. the EMA of the mapping, the local Gs and the STN (with rampup), and the
   ADA controller over the 9 local lanes and the global lane ``L``, which
   counts global D executions only.

Gradients are scrubbed of NaN/inf before every optimizer step.  PyTorch
updates in place: the ensemble's parameters and buffers (``w_avg``) move
inside the step, and ``train_step`` returns the state it was given.  The
phases run eagerly; JAX's single traced program and its TPU dispatch
machinery (``phase_exec.py``) have no counterpart.  Not ported yet (they
raise ``NotImplementedError``): microbatch accumulation and conditional
labels.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import set_fp32_precision
from ..models.ensemble import MontageEnsemble
from . import losses
from .augment import AugmentConfig
from .draws import Draws


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    """Hyperparameters; fields and defaults are the JAX package's (config
    'aio')."""
    lrate: float = 0.0025
    beta1: float = 0.0
    beta2: float = 0.99
    eps: float = 1e-8
    g_reg_interval: Optional[int] = 4
    d_reg_interval: Optional[int] = 16
    global_optimize_interval: int = 1
    r1_gamma: float = 10.0
    global_r1_gamma: float = 10.0
    pl_weight: float = 2.0
    pl_batch_shrink: int = 2
    pl_decay: float = 0.01
    style_mixing_prob: float = 0.9
    ema_kimg: float = 10.0
    ema_rampup: Optional[float] = None
    ada_target: Optional[float] = 0.6
    ada_interval: int = 4
    ada_kimg: float = 500.0
    aug_p_max: float = 0.6
    augment: Optional[AugmentConfig] = None
    augment_p_init: float = 0.0
    local_noaug: bool = False
    global_noaug: bool = False
    batch_size: int = 32
    train_local: bool = True
    train_global: bool = True
    train_renderer: bool = True
    renderer_use_real: bool = True
    bypass_renderer: bool = False
    global_d_real_use_renderer: bool = True
    global_g_optimize_synthesis: bool = True
    renderer_lr: float = 1e-3
    renderer_betas: Tuple[float, float] = (0.9, 0.999)
    renderer_loss: str = 'mse'
    microbatch: Optional[int] = None
    global_microbatch: Optional[int] = None
    bucket_microbatch: Optional[int] = None


@dataclasses.dataclass
class MontageTrainState:
    """What a step carries besides the ensemble's own parameters."""
    model: MontageEnsemble      # updated in place by the step
    ema: MontageEnsemble        # mapping, local Gs and STN only
    opt_local_g: List[torch.optim.Adam]
    opt_local_d: List[torch.optim.Adam]
    opt_global_g: Optional[torch.optim.Adam]
    opt_global_d: Optional[torch.optim.Adam]
    opt_renderer: Optional['AMSGrad']
    pl_mean: torch.Tensor       # [L]
    aug_p: torch.Tensor         # [L + 1] (9 local pipes + the global pipe)
    ada_sign_sum: torch.Tensor  # [L + 1]
    ada_sign_count: torch.Tensor
    step: int = 0


def _scaled_adam(params, hyper: TrainHyper, reg_interval: Optional[int]):
    """Adam with the lazy-regularization lr/β rebalance."""
    lr, b1, b2 = hyper.lrate, hyper.beta1, hyper.beta2
    if reg_interval is not None:
        mb_ratio = reg_interval / (reg_interval + 1)
        lr, b1, b2 = lr * mb_ratio, b1 ** mb_ratio, b2 ** mb_ratio
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=hyper.eps)


class AMSGrad(torch.optim.Optimizer):
    """``optax.amsgrad``: Adam whose denominator is the running maximum of
    the bias-corrected second moment, ``nu_max = max(nu_max, nu_hat)``.
    ``torch.optim.Adam(amsgrad=True)`` keeps the maximum of the raw second
    moment and divides by the current bias correction afterwards, which
    differs from the second step on."""

    def __init__(self, params, lr: float, betas: Tuple[float, float],
                 eps: float):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group['betas']
            for p in group['params']:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st['step'] = 0
                    for k in ('mu', 'nu', 'nu_max'):
                        st[k] = torch.zeros_like(p)
                st['step'] += 1
                t, g = st['step'], p.grad
                st['mu'].mul_(b1).add_(g, alpha=1 - b1)
                st['nu'].mul_(b2).addcmul_(g, g, value=1 - b2)
                mu_hat = st['mu'] / (1 - b1 ** t)
                torch.maximum(st['nu_max'], st['nu'] / (1 - b2 ** t),
                              out=st['nu_max'])
                p.sub_(group['lr'] * mu_hat / (st['nu_max'].sqrt()
                                               + group['eps']))


def _apply_grads(opt: torch.optim.Optimizer,
                 params: Sequence[torch.nn.Parameter],
                 loss: torch.Tensor) -> None:
    """One optimizer step on the gradients of ``loss``.  A parameter the
    loss does not reach gets a zero gradient, as a JAX gradient tree has
    one, so that Adam's moments decay for it as in optax."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = (torch.zeros_like(p) if g is None else
                  torch.nan_to_num(g, nan=0.0, posinf=1e5, neginf=-1e5))
    opt.step()
    for p in params:
        p.grad = None


def _merge_stats(stats: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]):
    """Colliding keys (Loss/scores/fake from Gmain and Dmain) average."""
    for k, v in new.items():
        stats[k] = (stats[k] + v) * 0.5 if k in stats else v


class MontageTrainer:
    """The optimizers, the initial state and the step, on ``device`` (the
    card unless the caller asks for ``'cpu'``)."""

    def __init__(self, ens: MontageEnsemble, hyper: TrainHyper,
                 device: Union[str, torch.device] = 'cuda'):
        if ens.local_d is None:
            raise ValueError('training needs MontageEnsemble(cfg, with_d=True)')
        if hyper.microbatch is not None or hyper.global_microbatch is not None:
            raise NotImplementedError('microbatch accumulation is not ported '
                                      'yet')
        self.ens = ens
        self.hyper = hyper
        self.device = torch.device(device)
        self._local_aug = (hyper.augment if hyper.augment is not None
                           and not hyper.local_noaug else None)
        self._global_aug = (hyper.augment if hyper.augment is not None
                            and not hyper.global_noaug else None)
        self._use_renderer = (not hyper.bypass_renderer
                              and ens.renderer is not None)
        self._train_global = hyper.train_global and ens.stn is not None

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------

    def init_state(self, seed: int) -> MontageTrainState:
        """Seeded weights (the JAX initializers) and a fresh state."""
        self.ens.init_weights(seed)
        return self.state_from_variables(self.ens.state_dict())

    def _global_g_params(self) -> List[torch.nn.Parameter]:
        ens = self.ens
        params = list(ens.mapping.parameters()) + list(ens.stn.parameters())
        if self.hyper.global_g_optimize_synthesis:
            params += list(ens.local_g.parameters())
        return params

    def state_from_variables(self, state_dict) -> MontageTrainState:
        """A fresh state around existing weights (a state dict of the
        ensemble, e.g. from ``utils.weights.state_dict_from_jax``): EMA =
        copies of the mapping, the local Gs and the STN, optimizer moments
        zero, controller zero."""
        set_fp32_precision()
        ens, hyper, dev = self.ens, self.hyper, self.device
        ens.load_state_dict(state_dict)
        ens.to(dev).train()
        num_layers = ens.cfg.num_layers
        ema = MontageEnsemble(ens.cfg)
        ema.renderer = None
        ema.load_state_dict({k: v for k, v in ens.state_dict().items()
                             if k.startswith(('mapping.', 'local_g.',
                                              'stn.'))})
        ema = ema.to(dev).eval().requires_grad_(False)
        opt_g, opt_d = [], []
        if hyper.train_local:
            mapping = list(ens.mapping.parameters())
            for i in range(num_layers):
                opt_g.append(_scaled_adam(
                    mapping + list(ens.local_g[i].parameters()), hyper,
                    hyper.g_reg_interval))
                opt_d.append(_scaled_adam(list(ens.local_d[i].parameters()),
                                          hyper, hyper.d_reg_interval))
        opt_gg = opt_gd = opt_r = None
        if self._train_global:
            goi = hyper.global_optimize_interval
            opt_gg = _scaled_adam(self._global_g_params(), hyper, None if
                                  hyper.g_reg_interval is None else
                                  hyper.g_reg_interval * goi)
            opt_gd = _scaled_adam(list(ens.global_d.parameters()), hyper,
                                  None if hyper.d_reg_interval is None else
                                  hyper.d_reg_interval * goi)
        if hyper.train_renderer and self._use_renderer:
            opt_r = AMSGrad(list(ens.renderer.parameters()),
                            lr=hyper.renderer_lr, betas=hyper.renderer_betas,
                            eps=hyper.eps)
        zeros = torch.zeros(num_layers + 1, device=dev)
        return MontageTrainState(
            model=ens, ema=ema, opt_local_g=opt_g, opt_local_d=opt_d,
            opt_global_g=opt_gg, opt_global_d=opt_gd, opt_renderer=opt_r,
            pl_mean=torch.zeros(num_layers, device=dev),
            aug_p=torch.full((num_layers + 1,), float(hyper.augment_p_init),
                             device=dev),
            ada_sign_sum=zeros.clone(), ada_sign_count=zeros.clone(), step=0)

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------

    def train_step(self, state: MontageTrainState, real_stack,
                   real_crops: Sequence, rng: Union[torch.Generator, Draws],
                   real_c=None, gen_c=None):
        """One training iteration.

        Args:
            state: the ``MontageTrainState`` (updated in place, returned).
            real_stack: ``[B, L, H, W, C]`` reals in [-1, 1] (the input
                of the renderer and global phases; unused by the local
                phases).
            real_crops: per-layer ``[B, h_l, w_l, C]`` centered crops in
                [-1, 1] (``utils.image_utils.make_batch_for_local_d_np``).
            rng: a ``torch.Generator`` on the trainer's device, or a
                ``Draws`` (the seam a test uses to inject draws).
        Returns:
            (state, dict of scalar tensors).
        """
        return self.partial_step(state, real_stack, real_crops, rng,
                                 real_c=real_c, gen_c=gen_c)

    def partial_step(self, state: MontageTrainState, real_stack,
                     real_crops: Sequence, rng: Union[torch.Generator, Draws],
                     do_local: bool = True, do_global: bool = True,
                     do_renderer: bool = True, do_ema_ada: bool = True,
                     real_c=None, gen_c=None):
        """``train_step`` with phase gates (the JAX package's, without its
        host-scheduling refinements)."""
        if real_c is not None or gen_c is not None:
            raise NotImplementedError('conditional labels are not ported yet')
        ens, hyper, dev = self.ens, self.hyper, self.device
        draws = rng if isinstance(rng, Draws) else Draws(rng)

        def as_tensor(x):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.asarray(x))
            return x.to(device=dev, dtype=torch.float32)

        crops = [as_tensor(c) for c in real_crops]
        batch = crops[0].shape[0]
        stats: Dict[str, torch.Tensor] = {}
        step = state.step

        def z(d=draws):
            return d.normal([batch, ens.cfg.z_dim], 'z')

        need_stack = ((do_renderer and hyper.train_renderer
                       and self._use_renderer)
                      or (do_global and self._train_global))
        stack = as_tensor(real_stack) if need_stack else None

        # ---- the renderer phase
        if do_renderer and hyper.train_renderer and self._use_renderer:
            rdraws = draws.scoped('renderer_')
            loss, st = losses.renderer_loss(
                ens, z(rdraws), stack, rdraws, hyper.renderer_loss,
                hyper.renderer_use_real, hyper.style_mixing_prob)
            _apply_grads(state.opt_renderer,
                         list(ens.renderer.parameters()), loss)
            stats.update({k: v.detach() for k, v in st.items()})

        if do_local and hyper.train_local:
            g_params = [list(ens.mapping.parameters())
                        + list(net.parameters()) for net in ens.local_g]
            for i, name in enumerate(ens.cfg.layer_names):
                aug_p = state.aug_p[i]
                d_params = list(ens.local_d[i].parameters())
                # ---- local_Gmain
                loss, st = losses.local_gmain_loss(
                    ens, i, z(), draws, self._local_aug, aug_p,
                    hyper.style_mixing_prob)
                _apply_grads(state.opt_local_g[i], g_params[i], loss)
                _merge_stats(stats, {f'{name}/{k}': v.detach()
                                     for k, v in st.items()})
                # ---- local_Greg (path length)
                if (hyper.g_reg_interval is not None and hyper.pl_weight != 0
                        and step % hyper.g_reg_interval == 0):
                    loss, pl_i, _ = losses.local_gpl_loss(
                        ens, i, z(), draws, state.pl_mean[i],
                        hyper.pl_batch_shrink, hyper.pl_decay,
                        hyper.pl_weight, hyper.style_mixing_prob)
                    _apply_grads(state.opt_local_g[i], g_params[i],
                                 loss * float(hyper.g_reg_interval))
                    state.pl_mean[i] = pl_i
                # ---- local_Dmain
                loss, st, sign_real = losses.local_dmain_loss(
                    ens, i, z(), crops[i], draws, self._local_aug, aug_p,
                    hyper.style_mixing_prob)
                _apply_grads(state.opt_local_d[i], d_params, loss)
                _merge_stats(stats, {f'{name}/{k}': v.detach()
                                     for k, v in st.items()})
                state.ada_sign_sum[i] += sign_real.detach()
                state.ada_sign_count[i] += 1.0
                # ---- local_Dreg (R1)
                if (hyper.d_reg_interval is not None and hyper.r1_gamma != 0
                        and step % hyper.d_reg_interval == 0):
                    loss, _, sign_real = losses.local_dr1_loss(
                        ens, i, crops[i], draws, self._local_aug, aug_p,
                        hyper.r1_gamma)
                    _apply_grads(state.opt_local_d[i], d_params,
                                 loss * float(hyper.d_reg_interval))
                    state.ada_sign_sum[i] += sign_real.detach()
                    state.ada_sign_count[i] += 1.0

        if do_global and self._train_global:
            self._global_phases(state, stack, draws.scoped('global_'), stats)

        if do_ema_ada:
            self._ema_and_ada(state)
            for li, name in enumerate(ens.cfg.layer_names):
                stats[f'Progress/augment_{name}'] = state.aug_p[li]
            stats['Progress/augment_global'] = state.aug_p[-1]
        return state, stats

    def _global_phases(self, state: MontageTrainState, stack: torch.Tensor,
                       draws: Draws, stats: Dict[str, torch.Tensor]) -> None:
        """Global Gmain and Dmain every goi steps, global R1 every
        ``d_reg_interval · goi`` steps; the global D's signs go to lane L."""
        ens, hyper = self.ens, self.hyper
        goi = hyper.global_optimize_interval
        lane = ens.cfg.num_layers
        aug_p = state.aug_p[lane]
        batch = stack.shape[0]
        d_params = list(ens.global_d.parameters())

        def put(st):
            stats.update({f'global/{k}': v.detach() for k, v in st.items()})

        def count_sign(sign):
            state.ada_sign_sum[lane] += sign.detach()
            state.ada_sign_count[lane] += 1.0

        if state.step % goi == 0:
            loss, st = losses.global_gmain_loss(
                ens, draws.normal([batch, ens.cfg.z_dim], 'z'), draws,
                self._global_aug, aug_p, hyper.style_mixing_prob,
                self._use_renderer)
            _apply_grads(state.opt_global_g, self._global_g_params(),
                         loss * float(goi))
            put(st)
            loss, st, sign = losses.global_dmain_loss(
                ens, draws.normal([batch, ens.cfg.z_dim], 'z'), stack, draws,
                self._global_aug, aug_p, hyper.style_mixing_prob,
                self._use_renderer, hyper.global_d_real_use_renderer)
            _apply_grads(state.opt_global_d, d_params, loss * float(goi))
            put(st)
            count_sign(sign)
        if hyper.d_reg_interval is not None and hyper.global_r1_gamma != 0:
            interval = hyper.d_reg_interval * goi
            if state.step % interval == 0:
                loss, st, sign = losses.global_dr1_loss(
                    ens, stack, draws, self._global_aug, aug_p,
                    hyper.global_r1_gamma, self._use_renderer,
                    hyper.global_d_real_use_renderer)
                _apply_grads(state.opt_global_d, d_params,
                             loss * float(interval))
                put(st)
                count_sign(sign)

    @torch.no_grad()
    def _ema_and_ada(self, state: MontageTrainState) -> None:
        """EMA of the mapping, the local Gs and the STN with rampup, then
        the ADA controller; advances ``state.step``."""
        hyper = self.hyper
        cur_nimg = (state.step + 1.0) * hyper.batch_size
        ema_nimg = hyper.ema_kimg * 1000.0
        if hyper.ema_rampup is not None:
            ema_nimg = min(ema_nimg, cur_nimg * hyper.ema_rampup)
        beta = 0.5 ** (hyper.batch_size / max(ema_nimg, 1e-8))
        live = dict(self.ens.named_parameters())
        for name, p in state.ema.named_parameters():
            p.copy_(live[name] + beta * (p - live[name]))
        buffers = dict(self.ens.named_buffers())
        for name, b in state.ema.named_buffers():
            b.copy_(buffers[name])

        if (hyper.ada_target is not None and hyper.augment is not None
                and (state.step + 1) % hyper.ada_interval == 0):
            mean_sign = state.ada_sign_sum / state.ada_sign_count.clamp(min=1.0)
            adjust = (torch.sign(mean_sign - hyper.ada_target)
                      * (hyper.batch_size * hyper.ada_interval)
                      / (hyper.ada_kimg * 1000.0))
            adjust = torch.where(state.ada_sign_count > 0, adjust,
                                 torch.zeros_like(adjust))
            state.aug_p.copy_((state.aug_p + adjust).clamp(0.0,
                                                           hyper.aug_p_max))
            state.ada_sign_sum.zero_()
            state.ada_sign_count.zero_()
        state.step += 1
