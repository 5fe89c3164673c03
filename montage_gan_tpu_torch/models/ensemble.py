"""The MontageGAN ensemble: shared mapping → L local synthesis nets → STN
placement → alpha composite, and the L local discriminators.

Port of ``montage_gan_tpu/models/ensemble.py``, with the global D and the
learned renderer of the all-in-one training step.  ``MontageConfig`` keeps
all the JAX package's fields so its snapshots' configs load as they are.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from ..ops.composite import alpha_composite
from ..utils.calc_res import calc_init_res
from ..utils.image_utils import (make_batch_for_pos_estimator,
                                 normalize_minus11, normalize_zero1)
from .discriminator import Discriminator
from .mapping import GlobalMappingNetwork, MappingNetwork
from .renderer import build_renderer
from .stn import STN
from .synthesis import SynthesisNetwork

# The reference dataset's layer inventory.
DEFAULT_LAYER_NAMES = ('hair_back', 'body', 'ear', 'face', 'eye',
                       'mouth', 'nose', 'hair_front', 'brow')
DEFAULT_LAYER_TARGETS = ((256, 256), (256, 256), (160, 224), (256, 256),
                         (96, 160), (64, 96), (64, 32), (256, 256), (64, 160))


@dataclasses.dataclass(frozen=True)
class MontageConfig:
    """Defaults are config ``aio`` (``montage_gan_tpu/models/ensemble.py:36-72``)."""
    layer_names: Tuple[str, ...] = DEFAULT_LAYER_NAMES
    layer_targets: Tuple[Tuple[int, int], ...] = DEFAULT_LAYER_TARGETS
    base_resolution: int = 256
    img_channels: int = 4
    conv_config_index: int = 3
    z_dim: int = 512
    w_dim: int = 512
    c_dim: int = 0
    freeze_d_layers: int = 0
    mapping_num_layers: int = 8
    channel_base: int = 16384
    channel_max: int = 512
    num_fp16_res: int = 4
    conv_clamp: Optional[float] = 256
    mbstd_group_size: int = 4
    use_global_mapping: bool = True
    train_global: bool = True
    renderer_type: str = 'tanh'  # 'tanh' | 'sigmoid' | 'subpixel' | 'none'
    stn_stages: int = 5

    @property
    def num_layers(self) -> int:
        return len(self.layer_names)

    def layer_geometry(self, idx: int) -> Tuple[Tuple[int, int], int]:
        """(init_res, nominal_resolution) of layer idx."""
        init_res, res, _ = calc_init_res(list(self.layer_targets[idx]),
                                         conv_config_index=self.conv_config_index)
        return tuple(init_res), res

    @property
    def base_init_res(self) -> Tuple[int, int]:
        """The global D's ``init_res``: that of the base resolution."""
        init_res, _, _ = calc_init_res([self.base_resolution] * 2,
                                       conv_config_index=self.conv_config_index)
        return tuple(init_res)

    @classmethod
    def from_dict(cls, raw: dict) -> 'MontageConfig':
        raw = dict(raw)
        raw['layer_names'] = tuple(raw['layer_names'])
        raw['layer_targets'] = tuple(tuple(t) for t in raw['layer_targets'])
        return cls(**raw)


class MontageEnsemble(nn.Module):
    """``mapping``, ``local_g[i]``, ``stn`` (with ``train_global``) and
    ``renderer`` (unless ``renderer_type='none'``); with ``with_d``
    (training) also ``local_d[i]``, one ``Discriminator`` per layer at the
    layer's geometry, and with ``train_global`` the ``global_d`` at the base
    resolution."""

    def __init__(self, cfg: MontageConfig, with_d: bool = False):
        super().__init__()
        self.cfg = cfg
        local_g, local_d = [], []
        for i in range(cfg.num_layers):
            init_res, res = cfg.layer_geometry(i)
            local_g.append(SynthesisNetwork(
                img_resolution=res, img_channels=cfg.img_channels,
                w_dim=cfg.w_dim, init_res=init_res,
                conv_config_index=cfg.conv_config_index,
                channel_base=cfg.channel_base, channel_max=cfg.channel_max,
                num_fp16_res=cfg.num_fp16_res, conv_clamp=cfg.conv_clamp))
            if with_d:
                local_d.append(Discriminator(
                    img_resolution=res, img_channels=cfg.img_channels,
                    c_dim=cfg.c_dim, init_res=init_res,
                    conv_config_index=cfg.conv_config_index,
                    channel_base=cfg.channel_base,
                    channel_max=cfg.channel_max,
                    num_fp16_res=cfg.num_fp16_res,
                    conv_clamp=cfg.conv_clamp,
                    mbstd_group_size=cfg.mbstd_group_size,
                    freeze_layers=cfg.freeze_d_layers))
        self.num_ws = max(g.num_ws for g in local_g)
        if cfg.use_global_mapping:
            self.mapping = GlobalMappingNetwork(
                z_dim=cfg.z_dim, c_dim=cfg.c_dim, w_dim=cfg.w_dim,
                num_ws=self.num_ws, num_layers=cfg.mapping_num_layers,
                num_splits=cfg.num_layers)
        else:
            self.mapping = MappingNetwork(
                z_dim=cfg.z_dim, c_dim=cfg.c_dim, w_dim=cfg.w_dim,
                num_ws=self.num_ws, num_layers=cfg.mapping_num_layers)
        self.local_g = nn.ModuleList(local_g)
        self.local_d = nn.ModuleList(local_d) if with_d else None
        self.stn = None
        self.global_d = None
        if cfg.train_global:
            self.stn = STN(img_resolution=cfg.base_resolution,
                           img_channels=cfg.img_channels,
                           img_layers=cfg.num_layers,
                           num_stages=cfg.stn_stages)
            if with_d:
                self.global_d = Discriminator(
                    img_resolution=cfg.base_resolution,
                    img_channels=cfg.img_channels,
                    init_res=cfg.base_init_res,
                    conv_config_index=cfg.conv_config_index,
                    channel_base=cfg.channel_base,
                    channel_max=cfg.channel_max,
                    num_fp16_res=cfg.num_fp16_res,
                    conv_clamp=cfg.conv_clamp,
                    mbstd_group_size=cfg.mbstd_group_size)
        self.renderer = None
        if cfg.renderer_type != 'none':
            self.renderer = build_renderer(
                cfg.renderer_type, img_resolution=cfg.base_resolution,
                img_channels=cfg.img_channels, img_layers=cfg.num_layers)

    def init_weights(self, seed: int) -> 'MontageEnsemble':
        """Re-initialise every weight from one seeded generator, with the
        JAX package's initializers (N(0, 1)/lr for equalized-LR layers, unit
        normal noise_const, zero or constant biases, flax's lecun normal for
        the STN and the renderer, zeros for the STN's last FC)."""
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            self.mapping.reset_parameters(g)
            for net in self.local_g:
                net.reset_parameters(g)
            for net in self.local_d or ():
                net.reset_parameters(g)
            if self.stn is not None:
                self.stn.reset_parameters(g)
            if self.global_d is not None:
                self.global_d.reset_parameters(g)
            if self.renderer is not None:
                self.renderer.reset_parameters(g)
        return self

    def ws_for_layer(self, ws: torch.Tensor, layer_idx: int) -> torch.Tensor:
        """Slice the (global) mapping output for one layer."""
        if ws.ndim == 4:  # [B, L, num_ws, w]
            ws = ws[:, layer_idx]
        return ws[:, :self.local_g[layer_idx].num_ws]

    def synthesize_layers(self, ws: torch.Tensor, noise_mode: str = 'random',
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        """All local Gs → center-pad to the base resolution (pad -1) →
        ``[B, L, base, base, C]`` in [-1, 1]."""
        outs: List[torch.Tensor] = [
            net(self.ws_for_layer(ws, i), noise_mode=noise_mode,
                generator=generator)
            for i, net in enumerate(self.local_g)]
        return make_batch_for_pos_estimator(outs, self.cfg.base_resolution,
                                            pad_value=-1.0)

    def run_global_g(self, z: torch.Tensor, noise_mode: str = 'random',
                     truncation_psi: float = 1.0,
                     generator: Optional[torch.Generator] = None):
        """z → (placed layer stack in [-1, 1], theta)."""
        ws = self.mapping(z, truncation_psi=truncation_psi)
        return self.run_global_g_from_ws(ws, noise_mode, generator)

    def run_global_g_from_ws(self, ws: torch.Tensor,
                             noise_mode: str = 'random',
                             generator: Optional[torch.Generator] = None):
        """ws → (placed layer stack in [-1, 1], theta)."""
        stack = self.synthesize_layers(ws, noise_mode, generator)
        return self.stn(stack)

    def blend(self, stack: torch.Tensor,
              use_renderer: bool = True) -> torch.Tensor:
        """Layer stack [-1, 1] → blended image [-1, 1]: the renderer where
        there is one and ``use_renderer``, else the alpha composite."""
        if use_renderer and self.renderer is not None:
            return self.renderer(stack)
        return normalize_minus11(alpha_composite(normalize_zero1(stack)))
