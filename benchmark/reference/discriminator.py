"""StyleGAN2 discriminator, non-square capable.

Port of ``montage_gan_tpu/models/discriminator.py`` (resnet architecture, the
one the ensemble's local Ds use): ``fromrgb`` at the top resolution, blocks
of conv0 + conv1 (↓2) with a 1×1 ↓2 skip, bfloat16 blocks at
``res ≥ fp16_resolution``, and a float32 epilogue (minibatch-std, conv, fc,
out) over the ``init_res`` cells.  ``freeze_layers`` freezes the first
layers (Freeze-D).  A conditional D (``c_dim > 0``) maps the label through
``mapping`` (a ``MappingNetwork`` without z, ``cmap_dim`` wide) and
projects the epilogue's ``cmap_dim`` outputs on it:
``sum(x · cmap) / sqrt(cmap_dim)``.  Module and buffer names are the reference checkpoint's
(``montage_gan_tpu/utils/torch_export.py::discriminator_state_dict``).
Activations are NHWC.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .filters import setup_filter
from .layers import Conv2dLayer, FullyConnected, MinibatchStd
from .mapping import MappingNetwork
from .synthesis import channels_for


class DiscriminatorBlock(nn.Module):
    """One resolution of the resnet D (``discriminator.py:27-102``)."""

    def __init__(self, in_channels: int, tmp_channels: int, out_channels: int,
                 img_channels: int, first_layer_idx: int = 0,
                 activation: str = 'lrelu',
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, use_fp16: bool = False,
                 freeze_layers: int = 0):
        super().__init__()
        self.in_channels = in_channels
        self.use_fp16 = use_fp16
        self.register_buffer('resample_filter',
                             setup_filter(list(resample_filter)))
        layer_idx = first_layer_idx

        def trainable():
            nonlocal layer_idx
            t = layer_idx >= freeze_layers
            layer_idx += 1
            return t

        kw = dict(activation=activation, conv_clamp=conv_clamp,
                  resample_filter=resample_filter)
        if in_channels == 0:
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, 1,
                                       trainable=trainable(), **kw)
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, 3,
                                 trainable=trainable(), **kw)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, 3, down=2,
                                 trainable=trainable(), **kw)
        self.skip = Conv2dLayer(tmp_channels, out_channels, 1, use_bias=False,
                                down=2, resample_filter=resample_filter,
                                trainable=trainable())

    @staticmethod
    def num_layers(in_channels: int) -> int:
        return (1 if in_channels == 0 else 0) + 3

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for layer in self.layers():
            layer.reset_parameters(generator)

    def layers(self):
        names = (['fromrgb'] if self.in_channels == 0 else []) + [
            'conv0', 'conv1', 'skip']
        return [getattr(self, n) for n in names]

    def forward(self, x: Optional[torch.Tensor], img: torch.Tensor,
                force_fp32: bool = False) -> torch.Tensor:
        dtype = (torch.bfloat16 if self.use_fp16 and not force_fp32
                 else torch.float32)
        if x is not None:
            x = x.to(dtype)
        if self.in_channels == 0:
            y = self.fromrgb(img.to(dtype))
            x = x + y if x is not None else y
        y = self.skip(x, gain=math.sqrt(0.5))
        x = self.conv0(x)
        x = self.conv1(x, gain=math.sqrt(0.5))
        return y + x


class DiscriminatorEpilogue(nn.Module):
    """The 'b4' head (``discriminator.py:105-140``); always float32."""

    def __init__(self, in_channels: int, init_res: Tuple[int, int] = (4, 4),
                 mbstd_group_size: Optional[int] = 4,
                 mbstd_num_channels: int = 1, activation: str = 'lrelu',
                 conv_clamp: Optional[float] = None, cmap_dim: int = 0):
        super().__init__()
        self.init_res = tuple(init_res)
        self.cmap_dim = cmap_dim
        self.mbstd = (MinibatchStd(mbstd_group_size, mbstd_num_channels)
                      if mbstd_num_channels > 0 else None)
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels,
                                3, activation=activation,
                                conv_clamp=conv_clamp)
        self.fc = FullyConnected(in_channels * init_res[0] * init_res[1],
                                 in_channels, activation=activation)
        self.out = FullyConnected(in_channels, cmap_dim or 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for layer in (self.conv, self.fc, self.out):
            layer.reset_parameters(generator)

    def forward(self, x: torch.Tensor,
                cmap: Optional[torch.Tensor] = None) -> torch.Tensor:
        if tuple(x.shape[1:3]) != self.init_res:
            raise ValueError(f'epilogue input {tuple(x.shape)} is not at '
                             f'init_res {self.init_res}')
        x = x.float()
        if self.mbstd is not None:
            x = self.mbstd(x)
        x = self.conv(x)
        # the reference flattens NCHW: C-major
        x = self.fc(x.permute(0, 3, 1, 2).reshape(x.shape[0], -1))
        x = self.out(x)
        if self.cmap_dim > 0:
            x = (x * cmap).sum(dim=1, keepdim=True) / math.sqrt(self.cmap_dim)
        return x


class Discriminator(nn.Module):
    """img ``[B, H, W, C]`` (and the label ``c`` ``[B, c_dim]`` of a
    conditional D) → logits ``[B, 1]`` (``discriminator.py:143-202``).
    ``cmap_dim`` defaults to the epilogue's channels."""

    def __init__(self, img_resolution: int, img_channels: int, c_dim: int = 0,
                 init_res: Tuple[int, int] = (4, 4), conv_config_index: int = 2,
                 channel_base: int = 32768, channel_max: int = 512,
                 num_fp16_res: int = 0, conv_clamp: Optional[float] = None,
                 cmap_dim: Optional[int] = None,
                 mbstd_group_size: Optional[int] = 4,
                 mbstd_num_channels: int = 1, freeze_layers: int = 0):
        super().__init__()
        self.c_dim = c_dim
        res_log2 = int(math.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(
            res_log2, conv_config_index, -1)]
        cdict = {res: channels_for(res, channel_base, channel_max)
                 for res in self.block_resolutions + [2 ** conv_config_index]}
        fp16_resolution = max(2 ** (res_log2 + 1 - num_fp16_res), 8)
        layer_idx = 0
        for res in self.block_resolutions:
            in_ch = cdict[res] if res < img_resolution else 0
            setattr(self, f'b{res}', DiscriminatorBlock(
                in_ch, cdict[res], cdict[res // 2], img_channels,
                first_layer_idx=layer_idx, conv_clamp=conv_clamp,
                use_fp16=res >= fp16_resolution, freeze_layers=freeze_layers))
            layer_idx += DiscriminatorBlock.num_layers(in_ch)
        if cmap_dim is None:
            cmap_dim = cdict[2 ** conv_config_index]
        if c_dim == 0:
            cmap_dim = 0
        if c_dim > 0:
            self.mapping = MappingNetwork(z_dim=0, c_dim=c_dim,
                                          w_dim=cmap_dim, num_ws=None,
                                          w_avg_beta=None)
        self.b4 = DiscriminatorEpilogue(
            cdict[2 ** conv_config_index], init_res=init_res,
            mbstd_group_size=mbstd_group_size,
            mbstd_num_channels=mbstd_num_channels, conv_clamp=conv_clamp,
            cmap_dim=cmap_dim)

    def blocks(self):
        return [getattr(self, f'b{res}') for res in self.block_resolutions]

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for block in self.blocks():
            block.reset_parameters(generator)
        if self.c_dim > 0:
            self.mapping.reset_parameters(generator)
        self.b4.reset_parameters(generator)

    def forward(self, img: torch.Tensor, c: Optional[torch.Tensor] = None,
                force_fp32: bool = False) -> torch.Tensor:
        x = None
        for block in self.blocks():
            x = block(x, img, force_fp32=force_fp32)
        cmap = None
        if self.c_dim > 0:
            if c is None:
                raise ValueError(f'a conditional D (c_dim {self.c_dim}) '
                                 'needs a label c')
            cmap = self.mapping(None, c)
        return self.b4(x, cmap)
