"""StyleGAN2 synthesis networks, non-square capable.

Port of ``montage_gan_tpu/models/synthesis.py`` (the 'skip' architecture the
ensemble uses): a block at nominal resolution ``r`` has spatial extent
``(r·init_res[0] / 2^cci, r·init_res[1] / 2^cci)`` and the pyramid spans
``r = 2^cci .. img_resolution``.  The top ``num_fp16_res`` resolutions run in
bfloat16; ToRGB accumulates in float32.  Random noise comes from an explicit
``torch.Generator``, or from a training step's ``Draws``
(``training/losses.py``), passed as ``generator``.  Activations are NHWC.
``Generator`` is the monolithic mapping + synthesis module of the JAX
package (``synthesis.py:272-307``), its submodules in the reference's order.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .bias_act import activation_funcs, bias_act
from .filters import setup_filter
from .modulated_conv import modulated_conv2d
from .upfirdn2d import upsample2d
from .layers import FullyConnected

NOISE_MODES = ('random', 'const', 'none')


def block_resolutions(img_resolution: int,
                      conv_config_index: int) -> Tuple[int, ...]:
    res_log2 = int(math.log2(img_resolution))
    return tuple(2 ** i for i in range(conv_config_index, res_log2 + 1))


def channels_for(res: int, channel_base: int, channel_max: int) -> int:
    return min(channel_base // res, channel_max)


def _spatial(resolution: int, init_res: Sequence[int],
             cci: int) -> Tuple[int, int]:
    return (resolution * init_res[0] // 2 ** cci,
            resolution * init_res[1] // 2 ** cci)


class SynthesisLayer(nn.Module):
    """Modulated 3×3 conv (optionally ×2 upsampling) + noise + bias/act."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, init_res: Tuple[int, int] = (4, 4),
                 conv_config_index: int = 2, kernel_size: int = 3,
                 up: int = 1, use_noise: bool = True,
                 activation: str = 'lrelu',
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None):
        super().__init__()
        self.up = up
        self.use_noise = use_noise
        self.activation = activation
        self.conv_clamp = conv_clamp
        self.padding = kernel_size // 2
        self.out_hw = _spatial(resolution, init_res, conv_config_index)
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        if use_noise:
            self.noise_strength = nn.Parameter(torch.zeros([]))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer('resample_filter',
                             setup_filter(list(resample_filter)))
        if use_noise:
            self.register_buffer('noise_const', torch.empty(self.out_hw))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.affine.reset_parameters(generator)
        nn.init.normal_(self.weight, generator=generator)
        nn.init.zeros_(self.bias)
        if self.use_noise:
            nn.init.zeros_(self.noise_strength)
            nn.init.normal_(self.noise_const, generator=generator)

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                noise_mode: str = 'random', gain: float = 1.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        assert noise_mode in NOISE_MODES
        styles = self.affine(w)
        noise = None
        if self.use_noise and noise_mode == 'random':
            shape = (x.shape[0], *self.out_hw, 1)
            if generator is None or isinstance(generator, torch.Generator):
                noise = torch.randn(shape, device=x.device, generator=generator)
            else:   # a training step's draws (training/losses.py::Draws)
                noise = generator.normal(shape, 'synthesis_noise')
            noise = noise * self.noise_strength
        elif self.use_noise and noise_mode == 'const':
            noise = (self.noise_const * self.noise_strength)[None, :, :, None]
        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up,
                             padding=self.padding,
                             resample_filter=self.resample_filter,
                             flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain,
                        clamp=act_clamp)


class ToRGBLayer(nn.Module):
    """Modulated 1×1 conv to image channels, no demodulation."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 kernel_size: int = 1, conv_clamp: Optional[float] = None):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.affine.reset_parameters(generator)
        nn.init.normal_(self.weight, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w) * self.weight_gain
        x = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return bias_act(x, self.bias, clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    """One resolution of the 'skip' generator: (const |) conv0 (×2) → conv1
    → ToRGB, with the image skip upsampled by ``upsample2d``."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, img_channels: int, is_last: bool,
                 init_res: Tuple[int, int] = (4, 4),
                 conv_config_index: int = 2,
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, use_fp16: bool = False,
                 use_noise: bool = True, activation: str = 'lrelu'):
        super().__init__()
        self.in_channels = in_channels
        self.dtype = torch.bfloat16 if use_fp16 else torch.float32
        layer_kw = dict(w_dim=w_dim, resolution=resolution, init_res=init_res,
                        conv_config_index=conv_config_index,
                        resample_filter=resample_filter,
                        conv_clamp=conv_clamp, use_noise=use_noise,
                        activation=activation)
        if in_channels == 0:
            h0, w0 = _spatial(resolution, init_res, conv_config_index)
            self.const = nn.Parameter(torch.empty(out_channels, h0, w0))
        self.register_buffer('resample_filter',
                             setup_filter(list(resample_filter)))
        if in_channels != 0:
            self.conv0 = SynthesisLayer(in_channels, out_channels, up=2,
                                        **layer_kw)
        self.conv1 = SynthesisLayer(out_channels, out_channels, **layer_kw)
        self.torgb = ToRGBLayer(out_channels, img_channels, w_dim=w_dim,
                                conv_clamp=conv_clamp)
        self.num_conv = 1 if in_channels == 0 else 2
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.in_channels == 0:
            nn.init.normal_(self.const, generator=generator)
        else:
            self.conv0.reset_parameters(generator)
        self.conv1.reset_parameters(generator)
        self.torgb.reset_parameters(generator)

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor],
                ws: torch.Tensor, noise_mode: str = 'random',
                generator: Optional[torch.Generator] = None):
        w_iter = iter(ws.unbind(1))
        if self.in_channels == 0:
            const = self.const.permute(1, 2, 0).to(self.dtype)  # [H, W, C]
            x = const[None].expand(ws.shape[0], *const.shape).contiguous()
        else:
            x = x.to(self.dtype)
            x = self.conv0(x, next(w_iter), noise_mode=noise_mode,
                           generator=generator)
        x = self.conv1(x, next(w_iter), noise_mode=noise_mode,
                       generator=generator)
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        y = self.torgb(x, next(w_iter)).float()
        img = img + y if img is not None else y
        return x, img


class SynthesisNetwork(nn.Module):
    """ws ``[B, num_ws, w_dim]`` → image ``[B, H, W, img_channels]`` float32."""

    def __init__(self, img_resolution: int, img_channels: int,
                 w_dim: int = 512, init_res: Tuple[int, int] = (4, 4),
                 conv_config_index: int = 2, channel_base: int = 32768,
                 channel_max: int = 512, num_fp16_res: int = 0,
                 conv_clamp: Optional[float] = None, use_noise: bool = True,
                 activation: str = 'lrelu'):
        super().__init__()
        self.img_resolution = img_resolution
        self.w_dim = w_dim
        self.conv_config_index = conv_config_index
        self.block_resolutions = block_resolutions(img_resolution,
                                                   conv_config_index)
        res_log2 = int(math.log2(img_resolution))
        fp16_resolution = max(2 ** (res_log2 + 1 - num_fp16_res), 8)
        cdict = {res: channels_for(res, channel_base, channel_max)
                 for res in self.block_resolutions}
        self.num_ws = 0
        for res in self.block_resolutions:
            in_ch = cdict[res // 2] if res > 2 ** conv_config_index else 0
            block = SynthesisBlock(
                in_ch, cdict[res], w_dim=w_dim, resolution=res,
                img_channels=img_channels, is_last=(res == img_resolution),
                init_res=tuple(init_res), conv_config_index=conv_config_index,
                conv_clamp=conv_clamp, use_fp16=(res >= fp16_resolution),
                use_noise=use_noise, activation=activation)
            setattr(self, f'b{res}', block)
            self.num_ws += block.num_conv
        self.num_ws += 1  # the last block's ToRGB

    def blocks(self):
        return [getattr(self, f'b{res}') for res in self.block_resolutions]

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for block in self.blocks():
            block.reset_parameters(generator)

    def forward(self, ws: torch.Tensor, noise_mode: str = 'random',
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        assert ws.shape[1] >= self.num_ws and ws.shape[2] == self.w_dim
        ws = ws.float()
        x = img = None
        w_idx = 0
        for block in self.blocks():
            x, img = block(x, img, ws[:, w_idx:w_idx + block.num_conv + 1],
                           noise_mode=noise_mode, generator=generator)
            w_idx += block.num_conv
        return img


class Generator(nn.Module):
    """z (+c) → image: a ``MappingNetwork`` with one w per synthesis layer
    and a ``SynthesisNetwork`` (``montage_gan_tpu/models/synthesis.py:
    272-307``; the reference's custom/networks_aio.py:627-662)."""

    def __init__(self, img_resolution: int, img_channels: int,
                 z_dim: int = 512, w_dim: int = 512, c_dim: int = 0,
                 init_res: Tuple[int, int] = (4, 4),
                 conv_config_index: int = 2, mapping_num_layers: int = 8,
                 channel_base: int = 32768, channel_max: int = 512,
                 num_fp16_res: int = 0, conv_clamp: Optional[float] = None):
        super().__init__()
        from .mapping import MappingNetwork
        self.z_dim, self.c_dim, self.w_dim = z_dim, c_dim, w_dim
        self.synthesis = SynthesisNetwork(
            img_resolution=img_resolution, img_channels=img_channels,
            w_dim=w_dim, init_res=init_res,
            conv_config_index=conv_config_index, channel_base=channel_base,
            channel_max=channel_max, num_fp16_res=num_fp16_res,
            conv_clamp=conv_clamp)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim=z_dim, w_dim=w_dim, c_dim=c_dim,
                                      num_ws=self.num_ws,
                                      num_layers=mapping_num_layers)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.synthesis.reset_parameters(generator)
        self.mapping.reset_parameters(generator)

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor] = None,
                truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None,
                noise_mode: str = 'random', update_w_avg: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff,
                          update_w_avg=update_w_avg)
        return self.synthesis(ws, noise_mode=noise_mode, generator=generator)
