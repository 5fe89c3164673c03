"""Mapping networks: z (+c) → w.

Port of ``montage_gan_tpu/models/mapping.py``.  A conditional network
(``c_dim > 0``) embeds the one-hot label by the ``embed`` FC, normalizes
its second moment and appends it to the normalized z.  ``GlobalMappingNetwork`` is
the MontageGAN addition: the final FC widens to ``w_dim * num_splits`` and
the output becomes ``[B, L, num_ws, w_dim]`` — one style stack per image
layer from a single z.  ``w_avg`` (the truncation centre) is a buffer, moved
by ``forward(..., update_w_avg=True)`` in training.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel import mesh
from .layers import FullyConnected, normalize_2nd_moment


class MappingNetwork(nn.Module):
    """z → ``[B, num_ws, w_dim]``."""

    def __init__(self, z_dim: int = 512, w_dim: int = 512, num_ws: int = 1,
                 c_dim: int = 0, num_layers: int = 8,
                 embed_features: Optional[int] = None,
                 layer_features: Optional[int] = None,
                 activation: str = 'lrelu', lr_multiplier: float = 0.01,
                 w_avg_beta: float = 0.995):
        super().__init__()
        self.z_dim, self.c_dim = z_dim, c_dim
        self.w_dim, self.num_ws = w_dim, num_ws
        self.w_avg_beta = w_avg_beta
        out_dim = self._out_dim()
        embed_features = 0 if c_dim == 0 else (embed_features or w_dim)
        layer_features = layer_features or w_dim
        features = ([z_dim + embed_features] + [layer_features]
                    * (num_layers - 1) + [out_dim])
        self.register_buffer('w_avg', torch.zeros(out_dim))
        if c_dim > 0:
            self.embed = FullyConnected(c_dim, embed_features)
        self.num_layers = num_layers
        for idx in range(num_layers):
            setattr(self, f'fc{idx}', FullyConnected(
                features[idx], features[idx + 1], activation=activation,
                lr_multiplier=lr_multiplier))

    def _out_dim(self) -> int:
        return self.w_dim

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.c_dim > 0:
            self.embed.reset_parameters(generator)
        for idx in range(self.num_layers):
            getattr(self, f'fc{idx}').reset_parameters(generator)
        self.w_avg.zero_()

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor] = None,
                truncation_psi: float = 1.0,
                update_w_avg: bool = False) -> torch.Tensor:
        """z ``[B, z_dim]`` (and the label ``c`` ``[B, c_dim]`` of a
        conditional network) → ``[B, num_ws, w_dim]``, pulled towards
        ``w_avg`` by ``truncation_psi``.  ``update_w_avg`` (training) first
        moves ``w_avg`` in place: ``β·w_avg + (1 − β)·mean(w)`` over the
        (global) batch, β = ``w_avg_beta``."""
        assert z.shape[-1] == self.z_dim
        x = normalize_2nd_moment(z.float())
        if self.c_dim > 0:
            if c is None:
                raise ValueError(f'a conditional mapping (c_dim '
                                 f'{self.c_dim}) needs a label c')
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=-1)
        for idx in range(self.num_layers):
            x = getattr(self, f'fc{idx}')(x)
        if update_w_avg:
            with torch.no_grad():
                self.w_avg.copy_(self.w_avg_beta * self.w_avg
                                 + (1.0 - self.w_avg_beta)
                                 * mesh.global_mean(x.mean(dim=0)))
        x = x[:, None, :].repeat(1, self.num_ws, 1)
        if truncation_psi != 1:
            x = self.w_avg + truncation_psi * (x - self.w_avg)
        return x


class GlobalMappingNetwork(MappingNetwork):
    """z → ``[B, num_splits, num_ws, w_dim]``."""

    def __init__(self, *args, num_splits: int = 9, **kwargs):
        self.num_splits = num_splits
        super().__init__(*args, **kwargs)

    def _out_dim(self) -> int:
        return self.w_dim * self.num_splits

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor] = None,
                truncation_psi: float = 1.0,
                update_w_avg: bool = False) -> torch.Tensor:
        x = super().forward(z, c, truncation_psi, update_w_avg)
        x = x.reshape(x.shape[0], self.num_ws, self.num_splits, self.w_dim)
        return x.transpose(1, 2)  # [B, L, num_ws, w_dim]
