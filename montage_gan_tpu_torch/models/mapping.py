"""Mapping networks: z → w.

Port of ``montage_gan_tpu/models/mapping.py``.  ``GlobalMappingNetwork`` is
the MontageGAN addition: the final FC widens to ``w_dim * num_splits`` and
the output becomes ``[B, L, num_ws, w_dim]`` — one style stack per image
layer from a single z.  ``w_avg`` (the truncation centre) is a buffer; its
training-time update comes with the training port.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import FullyConnected, normalize_2nd_moment


class MappingNetwork(nn.Module):
    """z → ``[B, num_ws, w_dim]``."""

    def __init__(self, z_dim: int = 512, w_dim: int = 512, num_ws: int = 1,
                 c_dim: int = 0, num_layers: int = 8,
                 layer_features: Optional[int] = None,
                 activation: str = 'lrelu', lr_multiplier: float = 0.01):
        super().__init__()
        if c_dim != 0:
            raise NotImplementedError('conditional mapping (c_dim > 0) is not '
                                      'ported yet')
        self.z_dim, self.w_dim, self.num_ws = z_dim, w_dim, num_ws
        out_dim = self._out_dim()
        layer_features = layer_features or w_dim
        features = [z_dim] + [layer_features] * (num_layers - 1) + [out_dim]
        self.register_buffer('w_avg', torch.zeros(out_dim))
        self.num_layers = num_layers
        for idx in range(num_layers):
            setattr(self, f'fc{idx}', FullyConnected(
                features[idx], features[idx + 1], activation=activation,
                lr_multiplier=lr_multiplier))

    def _out_dim(self) -> int:
        return self.w_dim

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for idx in range(self.num_layers):
            getattr(self, f'fc{idx}').reset_parameters(generator)
        self.w_avg.zero_()

    def forward(self, z: torch.Tensor,
                truncation_psi: float = 1.0) -> torch.Tensor:
        """z ``[B, z_dim]`` → ``[B, num_ws, w_dim]``, pulled towards
        ``w_avg`` by ``truncation_psi``."""
        assert z.shape[-1] == self.z_dim
        x = normalize_2nd_moment(z.float())
        for idx in range(self.num_layers):
            x = getattr(self, f'fc{idx}')(x)
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

    def forward(self, z: torch.Tensor,
                truncation_psi: float = 1.0) -> torch.Tensor:
        x = super().forward(z, truncation_psi)
        x = x.reshape(x.shape[0], self.num_ws, self.num_splits, self.w_dim)
        return x.transpose(1, 2)  # [B, L, num_ws, w_dim]
