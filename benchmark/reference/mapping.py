"""Mapping networks: z (+c) → w.

Port of ``montage_gan_tpu/models/mapping.py``.  A conditional network
(``c_dim > 0``) embeds the one-hot label by the ``embed`` FC, normalizes
its second moment and appends it to the normalized z; with ``z_dim = 0``
the label alone is mapped (the conditional D's projection, which also has
``num_ws=None``: one ``[B, w_dim]`` output, and ``w_avg_beta=None``: no
``w_avg``).  ``GlobalMappingNetwork`` is
the MontageGAN addition: the final FC widens to ``w_dim * num_splits`` and
the output becomes ``[B, L, num_ws, w_dim]`` — one style stack per image
layer from a single z.  ``w_avg`` (the truncation centre) is a buffer, moved
by ``forward(..., update_w_avg=True)`` in training.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import mesh
from .layers import FullyConnected, normalize_2nd_moment


class MappingNetwork(nn.Module):
    """z → ``[B, num_ws, w_dim]``."""

    def __init__(self, z_dim: int = 512, w_dim: int = 512,
                 num_ws: Optional[int] = 1, c_dim: int = 0,
                 num_layers: int = 8,
                 embed_features: Optional[int] = None,
                 layer_features: Optional[int] = None,
                 activation: str = 'lrelu', lr_multiplier: float = 0.01,
                 w_avg_beta: Optional[float] = 0.995):
        super().__init__()
        self.z_dim, self.c_dim = z_dim, c_dim
        self.w_dim, self.num_ws = w_dim, num_ws
        self.w_avg_beta = w_avg_beta
        out_dim = self._out_dim()
        embed_features = 0 if c_dim == 0 else (embed_features or w_dim)
        layer_features = layer_features or w_dim
        features = ([z_dim + embed_features] + [layer_features]
                    * (num_layers - 1) + [out_dim])
        self.register_buffer('w_avg', torch.zeros(out_dim) if (
            num_ws is not None and w_avg_beta is not None) else None)
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
        if self.w_avg is not None:
            self.w_avg.zero_()

    def forward(self, z: Optional[torch.Tensor],
                c: Optional[torch.Tensor] = None,
                truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None,
                update_w_avg: bool = False) -> torch.Tensor:
        """z ``[B, z_dim]`` (None where ``z_dim`` is 0; and the label ``c``
        ``[B, c_dim]`` of a conditional network) → ``[B, num_ws, w_dim]``
        (``[B, w_dim]`` where ``num_ws`` is None), pulled towards ``w_avg``
        by ``truncation_psi``, in the first ``truncation_cutoff`` ws only
        where that is given.  ``update_w_avg`` (training) first moves
        ``w_avg`` in place: ``β·w_avg + (1 − β)·mean(w)`` over the (global)
        batch, β = ``w_avg_beta``."""
        x = None
        if self.z_dim > 0:
            assert z.shape[-1] == self.z_dim
            x = normalize_2nd_moment(z.float())
        if self.c_dim > 0:
            if c is None:
                raise ValueError(f'a conditional mapping (c_dim '
                                 f'{self.c_dim}) needs a label c')
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=-1) if x is not None else y
        for idx in range(self.num_layers):
            x = getattr(self, f'fc{idx}')(x)
        if update_w_avg and self.w_avg is not None:
            with torch.no_grad():
                self.w_avg.copy_(self.w_avg_beta * self.w_avg
                                 + (1.0 - self.w_avg_beta)
                                 * mesh.global_mean(x.mean(dim=0)))
        if self.num_ws is not None:
            x = x[:, None, :].repeat(1, self.num_ws, 1)
        if truncation_psi != 1:
            if self.w_avg is None:
                raise ValueError('truncation needs w_avg (num_ws and '
                                 'w_avg_beta set)')
            if truncation_cutoff is None:
                x = self.w_avg + truncation_psi * (x - self.w_avg)
            else:
                head = self.w_avg + truncation_psi * (
                    x[:, :truncation_cutoff] - self.w_avg)
                x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
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
                truncation_cutoff: Optional[int] = None,
                update_w_avg: bool = False) -> torch.Tensor:
        x = super().forward(z, c, truncation_psi, truncation_cutoff,
                            update_w_avg)
        x = x.reshape(x.shape[0], self.num_ws, self.num_splits, self.w_dim)
        return x.transpose(1, 2)  # [B, L, num_ws, w_dim]
