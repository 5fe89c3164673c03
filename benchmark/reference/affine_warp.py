"""The augment pipe's affine warp, the plain version only.

Frozen copy of the port's ``affine_warp_ref``: the virtual upsample is
built, then bilinearly sampled on the affine grid; no gradient reaches
theta."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .grid_sample import affine_grid, grid_sample
from .upfirdn2d import upsample2d


def _taps(up: int, up_filter, device) -> torch.Tensor:
    """The 1-D filter as a float32 tensor on ``device`` ([1] for up = 1)."""
    if up == 1:
        if up_filter is not None:
            raise ValueError('up_filter requires up > 1')
        return torch.ones(1, device=device)
    if up_filter is None:
        raise ValueError('up > 1 requires up_filter taps')
    f = torch.as_tensor(np.asarray(up_filter, np.float32)
                        if not isinstance(up_filter, torch.Tensor)
                        else up_filter, dtype=torch.float32).to(device)
    if f.ndim != 1:
        raise ValueError('the fused upsample takes a separable 1-D filter')
    return f.contiguous()


def affine_warp(x: torch.Tensor, theta: torch.Tensor, out_h: int, out_w: int,
                up: int = 2, up_filter: Optional[object] = None) -> torch.Tensor:
    """Bilinear-sample NHWC ``x`` in float32 through a virtual ``up``x
    upsample on the affine grid of ``theta``."""
    theta = theta.detach().float()
    x = x.float()
    if up > 1:
        x = upsample2d(x, _taps(up, up_filter, x.device), up=up)
    return grid_sample(x, affine_grid(theta, out_h, out_w))
