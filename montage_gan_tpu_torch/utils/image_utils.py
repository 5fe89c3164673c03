"""Image/layer layout helpers (the device half of
``montage_gan_tpu/utils/image_utils.py``).

Layouts are NHWC: images ``[B, H, W, C]``, layer stacks ``[B, L, H, W, C]``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def normalize_minus11(x):
    """[0, 1] → [-1, 1]."""
    return x * 2.0 - 1.0


def normalize_zero1(x):
    """[-1, 1] → [0, 1]."""
    return (x + 1.0) / 2.0


def pad_center(x: torch.Tensor, size: int = 256,
               pad_value: float = 0.0) -> torch.Tensor:
    """Center-pad NHWC images to ``size``²."""
    h, w = x.shape[-3], x.shape[-2]
    pad_y, pad_x = size - h, size - w
    py0, px0 = pad_y // 2, pad_x // 2
    py1, px1 = pad_y - py0, pad_x - px0
    return F.pad(x, (0, 0, px0, px1, py0, py1), value=pad_value)


def make_batch_for_pos_estimator(list_of_bhwc: Sequence[torch.Tensor],
                                 size: int = 256,
                                 pad_value: float = 0.0) -> torch.Tensor:
    """List of per-layer batches (various sizes) → ``[B, L, size, size, C]``."""
    return torch.stack([pad_center(x, size, pad_value) for x in list_of_bhwc],
                       dim=1)


def stack_layer_to_channel(x: torch.Tensor) -> torch.Tensor:
    """[B, L, H, W, C] → [B, H, W, L*C] (channel index = l*C + c)."""
    b, l, h, w, c = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(b, h, w, l * c)
