"""Image/layer layout helpers of ``montage_gan_tpu/utils/image_utils.py``:
the device half in PyTorch, and the host half (content crops for the local
Ds' reals) in numpy.

Layouts are NHWC: images ``[B, H, W, C]``, layer stacks ``[B, L, H, W, C]``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
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


def calc_psnr(x: torch.Tensor, y: torch.Tensor,
              data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB of ``x`` against ``y``."""
    mse = (x - y).square().mean()
    return 10.0 * torch.log10(data_range ** 2 / mse)


def stack_layer_to_channel(x: torch.Tensor) -> torch.Tensor:
    """[B, L, H, W, C] → [B, H, W, L*C] (channel index = l*C + c)."""
    b, l, h, w, c = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(b, h, w, l * c)


# ---------------------------------------------------------------------------
# Host side (numpy, the input pipeline): the data-dependent crops of
# montage_gan_tpu/utils/image_utils.py:110-157
# ---------------------------------------------------------------------------

def crop_to_content_np(img: np.ndarray) -> np.ndarray:
    """Crop an ``[H, W, 4]`` image to its nonzero-alpha bounding box (the
    reference's exclusive max bound)."""
    ys, xs = np.nonzero(img[..., 3])
    if len(ys) == 0:
        return img[:0, :0]
    return img[ys.min():ys.max(), xs.min():xs.max()]


def pad_center_np(img: np.ndarray, size: int = 256,
                  pad_value: float = 0.0) -> np.ndarray:
    h, w = img.shape[:2]
    pad_y, pad_x = size - h, size - w
    py0, px0 = pad_y // 2, pad_x // 2
    return np.pad(img, [(py0, pad_y - py0), (px0, pad_x - px0), (0, 0)],
                  constant_values=pad_value)


def generate_pseudo_fake_np(blhwc: np.ndarray) -> np.ndarray:
    """Re-center every layer's content.  Input ``[B, L, H, W, 4]`` in
    [0, 1]."""
    b, l, h, w, c = blhwc.shape
    out = np.zeros_like(blhwc)
    flat_in = blhwc.reshape(b * l, h, w, c)
    flat_out = out.reshape(b * l, h, w, c)
    for i in range(b * l):
        flat_out[i] = pad_center_np(crop_to_content_np(flat_in[i]), h)
    return out


def make_batch_for_local_d_np(blhwc: np.ndarray,
                              layer_size_list: Sequence[Tuple[int, int]],
                              to_minus11: bool = False) -> List[np.ndarray]:
    """Real montage layers → per-layer centered crops for the local Ds.
    Input ``[B, L, H, W, 4]`` in [0, 1]; returns a list of
    ``[B, h_l, w_l, 4]``."""
    if blhwc.min() < 0 or blhwc.max() > 1:
        raise ValueError('make_batch_for_local_d_np takes layers in [0, 1]')
    b, l, h, w, c = blhwc.shape
    centered = generate_pseudo_fake_np(blhwc)
    outs = []
    for idx, (bh, bw) in enumerate(layer_size_list):
        y0, x0 = (h - bh) // 2, (w - bw) // 2
        crop = centered[:, idx, y0:y0 + bh, x0:x0 + bw]
        outs.append(crop * 2.0 - 1.0 if to_minus11 else crop)
    return outs
