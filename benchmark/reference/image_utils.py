"""Image/layer layout helpers of ``montage_gan_tpu/utils/image_utils.py``:
the device half in PyTorch, and the host half (content crops for the local
Ds' reals) in numpy.

Layouts are NHWC: images ``[B, H, W, C]``, layer stacks ``[B, L, H, W, C]``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .grid_sample import translate_sample


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


def blend_white_bg(images: torch.Tensor) -> torch.Tensor:
    """RGBA [0, 1] ``[..., H, W, 4]`` → RGB [0, 1] over white (the
    ``alpha_composite`` of a white layer and ``images``;
    ``montage_gan_tpu/utils/image_utils.py:68-73``)."""
    from .composite import alpha_composite
    stack = torch.stack([torch.ones_like(images), images], dim=-4)
    return alpha_composite(stack, layer_axis=-4)[..., :3]


def random_position(layers: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    pad_value: float = 0.0,
                    translations: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Translate each layer of ``[B, L, H, W, C]`` to a uniform random
    position: normalized offsets ``[B * L, 2]`` in [-1, 1), drawn from
    ``generator`` (on the layers' device) unless ``translations`` gives
    them (``montage_gan_tpu/utils/image_utils.py:76-85``)."""
    b, l, h, w, c = layers.shape
    if translations is None:
        translations = torch.rand((b * l, 2), generator=generator,
                                  device=layers.device) * 2.0 - 1.0
    moved = translate_sample(layers.reshape(b * l, h, w, c),
                             translations.to(layers.device),
                             pad_value=pad_value)
    return moved.reshape(b, l, h, w, c)


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


# PIL's LANCZOS resize of an 8-bit RGBA image (Pillow's Resample.c: the
# coefficients in double, normalized to 22-bit fixed point; a horizontal
# pass, then a vertical one, each rounding to 8 bits; RGBA resized as
# premultiplied RGBa, Convert.c).
_PRECISION_BITS = 32 - 8 - 2
_LANCZOS_SUPPORT = 3.0


def _lanczos(x: np.ndarray) -> np.ndarray:
    def sinc(v):
        safe = np.where(v == 0.0, 1.0, v * np.pi)
        return np.where(v == 0.0, 1.0, np.sin(safe) / safe)
    return np.where((x >= -3.0) & (x < 3.0), sinc(x) * sinc(x / 3.0), 0.0)


def _resample_coeffs(in_size: int, out_size: int):
    """(first input index, fixed-point weights ``[out, ksize]``) of one
    axis."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    kk = np.zeros((out_size, ksize), np.float64)
    first = np.zeros(out_size, np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _lanczos((np.arange(xmax) + xmin - center + 0.5) / filterscale)
        total = w.sum()
        kk[xx, :xmax] = w / total if total != 0.0 else w
        first[xx] = xmin
    fixed = np.where(kk < 0, -0.5 + kk * (1 << _PRECISION_BITS),
                     0.5 + kk * (1 << _PRECISION_BITS)).astype(np.int64)
    return first, fixed


def _resample_axis(u8: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    first, fixed = _resample_coeffs(u8.shape[axis], out_size)
    src = np.moveaxis(u8, axis, 0).astype(np.int64)
    acc = np.full((out_size, *src.shape[1:]), 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for k in range(fixed.shape[1]):
        idx = np.minimum(first + k, src.shape[0] - 1)
        acc += src[idx] * fixed[:, k].reshape(-1, *[1] * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_lanczos(u8: np.ndarray, width: int, height: int) -> np.ndarray:
    """``PIL.Image.fromarray(u8).resize((width, height), Image.LANCZOS)``
    for an ``[H, W, C]`` uint8 image in a mode PIL resizes channel by
    channel (C = 1 'L', C = 3 'RGB'): a copy where the size already matches;
    else resized horizontally then vertically, each pass rounded to 8
    bits."""
    if u8.shape[:2] == (height, width):
        return u8.copy()
    if width != u8.shape[1]:
        u8 = _resample_axis(u8, width, 1)
    if height != u8.shape[0]:
        u8 = _resample_axis(u8, height, 0)
    return u8


def resize_lanczos_rgba(u8: np.ndarray, width: int, height: int
                        ) -> np.ndarray:
    """``PIL.Image.fromarray(u8, 'RGBA').resize((width, height),
    Image.LANCZOS)`` for an ``[H, W, 4]`` uint8 image: a copy where the size
    already matches; else premultiplied by alpha (8-bit), resized as
    ``resize_lanczos``, and un-premultiplied (8-bit)."""
    if u8.shape[:2] == (height, width):
        return u8.copy()
    a = u8[..., 3:].astype(np.uint32)
    tmp = u8[..., :3].astype(np.uint32) * a + 128
    pre = resize_lanczos(np.concatenate([((tmp >> 8) + tmp) >> 8, a],
                                        axis=-1).astype(np.uint8),
                         width, height)
    alpha = pre[..., 3:].astype(np.int64)
    color = pre[..., :3].astype(np.int64)
    straight = np.clip(255 * color // np.maximum(alpha, 1), 0, 255)
    keep = (alpha == 255) | (alpha == 0)
    color = np.where(keep, color, straight)
    return np.concatenate([color, alpha], axis=-1).astype(np.uint8)


def alpha_composite_np(layers: np.ndarray) -> np.ndarray:
    """Numpy straight-alpha composite (``[..., L, H, W, 4]`` in [0, 1]) of
    ``montage_gan_tpu/utils/image_utils.py:158``, for the training loop's
    image grids."""
    canvas = layers[..., 0, :, :, :]
    for i in range(1, layers.shape[-4]):
        top = layers[..., i, :, :, :]
        ca, ta = canvas[..., 3:], top[..., 3:]
        ao = ta + ca * (1 - ta)
        safe = np.where(ao == 0, 1.0, ao)
        co = np.where(ao == 0, 0.0,
                      (top[..., :3] * ta + canvas[..., :3] * ca * (1 - ta))
                      / safe)
        canvas = np.concatenate([co, ao], axis=-1)
    return canvas
