"""Bilinear grid sampling (the spatial transformer's primitive).

Port of ``montage_gan_tpu/ops/grid_sample.py``: ``affine_grid`` +
``grid_sample`` with ``align_corners=False`` and bilinear interpolation, in
NHWC, as a gather of the four corner pixels and two lerps — the JAX
package's gather path (the one its CPU tests run).  Out-of-bounds samples
return ``pad_value`` (``-1`` is the STN's fill for [-1, 1] data).
"""

from __future__ import annotations

import torch


def affine_grid(theta: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``[N, 2, 3]`` inverse transforms → ``[N, H, W, 2]`` normalized (x, y)
    input coordinates (align_corners=False), computed in float32 as
    ``(t0 · x + t1 · y) + t2`` per coordinate, each step rounded (the warp
    kernel, ``csrc/warp.cu``, rounds the same steps)."""
    dev = theta.device

    def centers(n):
        # divided by a tensor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, which rounds otherwise than the
        # true division of the CPU, the JAX reference and csrc/warp.cu
        i = torch.arange(n, dtype=torch.float32, device=dev)
        return (2.0 * i + 1.0) / torch.full((), float(n), device=dev) - 1.0

    x, y = centers(width), centers(height)
    t = theta.float()[:, None, None]                             # [N,1,1,2,3]
    x, y = x[None, None, :], y[None, :, None]
    return torch.stack([t[..., r, 0] * x + t[..., r, 1] * y + t[..., r, 2]
                        for r in (0, 1)], dim=-1)


def grid_sample(x: torch.Tensor, grid: torch.Tensor,
                pad_value: float = 0.0) -> torch.Tensor:
    """Bilinear sampling of NHWC ``x`` ``[N, H, W, C]`` at normalized grid
    coords ``[N, Ho, Wo, 2]``; returns ``[N, Ho, Wo, C]``."""
    n, h, w, c = x.shape
    gx = grid[..., 0].float()
    gy = grid[..., 1].float()

    # Normalized [-1, 1] → pixel-center coordinates.
    ix = (gx + 1.0) * (w * 0.5) - 0.5
    iy = (gy + 1.0) * (h * 0.5) - 0.5

    ix0 = torch.floor(ix)
    iy0 = torch.floor(iy)
    tx = ix - ix0
    ty = iy - iy0
    ix0 = ix0.long()
    iy0 = iy0.long()
    ix1 = ix0 + 1
    iy1 = iy0 + 1
    batch = torch.arange(n, device=x.device).reshape(n, 1, 1)
    fill = torch.tensor(pad_value, dtype=x.dtype, device=x.device)

    def gather(iy_, ix_):
        valid = (ix_ >= 0) & (ix_ < w) & (iy_ >= 0) & (iy_ < h)
        vals = x[batch, iy_.clamp(0, h - 1), ix_.clamp(0, w - 1)]
        return torch.where(valid[..., None], vals, fill)

    tx = tx[..., None].to(x.dtype)
    ty = ty[..., None].to(x.dtype)
    v00 = gather(iy0, ix0)
    v01 = gather(iy0, ix1)
    v10 = gather(iy1, ix0)
    v11 = gather(iy1, ix1)
    top = v00 + (v01 - v00) * tx
    bot = v10 + (v11 - v10) * tx
    return top + (bot - top) * ty


def translate_to_theta(translation: torch.Tensor) -> torch.Tensor:
    """``[..., 2]`` translations → ``[..., 2, 3]`` affine matrices."""
    shape = translation.shape[:-1]
    eye = torch.eye(2, 3, dtype=torch.float32, device=translation.device)
    theta = eye.expand(*shape, 2, 3).clone()
    theta[..., :, 2] += translation.float()
    return theta


def translate_sample(x: torch.Tensor, translation: torch.Tensor,
                     pad_value: float = 0.0) -> torch.Tensor:
    """Translate NHWC images by normalized offsets ``[N, 2]`` (dx, dy): the
    sampling coordinate shifts by +t, so content moves by -t·(extent/2)
    pixels."""
    theta = translate_to_theta(translation)
    grid = affine_grid(theta, x.shape[1], x.shape[2])
    return grid_sample(x, grid, pad_value=pad_value)
