"""The ADA geometric warp: an affine bilinear resample of a virtual ``up``×
FIR upsample.

Port of the contract of ``montage_gan_tpu/ops/affine_warp.py::affine_warp``:

    affine_warp(x, theta, out_h, out_w, up, up_filter)
        == grid_sample(upsample2d(x, up_filter, up), affine_grid(theta))

with bilinear sampling, ``align_corners=False`` and zeros padding, on NHWC
float32.  ``theta`` ``[N, 2, 3]`` maps output coordinates to input
coordinates over the virtual ``[up·H, up·W]`` plane and gets no gradient
(every caller draws it at random).

Two paths, chosen by the device of ``x``:
  * a CPU tensor takes the plain version (``affine_warp_ref``), which is the
    JAX package's CPU oracle ``_gather_warp`` (``training/augment.py:461-464``):
    ``upsample2d_ref`` and then the gather ``grid_sample``; autograd gives
    its transpose;
  * a CUDA tensor goes through the mutually adjoint autograd Functions
    ``_Warp`` (kernel K3', ``csrc/warp.cu``) and ``_WarpT`` (kernel K4', the
    exact adjoint of K3' with respect to ``x``): the backward of each is the
    other, so R1's grad-of-grad runs K3' again (JAX
    ``ops/affine_warp.py:636-680``).  K4' accumulates with atomics and is not
    bit-deterministic from run to run.

The TPU tiling knobs of the JAX engines (``tile``, ``block``, ``chunk``,
``MGT_WARP_*``) have no counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .cuda import CudaKernel, stream_handle, takes_plain, tensor_bytes
from .grid_sample import affine_grid, grid_sample
from .upfirdn2d import upsample2d_ref

_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
forward_kernel = CudaKernel('warp', 'mgt_warp_forward', _SIGNATURE)
transpose_kernel = CudaKernel('warp', 'mgt_warp_transpose', _SIGNATURE)


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


def affine_warp_ref(x: torch.Tensor, theta: torch.Tensor, out_h: int,
                    out_w: int, up: int = 2, up_filter=None) -> torch.Tensor:
    """The plain version, on any device: the upsample is built, then
    sampled."""
    theta = theta.detach().float()
    if up > 1:
        x = upsample2d_ref(x, _taps(up, up_filter, x.device), up=up)
    return grid_sample(x, affine_grid(theta, out_h, out_w))


def _check(t: torch.Tensor, name: str) -> None:
    if t.device.type != 'cuda':
        raise ValueError(f'warp kernel needs CUDA tensors, got {name} on '
                         f'{t.device}')
    if t.dtype != torch.float32:
        raise TypeError(f'warp kernel takes float32, got {name} {t.dtype}')
    if not t.is_contiguous():
        raise ValueError(f'warp kernel needs a contiguous {name}')


def _launch(kern: CudaKernel, src: torch.Tensor, theta: torch.Tensor,
            taps: torch.Tensor, dst: torch.Tensor, in_hw, out_hw,
            up: int) -> None:
    for t, name in ((src, 'input'), (theta, 'theta'), (taps, 'taps'),
                    (dst, 'output')):
        _check(t, name)
    n, c = src.shape[0], src.shape[-1]
    if theta.shape != (n, 2, 3):
        raise ValueError(f'theta {tuple(theta.shape)} is not [{n}, 2, 3]')
    if taps.shape[0] // up + 2 > 8:
        raise ValueError(f'{taps.shape[0]} taps at up {up}: the kernel reads '
                         'at most 8 stored samples per axis')
    kern.launch(src.data_ptr(), theta.data_ptr(), taps.data_ptr(),
                dst.data_ptr(), n, in_hw[0], in_hw[1], c, out_hw[0],
                out_hw[1], taps.shape[0], up, stream_handle(src.get_device()),
                nbytes=tensor_bytes(src, theta, taps, dst))


def warp_forward_cuda(x: torch.Tensor, theta: torch.Tensor, out_h: int,
                      out_w: int, up: int, taps: torch.Tensor) -> torch.Tensor:
    """Kernel K3' (no autograd): ``x`` ``[N, H, W, C]`` → ``[N, out_h,
    out_w, C]``."""
    n, h, w, c = x.shape
    out = torch.empty(n, out_h, out_w, c, dtype=x.dtype, device=x.device)
    _launch(forward_kernel, x, theta, taps, out, (h, w), (out_h, out_w), up)
    return out


def warp_transpose_cuda(g: torch.Tensor, theta: torch.Tensor, h: int, w: int,
                        up: int, taps: torch.Tensor) -> torch.Tensor:
    """Kernel K4' (no autograd): the adjoint of K3', ``g`` ``[N, out_h,
    out_w, C]`` → ``[N, h, w, C]``."""
    n, out_h, out_w, c = g.shape
    dx = torch.zeros(n, h, w, c, dtype=g.dtype, device=g.device)
    _launch(transpose_kernel, g, theta, taps, dx, (h, w), (out_h, out_w), up)
    return dx


class _Warp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, theta, taps, out_h, out_w, up):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(theta, taps)
        ctx.params = (x.shape[1], x.shape[2], out_h, out_w, up)
        return warp_forward_cuda(x, theta, out_h, out_w, up, taps)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return (None,) * 6
        theta, taps = ctx.saved_tensors
        h, w, out_h, out_w, up = ctx.params
        dx = _WarpT.apply(g.float().contiguous(), theta, taps, h, w, up)
        return dx, None, None, None, None, None


class _WarpT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, theta, taps, h, w, up):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(theta, taps)
        ctx.params = (g.shape[1], g.shape[2], up)
        return warp_transpose_cuda(g, theta, h, w, up, taps)

    @staticmethod
    def backward(ctx, dd):
        if dd is None:
            return (None,) * 6
        theta, taps = ctx.saved_tensors
        out_h, out_w, up = ctx.params
        dg = _Warp.apply(dd.float().contiguous(), theta, taps, out_h, out_w,
                         up)
        return dg, None, None, None, None, None


def affine_warp(x: torch.Tensor, theta: torch.Tensor, out_h: int, out_w: int,
                up: int = 2, up_filter: Optional[object] = None) -> torch.Tensor:
    """Bilinear-sample NHWC ``x`` (through a virtual ``up``× upsample with
    the 1-D ``up_filter`` when ``up > 1``) on the affine grid of ``theta``.

    Args:
        x: ``[N, H, W, C]`` float32.
        theta: ``[N, 2, 3]`` inverse transforms in the normalized
            ``affine_grid`` convention, over the virtual ``[up·H, up·W]``
            plane; no gradient flows to it.
        out_h, out_w: output size.
        up, up_filter: the virtual upsample (``upsample2d`` with its gain
            ``up²`` and padding).
    Returns:
        ``[N, out_h, out_w, C]``.
    """
    if takes_plain(x):
        return affine_warp_ref(x, theta, out_h, out_w, up, up_filter)
    return _Warp.apply(x.float().contiguous(),
                       theta.detach().float().contiguous(),
                       _taps(up, up_filter, x.device), out_h, out_w, up)
