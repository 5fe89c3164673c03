"""Pad → zero-upsample → FIR filter → downsample, fused.

Port of ``montage_gan_tpu/ops/upfirdn2d.py`` (same op contract, NHWC).

Two paths, chosen by the device of ``x``:
  * a CPU tensor takes the plain PyTorch version (``upfirdn2d_ref``): the
    zero-upsampled, padded image is built explicitly and filtered by a
    depthwise ``F.conv2d``; a 1-D filter runs as two 1-D passes of
    ``sqrt(gain)`` each, as in the JAX op;
  * a CUDA tensor launches kernel K2' (``csrc/upfirdn2d.cu``), which takes 2-D
    and 1-D filters alike.  It is forward-only: on a CUDA tensor that
    requires grad the wrapper raises (the op's VJP, the same op with
    transposed parameters, comes with the training port).

Filters are float32 tensors from ``setup_filter`` (modules keep them as
buffers on the device), numpy arrays, or None (identity).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .cuda import CudaKernel, stream_handle

IntOrPair = Union[int, Sequence[int]]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

kernel = CudaKernel('upfirdn2d', 'mgt_upfirdn2d', [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 17
    + [ctypes.c_float, ctypes.c_void_p])


def _parse_scaling(scaling: IntOrPair) -> Tuple[int, int]:
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    assert sx >= 1 and sy >= 1
    return int(sx), int(sy)


def _parse_padding(padding: IntOrPair) -> Tuple[int, int, int, int]:
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    padx0, padx1, pady0, pady1 = padding
    return int(padx0), int(padx1), int(pady0), int(pady1)


def _filter_size(f) -> Tuple[int, int]:
    if f is None:
        return 1, 1
    if f.ndim == 1:
        return int(f.shape[0]), int(f.shape[0])
    return int(f.shape[0]), int(f.shape[1])


def _as_filter(f, device) -> torch.Tensor:
    """None / numpy / tensor → float32 tensor on ``device`` (1-D or 2-D)."""
    if f is None:
        f = torch.ones([1, 1])
    f = torch.as_tensor(f, dtype=torch.float32).to(device)
    if f.ndim == 0:
        f = f.reshape(1, 1)
    assert f.ndim in (1, 2)
    return f


def zero_insert_pad(x: torch.Tensor, up: Tuple[int, int],
                    pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """NHWC ``x`` → zero-upsampled (``x`` at every ``up``-th sample, trailing
    zeros included, size ``H*upy × W*upx``), then padded by
    ``(padx0, padx1, pady0, pady1)``; negative pads crop.  Returns an NCHW
    view in channels-last memory, ready for ``F.conv2d``."""
    upx, upy = up
    padx0, padx1, pady0, pady1 = pad
    n, h, w, c = x.shape
    hu, wu = h * upy, w * upx
    py0, py1, px0, px1 = (max(p, 0) for p in (pady0, pady1, padx0, padx1))
    if (upx, upy) == (1, 1) and py0 == py1 == px0 == px1 == 0:
        out = x
    else:
        out = x.new_zeros(n, py0 + hu + py1, px0 + wu + px1, c)
        out[:, py0:py0 + hu:upy, px0:px0 + wu:upx, :] = x
    cy0, cy1, cx0, cx1 = (max(-p, 0) for p in (pady0, pady1, padx0, padx1))
    out = out[:, cy0:out.shape[1] - cy1, cx0:out.shape[2] - cx1, :]
    return out.permute(0, 3, 1, 2)


def _depthwise_fir(x: torch.Tensor, f: torch.Tensor, up, down, pad,
                   gain: float, flip_filter: bool) -> torch.Tensor:
    """One 2-D pass (the JAX ``_depthwise_fir``): NHWC → NHWC."""
    c = x.shape[-1]
    f = f * (gain ** (f.ndim / 2))
    if not flip_filter:
        f = f.flip([0, 1])
    weight = f[None, None].repeat(c, 1, 1, 1).to(x.dtype)
    xp = zero_insert_pad(x, up, pad)
    y = F.conv2d(xp, weight, stride=(down[1], down[0]), groups=c)
    return y.permute(0, 2, 3, 1)


def upfirdn2d_ref(x: torch.Tensor, f, up: IntOrPair = 1, down: IntOrPair = 1,
                  padding: IntOrPair = 0, flip_filter: bool = False,
                  gain: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version, on any device."""
    assert x.ndim == 4
    f = _as_filter(f, x.device)
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    if f.ndim == 2:
        return _depthwise_fir(x, f, (upx, upy), (downx, downy),
                              (padx0, padx1, pady0, pady1), gain, flip_filter)
    # Separable: two 1-D passes, sqrt(gain) each (JAX upfirdn2d.py:154-163).
    g = float(np.sqrt(gain))
    x = _depthwise_fir(x, f[None, :], (upx, 1), (downx, 1),
                       (padx0, padx1, 0, 0), g, flip_filter)
    return _depthwise_fir(x, f[:, None], (1, upy), (1, downy),
                          (0, 0, pady0, pady1), g, flip_filter)


def upfirdn2d_cuda(x: torch.Tensor, f, up: IntOrPair = 1, down: IntOrPair = 1,
                   padding: IntOrPair = 0, flip_filter: bool = False,
                   gain: float = 1.0) -> torch.Tensor:
    """Kernel K2' on a CUDA tensor; raises on what the kernel does not take."""
    if x.device.type != 'cuda':
        raise ValueError(f'upfirdn2d_cuda needs a CUDA tensor, got {x.device}')
    if x.ndim != 4:
        raise ValueError(f'upfirdn2d kernel takes NHWC, got shape {tuple(x.shape)}')
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f'upfirdn2d kernel takes float32 or bfloat16, got {x.dtype}')
    if not x.is_contiguous():
        raise ValueError('upfirdn2d kernel needs a contiguous x')
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError('upfirdn2d kernel is forward-only; its autograd '
                           'Function comes with the training port')
    f = _as_filter(f, x.device).contiguous()
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    n, h, w, c = x.shape
    fh, fw = _filter_size(f)
    out_h = (h * upy + pady0 + pady1 - fh) // downy + 1
    out_w = (w * upx + padx0 + padx1 - fw) // downx + 1
    if out_h < 1 or out_w < 1:
        raise ValueError(f'upfirdn2d output would be empty ({out_h}x{out_w})')
    y = torch.empty(n, out_h, out_w, c, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return y
    separable = f.ndim == 1
    tap_gain = math.sqrt(gain) if separable else gain
    kernel.launch(x.data_ptr(), y.data_ptr(), f.data_ptr(),
                  _DTYPE_CODES[x.dtype], n, h, w, c, out_h, out_w,
                  upx, upy, downx, downy, padx0, pady0, fh, fw,
                  int(separable), int(flip_filter), float(tap_gain),
                  stream_handle(x.device))
    return y


def upfirdn2d(x: torch.Tensor, f, up: IntOrPair = 1, down: IntOrPair = 1,
              padding: IntOrPair = 0, flip_filter: bool = False,
              gain: float = 1.0) -> torch.Tensor:
    """Upsample, FIR-filter, and downsample a batch of NHWC images.

    Args:
        x: ``[N, H, W, C]``.
        f: float32 FIR filter ``[fh, fw]``, ``[taps]`` (separable), or None.
        up / down: integer or ``[x, y]`` scaling factors.
        padding: int, ``[x, y]`` or ``[x0, x1, y0, y1]`` w.r.t. the upsampled
            image; negative values crop.
        flip_filter: False = convolution, True = correlation.
        gain: overall magnitude scaling.
    """
    if x.device.type == 'cpu':
        return upfirdn2d_ref(x, f, up, down, padding, flip_filter, gain)
    return upfirdn2d_cuda(x, f, up, down, padding, flip_filter, gain)


def filter2d(x: torch.Tensor, f, padding: IntOrPair = 0,
             flip_filter: bool = False, gain: float = 1.0) -> torch.Tensor:
    """Filter without resampling, keeping spatial size."""
    fh, fw = _filter_size(f)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    p = [padx0 + fw // 2, padx1 + (fw - 1) // 2,
         pady0 + fh // 2, pady1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x: torch.Tensor, f, up: IntOrPair = 2, padding: IntOrPair = 0,
               flip_filter: bool = False, gain: float = 1.0) -> torch.Tensor:
    """Upsample with the given filter."""
    upx, upy = _parse_scaling(up)
    fh, fw = _filter_size(f)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    p = [padx0 + (fw + upx - 1) // 2, padx1 + (fw - upx) // 2,
         pady0 + (fh + upy - 1) // 2, pady1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def downsample2d(x: torch.Tensor, f, down: IntOrPair = 2,
                 padding: IntOrPair = 0, flip_filter: bool = False,
                 gain: float = 1.0) -> torch.Tensor:
    """Downsample with the given filter."""
    downx, downy = _parse_scaling(down)
    fh, fw = _filter_size(f)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    p = [padx0 + (fw - downx + 1) // 2, padx1 + (fw - downx) // 2,
         pady0 + (fh - downy + 1) // 2, pady1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter,
                     gain=gain)
