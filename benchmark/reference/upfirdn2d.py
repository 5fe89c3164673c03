"""Upsample, FIR-filter and downsample (upfirdn2d), the plain version only.

Frozen copy of the port's ``upfirdn2d_ref`` and the resampling helpers
built on it: a zero-insert and pad, then a depthwise ``F.conv2d`` per pass.
Activations are NHWC."""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

IntOrPair = Union[int, Tuple[int, int], list]


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


def _out_size(h: int, w: int, up, down, pad, fh: int, fw: int):
    """(out_h, out_w) of ``upfirdn2d`` on an ``h × w`` input."""
    return ((h * up[1] + pad[2] + pad[3] - fh) // down[1] + 1,
            (w * up[0] + pad[0] + pad[1] - fw) // down[0] + 1)


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


upfirdn2d = upfirdn2d_ref


def filter2d(x: torch.Tensor, f, padding: IntOrPair = 0,
             flip_filter: bool = False, gain: float = 1.0) -> torch.Tensor:
    """Filter without resampling, keeping spatial size."""
    fh, fw = _filter_size(f)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    p = [padx0 + fw // 2, padx1 + (fw - 1) // 2,
         pady0 + fh // 2, pady1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x: torch.Tensor, f, up: IntOrPair = 2, padding: IntOrPair = 0,
               flip_filter: bool = False, gain: float = 1.0,
               op=None) -> torch.Tensor:
    """Upsample with the given filter (through ``op``, by default
    ``upfirdn2d``; ``upsample2d_ref`` passes the plain version)."""
    upx, upy = _parse_scaling(up)
    fh, fw = _filter_size(f)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    p = [padx0 + (fw + upx - 1) // 2, padx1 + (fw - upx) // 2,
         pady0 + (fh + upy - 1) // 2, pady1 + (fh - upy) // 2]
    return (op or upfirdn2d)(x, f, up=up, padding=p, flip_filter=flip_filter,
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
