"""Pad → zero-upsample → FIR filter → downsample, fused.

Port of ``montage_gan_tpu/ops/upfirdn2d.py`` (same op contract, NHWC).

Two paths, chosen by the device of ``x``:
  * a CPU tensor takes the plain PyTorch version (``upfirdn2d_ref``): the
    zero-upsampled, padded image is built explicitly and filtered by a
    depthwise ``F.conv2d``; a 1-D filter runs as two 1-D passes of
    ``sqrt(gain)`` each, as in the JAX op;
  * a CUDA tensor goes through the autograd Function ``_Upfirdn2dCuda``,
    which launches kernel K2' (``csrc/upfirdn2d.cu``; 2-D and 1-D filters
    alike).  The op is linear in ``x``, so its backward is K2' itself with
    transposed parameters (``up`` and ``down`` swapped, the filter flipped,
    the reference's transposed padding), and the backward of that is the
    forward again: every gradient order runs the one kernel.

K2' has three variants, chosen from the parameters alone by
``kernel_variant`` and counted apart on ``kernel.variants``: ``up2`` (up 2,
down 1) and ``down2`` (up 1, down 2) with a filter of at most 4×4, tiled in
shared memory (the ToRGB skip, its gradient and its second order), and
``generic`` for every other parameter set.  ``_tile_plan`` gives the tiled
variants' geometry, which the kernel computes the same way.

Filters are float32 tensors from ``setup_filter`` (modules keep them as
buffers on the device), numpy arrays, or None (identity).

For ``torch.export`` K2' is also an operator of ``torch.library``
(``mgt::upfirdn2d``): an exported program keeps it as one graph node, whose
CUDA face launches the kernel and whose CPU face is the plain version.
``upfirdn2d`` routes to it only while exporting; eager code launches the
kernel directly.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .cuda import (CudaKernel, launch_device, stream_handle, takes_plain,
                   tensor_bytes)

IntOrPair = Union[int, Sequence[int]]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

kernel = CudaKernel('upfirdn2d', 'mgt_upfirdn2d', [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 17
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

# The variants (csrc/upfirdn2d.cu MgtUpfirdnVariant) and the tiled ones'
# output tiles, (rows, columns), as csrc/upfirdn2d.cu MgtTile has them.
VARIANT_CODES = {'generic': 0, 'up2': 1, 'down2': 2}
TILES = {'up2': (32, 32), 'down2': (16, 32)}
TILED_FMAX = 4                 # the largest filter side the tiled kernel takes
MAX_SMEM = 232448              # 227 KB, an H100 block's shared memory


def _footprint_side(tile: int, up: int, down: int, f: int) -> int:
    """Most input samples a run of ``tile`` outputs reads along one axis:
    the multiples of ``up`` among ``(tile - 1) * down + f`` consecutive
    upsampled samples."""
    return ((tile - 1) * down + f + up - 1) // up


def _axis_span(t0: int, t1: int, up: int, down: int, pad0: int,
               f: int) -> Tuple[int, int]:
    """Input samples ``[lo, hi)`` that outputs ``[t0, t1)`` read along one
    axis (out-of-image ones included: they are the zero pad)."""
    lo = -((pad0 - t0 * down) // up)                   # ceil((t0 d - p) / u)
    hi = ((t1 - 1) * down - pad0 + f - 1) // up + 1
    return lo, hi


@dataclass(frozen=True)
class TilePlan:
    """Geometry of K2''s tiled variants for one parameter set: one block
    per ``tile`` of outputs of one image; it stages its input ``footprint``
    (at most ``footprint`` rows × columns, ``smem_bytes`` with the filter,
    as float32) in shared memory."""
    in_hw: Tuple[int, int]
    out_hw: Tuple[int, int]
    up: Tuple[int, int]                # (x, y)
    down: Tuple[int, int]
    pad0: Tuple[int, int]              # (padx0, pady0)
    filter_hw: Tuple[int, int]
    tile: Tuple[int, int]              # (rows, columns)
    grid: Tuple[int, int]              # (tiles along x, tiles along y)
    footprint: Tuple[int, int]         # (rows, columns), the most any reads
    smem_bytes: int

    def tile_box(self, ty: int, tx: int) -> Tuple[int, int, int, int]:
        """Output rows ``[y0, y1)`` and columns ``[x0, x1)`` of tile
        (ty, tx), clipped to the output."""
        th, tw = self.tile
        y0, x0 = ty * th, tx * tw
        return (y0, min(y0 + th, self.out_hw[0]), x0,
                min(x0 + tw, self.out_hw[1]))

    def footprint_of(self, ty: int, tx: int) -> Tuple[int, int, int, int]:
        """Input rows ``[iy0, iy1)`` and columns ``[ix0, ix1)`` that tile
        (ty, tx) reads; the block stages them from ``(iy0, ix0)``, samples
        outside the image as zeros."""
        y0, y1, x0, x1 = self.tile_box(ty, tx)
        fh, fw = self.filter_hw
        iy0, iy1 = _axis_span(y0, y1, self.up[1], self.down[1], self.pad0[1],
                              fh)
        ix0, ix1 = _axis_span(x0, x1, self.up[0], self.down[0], self.pad0[0],
                              fw)
        return iy0, iy1, ix0, ix1

    def tiles(self) -> Iterator[Tuple[int, int]]:
        for ty in range(self.grid[1]):
            for tx in range(self.grid[0]):
                yield ty, tx


@functools.lru_cache(maxsize=256)
def _tile_plan(h: int, w: int, out_h: int, out_w: int, up: Tuple[int, int],
               down: Tuple[int, int], pad: Tuple[int, int, int, int], fh: int,
               fw: int, tile: Tuple[int, int], channels: int = 1) -> TilePlan:
    """The tiled geometry of K2' (``up``, ``down`` as (x, y); ``pad`` as
    ``(padx0, padx1, pady0, pady1)``; ``tile`` as (rows, columns))."""
    th, tw = tile
    fph = _footprint_side(th, up[1], down[1], fh)
    fpw = _footprint_side(tw, up[0], down[0], fw)
    return TilePlan(in_hw=(h, w), out_hw=(out_h, out_w), up=tuple(up),
                    down=tuple(down), pad0=(pad[0], pad[2]),
                    filter_hw=(fh, fw), tile=(th, tw),
                    grid=(-(-out_w // tw), -(-out_h // th)),
                    footprint=(fph, fpw),
                    smem_bytes=4 * (TILED_FMAX * TILED_FMAX
                                    + fph * fpw * channels))


def kernel_variant(up: Tuple[int, int], down: Tuple[int, int], fh: int,
                   fw: int, channels: int) -> str:
    """The variant of K2' that takes these parameters: ``up2`` or
    ``down2`` for up 2 or down 2 on both axes with a filter of at most
    4×4 whose footprint fits a block's shared memory, else ``generic``."""
    name = {((2, 2), (1, 1)): 'up2', ((1, 1), (2, 2)): 'down2'}.get(
        (tuple(up), tuple(down)))
    if name is None or fh > TILED_FMAX or fw > TILED_FMAX:
        return 'generic'
    tile = TILES[name]
    need = 4 * (TILED_FMAX * TILED_FMAX
                + _footprint_side(tile[0], up[1], down[1], fh)
                * _footprint_side(tile[1], up[0], down[0], fw) * channels)
    return name if need <= MAX_SMEM else 'generic'


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


def upfirdn2d_cuda(x: torch.Tensor, f, up: IntOrPair = 1, down: IntOrPair = 1,
                   padding: IntOrPair = 0, flip_filter: bool = False,
                   gain: float = 1.0) -> torch.Tensor:
    """Kernel K2' on a CUDA tensor (no autograd); raises on what the kernel
    does not take."""
    if x.device.type != 'cuda':
        raise ValueError(f'upfirdn2d_cuda needs a CUDA tensor, got {x.device}')
    if x.ndim != 4:
        raise ValueError(f'upfirdn2d kernel takes NHWC, got shape {tuple(x.shape)}')
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f'upfirdn2d kernel takes float32 or bfloat16, got {x.dtype}')
    if not x.is_contiguous():
        raise ValueError('upfirdn2d kernel needs a contiguous x')
    f = _as_filter(f, x.device).contiguous()
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    n, h, w, c = x.shape
    fh, fw = _filter_size(f)
    out_h, out_w = _out_size(h, w, (upx, upy), (downx, downy),
                             (padx0, padx1, pady0, pady1), fh, fw)
    if out_h < 1 or out_w < 1:
        raise ValueError(f'upfirdn2d output would be empty ({out_h}x{out_w})')
    y = torch.empty(n, out_h, out_w, c, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return y
    separable = f.ndim == 1
    tap_gain = math.sqrt(gain) if separable else gain
    variant = kernel_variant((upx, upy), (downx, downy), fh, fw, c)
    smem = 0
    if variant != 'generic':
        smem = _tile_plan(h, w, out_h, out_w, (upx, upy), (downx, downy),
                          (padx0, padx1, pady0, pady1), fh, fw,
                          TILES[variant], c).smem_bytes
    kernel.launch(x.data_ptr(), y.data_ptr(), f.data_ptr(),
                  _DTYPE_CODES[x.dtype], n, h, w, c, out_h, out_w,
                  upx, upy, downx, downy, padx0, pady0, fh, fw,
                  int(separable), int(flip_filter), float(tap_gain),
                  VARIANT_CODES[variant], smem, stream_handle(launch_device(x)),
                  variant=variant, nbytes=tensor_bytes(x, f, y))
    return y


@torch.library.custom_op('mgt::upfirdn2d', mutates_args=())
def upfirdn2d_op(x: torch.Tensor, f: torch.Tensor, up: List[int],
                 down: List[int], padding: List[int], flip_filter: bool,
                 gain: float) -> torch.Tensor:
    """K2' as an operator (CPU face: the plain version); ``up``, ``down``
    as ``[x, y]``, ``padding`` as ``[x0, x1, y0, y1]``."""
    return upfirdn2d_ref(x, f, up, down, padding, flip_filter, gain)


@upfirdn2d_op.register_kernel('cuda')
def _upfirdn2d_op_cuda(x, f, up, down, padding, flip_filter, gain):
    return upfirdn2d_cuda(x.contiguous(), f.contiguous(), up, down, padding,
                          flip_filter, gain)


@upfirdn2d_op.register_fake
def _upfirdn2d_op_fake(x, f, up, down, padding, flip_filter, gain):
    fh, fw = _filter_size(f)
    n, h, w, c = x.shape
    return x.new_empty(n, *_out_size(h, w, up, down, padding, fh, fw), c)


class _Upfirdn2dCuda(torch.autograd.Function):
    """K2' with its transposed self as backward (reference
    ``torch_utils/ops/upfirdn2d.py::_upfirdn2d_cuda``; JAX
    ``ops/pallas/upfirdn2d_kernel.py:204-219``)."""

    @staticmethod
    def forward(ctx, x, f, up, down, pad, flip_filter, gain):
        y = upfirdn2d_cuda(x, f, up, down, pad, flip_filter, gain)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(f)
        ctx.params = (up, down, pad, flip_filter, gain)
        ctx.in_hw = x.shape[1:3]
        return y

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return (None,) * 7
        f, = ctx.saved_tensors
        (upx, upy), (downx, downy), (padx0, _, pady0, _), flip, gain = \
            ctx.params
        ih, iw = ctx.in_hw
        oh, ow = dy.shape[1:3]
        fh, fw = _filter_size(f)
        pad = (fw - padx0 - 1, iw * upx - ow * downx + padx0 - upx + 1,
               fh - pady0 - 1, ih * upy - oh * downy + pady0 - upy + 1)
        dx = _Upfirdn2dCuda.apply(dy.contiguous(), f, (downx, downy),
                                  (upx, upy), pad, not flip, gain)
        return dx, None, None, None, None, None, None


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
    if torch.compiler.is_exporting():
        return upfirdn2d_op(x, _as_filter(f, x.device), list(_parse_scaling(up)),
                            list(_parse_scaling(down)),
                            list(_parse_padding(padding)), bool(flip_filter),
                            float(gain))
    if takes_plain(x):
        return upfirdn2d_ref(x, f, up, down, padding, flip_filter, gain)
    return _Upfirdn2dCuda.apply(
        x.contiguous(), _as_filter(f, x.device).contiguous(),
        _parse_scaling(up), _parse_scaling(down), _parse_padding(padding),
        bool(flip_filter), float(gain))


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


def upsample2d_ref(x: torch.Tensor, f, up: IntOrPair = 2,
                   padding: IntOrPair = 0, flip_filter: bool = False,
                   gain: float = 1.0) -> torch.Tensor:
    """``upsample2d`` through the plain version, on any device."""
    return upsample2d(x, f, up, padding, flip_filter, gain, op=upfirdn2d_ref)


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
