"""Alpha compositing of RGBA layer stacks.

Port of ``montage_gan_tpu/ops/composite.py``: the straight-alpha A-over-B
recurrence (layer l over the canvas of layers < l) in closed form, with an
exclusive reverse cumulative product of transmittances —

    A_out           = 1 - Π_l (1 - a_l)
    C_out · A_out   = Σ_l c_l · a_l · Π_{k>l} (1 - a_k)

and 0/0 colour divisions resolving to 0.

``translate_and_composite_fused`` is the port of the TPU composite kernel
(``ops/pallas/composite_kernel.py``, forward only, shifts clamped to ±1):
a CPU tensor takes its plain version, ``translate_and_composite`` of the
clamped shifts; a CUDA tensor launches kernel K5' (``csrc/composite.cu``),
which runs the recurrence itself, layer by layer, on a premultiplied canvas
in registers.

K5' has two variants, chosen from the parameters alone (``composite_plan``)
and counted on ``kernel.variants``: ``tiled`` (a 16-byte aligned layer
tensor: each block stages its tile's source window per layer by bulk copy,
in a ring over the layers) and ``direct`` (the same tiles, taps read from
device memory).  ``axis_taps`` and ``tile_window`` give the tiles' tap
tables and windows as the kernel computes them (the CPU tests hold them),
``needed_bytes`` the bytes a launch must move.  The wrapper records on
``kernel.bytes`` every byte of its tensors, an upper count that needs no
copy of the shifts to the host.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .cuda import (CudaKernel, launch_device, stream_handle, takes_plain,
                   tensor_bytes)
from .grid_sample import translate_sample

kernel = CudaKernel('composite', 'mgt_translate_composite',
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                    + [ctypes.c_float] + [ctypes.c_int] * 2
                    + [ctypes.c_void_p])

# csrc/composite.cu's variant codes and constants: a tile is ROWS (or, on a
# launch of fewer ROWS-row tiles than the card has SMs, SMALL_ROWS) rows by
# min(TILE_W, W) columns, staged through a ring of STAGES layers.
VARIANT_CODES = {'direct': 0, 'tiled': 1}
ROWS = 8
SMALL_ROWS = 4
TILE_W = 256
STAGES = 2


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den with 0/0 → 0."""
    den_safe = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den == 0, torch.zeros_like(num), num / den_safe)


def alpha_composite(layers: torch.Tensor, layer_axis: int = 1) -> torch.Tensor:
    """Straight-alpha composite over the layer axis of ``[..., L, H, W, 4]``
    RGBA in [0, 1] (higher ``l`` on top); returns the layer axis removed."""
    layers = torch.movedim(layers, layer_axis, 0)               # [L, ..., 4]
    color = layers[..., :3]
    alpha = layers[..., 3:4]

    # transmittance above layer l: T_l = Π_{k>l} (1 - a_k) (exclusive, reversed)
    one_minus = 1.0 - alpha
    rev = torch.flip(one_minus, [0])
    t_above = torch.flip(
        torch.cat([torch.ones_like(rev[:1]), torch.cumprod(rev, 0)[:-1]], 0),
        [0])

    weight = alpha * t_above
    alpha_out = 1.0 - torch.prod(one_minus, 0)
    color_out = _safe_div(torch.sum(color * weight, 0), alpha_out)
    return torch.cat([color_out, alpha_out], -1)


def translate_and_composite(layers: torch.Tensor, translations: torch.Tensor,
                            pad_value: float = 0.0,
                            input_range: str = 'zero1') -> torch.Tensor:
    """Per-layer translation + alpha composite of ``[B, L, H, W, 4]`` by
    ``[B, L, 2]`` normalized (dx, dy), differentiable; the shifts are not
    clamped."""
    b, l, h, w, c = layers.shape
    moved = translate_sample(layers.reshape(b * l, h, w, c),
                             translations.reshape(b * l, 2),
                             pad_value=pad_value).reshape(b, l, h, w, c)
    if input_range == 'minus11':
        return alpha_composite((moved + 1.0) * 0.5) * 2.0 - 1.0
    return alpha_composite(moved)


def translate_and_composite_ref(layers: torch.Tensor,
                                translations: torch.Tensor,
                                pad_value: float = 0.0) -> torch.Tensor:
    """The plain version of K5': the shifts clamped to ±1, then
    ``translate_and_composite`` of ``[0, 1]`` RGBA."""
    return translate_and_composite(layers, translations.clamp(-1.0, 1.0),
                                   pad_value, 'zero1')


# ---------------------------------------------------------------------------
# The plan of a launch and each tile's tables and windows (csrc/composite.cu's
# twins)
# ---------------------------------------------------------------------------

def capacity(rows: int, tile_w: int) -> int:
    """composite_capacity: image pixels a stage holds, the largest window
    of a ``rows`` × ``tile_w`` tile."""
    return (rows + 2) * (tile_w + 2)


def stage_bytes(rows: int, tile_w: int, tiled: bool) -> int:
    """composite_stage_bytes: a stage's shared memory (window, column and
    row tables, window header, mbarrier)."""
    return ((16 * capacity(rows, tile_w) if tiled else 0) + 8 * tile_w
            + 8 * rows + 24 + 8)


@dataclass(frozen=True)
class CompositePlan:
    """One launch of K5': its variant, tile (``rows`` × ``tile_w``), grid
    (tiles along x, along y, samples), threads per block and dynamic shared
    memory."""
    variant: str
    rows: int
    tile_w: int
    grid: Tuple[int, int, int]
    threads: int
    smem_bytes: int
    hw: Tuple[int, int]

    def tile_box(self, ty: int, tx: int) -> Tuple[int, int, int, int]:
        """Output rows ``[y0, y1)`` and columns ``[x0, x1)`` of tile (ty,
        tx)."""
        h, w = self.hw
        y0, x0 = ty * self.rows, tx * self.tile_w
        return y0, min(y0 + self.rows, h), x0, min(x0 + self.tile_w, w)

    def tiles(self):
        for ty in range(self.grid[1]):
            for tx in range(self.grid[0]):
                yield ty, tx


@functools.lru_cache(maxsize=256)
def composite_plan(b: int, h: int, w: int, sms: int,
                   aligned: bool = True) -> CompositePlan:
    """The launch of K5' on ``b`` samples of ``h`` × ``w`` on a card of
    ``sms`` SMs: ``tiled`` for a 16-byte aligned layer tensor, else
    ``direct``.  A tile is ROWS × min(TILE_W, ``w``), or SMALL_ROWS rows
    where ROWS-row tiles would be fewer than the SMs (such a launch is bound
    by latency, not bytes, and more blocks shorten it)."""
    tw = min(TILE_W, w)
    rows = SMALL_ROWS if -(-w // tw) * -(-h // ROWS) * b < sms else ROWS
    grid = (-(-w // tw), -(-h // rows), b)
    if grid[1] > 65535 or b > 65535:
        raise ValueError(f'K5\' grid {grid} exceeds the launch limits')
    return CompositePlan(variant='tiled' if aligned else 'direct', rows=rows,
                         tile_w=tw, grid=grid, threads=-(-tw // 32) * 32,
                         smem_bytes=STAGES * stage_bytes(rows, tw, aligned),
                         hw=(h, w))


@functools.lru_cache(maxsize=16)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


_F32 = np.float32


def clamp_shift(t) -> np.ndarray:
    """mgt_shift: a shift clamped to [-1, 1], float32 (NaN gives -1)."""
    t = np.asarray(t, _F32)
    return np.where(np.isnan(t), _F32(-1), np.clip(t, _F32(-1), _F32(1)))


def axis_taps(n: int, t, index=None) -> Tuple[np.ndarray, np.ndarray]:
    """mgt_tap along an axis of extent ``n`` translated by the clamped
    shift ``t``: (i0, f) of output indices ``index`` (default all), each
    step rounded in float32 as the kernel and the plain version round."""
    i = np.arange(n) if index is None else np.asarray(index)
    t = _F32(t)
    g = ((_F32(2) * i.astype(_F32) + _F32(1)) / _F32(n) - _F32(1)) + t
    c = (g + _F32(1)) * _F32(0.5 * n) - _F32(0.5)
    c0 = np.floor(c)
    return c0.astype(np.int64), (c - c0).astype(_F32)


class Window(NamedTuple):
    """A layer's source window for one tile (csrc MgtWindow): image rows
    ``[y0, y0 + rows)`` by columns ``[x0, x0 + cols)``, ``rows`` 0 where no
    tap lies in the image; ``base``, the first row's iy0; ``regular``: row
    r's iy0 is ``base + r`` for every row of the tile; ``fits``: it fits a
    stage of the tiled variant (the kernel traps where one does not)."""
    y0: int
    x0: int
    rows: int
    cols: int
    base: int
    regular: bool
    fits: bool


def tile_window(plan: CompositePlan, shift, ty: int, tx: int) -> Window:
    """mgt_window and the row table's base and rule for tile (ty, tx) and
    a layer's (dx, dy) ``shift`` (clamped here)."""
    h, w = plan.hw
    y0, y1, x0, x1 = plan.tile_box(ty, tx)
    sx, sy = clamp_shift(shift)
    r = axis_taps(h, sy, np.arange(y0, y1))[0]
    c = axis_taps(w, sx, [x0, x1 - 1])[0]
    base = int(r[0])
    regular = bool((r == base + np.arange(y1 - y0)).all())
    r0, r1 = max(base, 0), min(int(r[-1]) + 1, h - 1)
    c0, c1 = max(int(c[0]), 0), min(int(c[1]) + 1, w - 1)
    if r1 < r0 or c1 < c0:
        return Window(0, 0, 0, 0, base, regular, True)
    rows, cols = r1 - r0 + 1, c1 - c0 + 1
    return Window(r0, c0, rows, cols, base, regular,
                  rows <= plan.rows + 2 and cols <= plan.tile_w + 2)


def needed_bytes(layers_shape, shifts) -> int:
    """Bytes that K5' must move for ``[B, L, H, W, 4]`` float32 layers and
    ``[B, L, 2]`` shifts: each image pixel some tap reads, once (the window
    of the whole image per layer), the shifts, and the output."""
    b, l, h, w, c = layers_shape
    s = clamp_shift(np.asarray(shifts, _F32).reshape(b * l, 2))
    total = 0
    for sx, sy in s:
        r = axis_taps(h, sy, [0, h - 1])[0]
        k = axis_taps(w, sx, [0, w - 1])[0]
        rows = min(int(r[1]) + 1, h - 1) - max(int(r[0]), 0) + 1
        cols = min(int(k[1]) + 1, w - 1) - max(int(k[0]), 0) + 1
        total += max(rows, 0) * max(cols, 0) * c * 4
    return total + b * l * 2 * 4 + b * h * w * c * 4


def translate_and_composite_cuda(layers: torch.Tensor,
                                 translations: torch.Tensor,
                                 pad_value: float = 0.0) -> torch.Tensor:
    """Kernel K5' (no autograd): ``[B, L, H, W, 4]`` float32 RGBA in
    [0, 1] and ``[B, L, 2]`` float32 shifts → ``[B, H, W, 4]``, by the
    variant and tile of ``composite_plan``."""
    for t, name in ((layers, 'layers'), (translations, 'translations')):
        if t.device.type != 'cuda':
            raise ValueError(f'composite kernel needs CUDA tensors, got {name}'
                             f' on {t.device}')
        if t.dtype != torch.float32:
            raise TypeError(f'composite kernel takes float32, got {name} '
                            f'{t.dtype}')
    if layers.ndim != 5 or layers.shape[-1] != 4:
        raise ValueError(f'layers {tuple(layers.shape)} is not [B, L, H, W, 4]')
    b, l, h, w, _ = layers.shape
    if tuple(translations.shape) != (b, l, 2):
        raise ValueError(f'translations {tuple(translations.shape)} is not '
                         f'[{b}, {l}, 2]')
    layers = layers.contiguous()
    translations = translations.contiguous()
    plan = composite_plan(b, h, w, sm_count(layers.device),
                          layers.data_ptr() % 16 == 0)
    out = torch.empty(b, h, w, 4, dtype=torch.float32, device=layers.device)
    kernel.launch(layers.data_ptr(), translations.data_ptr(), out.data_ptr(),
                  b, l, h, w, float(pad_value), VARIANT_CODES[plan.variant],
                  plan.rows, stream_handle(launch_device(layers)),
                  variant=plan.variant,
                  nbytes=tensor_bytes(layers, translations, out))
    return out


def translate_and_composite_fused(layers: torch.Tensor,
                                  translations: torch.Tensor,
                                  pad_value: float = 0.0) -> torch.Tensor:
    """Translate each layer of ``[B, L, H, W, 4]`` RGBA in [0, 1] by its
    ``[B, L, 2]`` normalized (dx, dy), clamped to ±1 (content from outside
    the image is ``pad_value``), and alpha-composite the layers: ``[B, H,
    W, 4]``.  Forward only, like the TPU kernel: a CUDA tensor that requires
    grad raises (``translate_and_composite`` is the differentiable op)."""
    if takes_plain(layers):
        return translate_and_composite_ref(layers, translations, pad_value)
    if layers.requires_grad or translations.requires_grad:
        raise RuntimeError('translate_and_composite_fused is forward only; '
                           'use translate_and_composite for gradients')
    return translate_and_composite_cuda(layers, translations, pad_value)
