"""2-D convolution with optional FIR up/downsampling.

Port of ``montage_gan_tpu/ops/conv2d_resample.py`` with its defaults: the
resample FIR is folded into the conv kernel (``_fold_weight_fir``) on the
down path and on the up path.

Activations are NHWC at the interface; weights are in the PyTorch layout
``[C_out, C_in // groups, kh, kw]`` that the port's modules store.  Convs run
as ``F.conv2d`` on channels-last NCHW views, so no layout copy is made.

The JAX up path is one conv with ``lhs_dilation=(up, up)`` over the
zero-inserted input, which XLA runs without the inserted zeros on the TPU;
cuDNN would multiply them (a dense 6×6 conv for the synthesis layers' 3×3
kernel and 4×4 FIR).  Here the folded kernel is cut into its ``up²`` output
phases (``_phase_kernel``): output pixel ``(up·m + ry, up·n + rx)`` reads the
taps of phase ``(ry, rx)`` around input pixel ``(m, n)``, so one stride-1
conv over the ``H × W`` input with ``up² · C_out`` channels, then a pixel
shuffle, gives the same sums from the same (folded, cast) weights, a quarter
of the multiply-adds of the dense conv.  A stride-``up`` transposed conv
of the unfolded kernel, then the FIR through K2', would do a quarter of
these multiply-adds, but it rounds the conv's output to bfloat16 before the
FIR, where the JAX package rounds once, and K2''s generic variant over
those maps takes longer than the conv it saves (PERF.md §6).

``LOWERINGS`` counts the calls by the route they take (``up_phases``,
``down_folded``, ``down_fir``: down without a filter, ``plain``); ``reset()``
clears it.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from .upfirdn2d import (_as_filter, _filter_size, _parse_padding, upfirdn2d,
                        zero_insert_pad)

LOWERINGS: collections.Counter = collections.Counter()


def reset():
    """Clear ``LOWERINGS``."""
    LOWERINGS.clear()


def _fold_weight_fir(w: torch.Tensor, f: torch.Tensor, flip_weight: bool,
                     flip_filter: bool, gain: float = 1.0) -> torch.Tensor:
    """Compose the depthwise FIR ``f`` into the dense kernel ``w`` (exact).

    Returns the correlation-form kernel ``[C_out, C_in, kh+fh-1, kw+fw-1]``
    equal to the full convolution of ``w`` (in correlation orientation) with
    ``f`` (in convolution orientation), computed in float32, or float64
    for a float64 ``w`` (``montage_gan_tpu/ops/conv2d_resample.py:68-97``)."""
    if not flip_weight:
        w = w.flip([2, 3])
    dtype = torch.promote_types(w.dtype, torch.float32)
    f2 = f.to(device=w.device, dtype=dtype)
    if f2.ndim == 1:
        f2 = torch.outer(f2, f2)
    if not flip_filter:
        f2 = f2.flip([0, 1])
    fh, fw = f2.shape
    co, ci, kh, kw = w.shape
    wr = w.to(dtype).reshape(co * ci, 1, kh, kw)
    ker = (f2.flip([0, 1]) * gain)[None, None]
    out = F.conv2d(wr, ker, padding=(fh - 1, fw - 1))
    return out.reshape(co, ci, kh + fh - 1, kw + fw - 1).to(w.dtype)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          padding=(0, 0, 0, 0), groups: int = 1,
          flip_weight: bool = True) -> torch.Tensor:
    """Dense conv of NHWC ``x``, padding ``(px0, px1, py0, py1)`` (negative
    crops); flip_weight=True → correlation."""
    if not flip_weight:
        w = w.flip([2, 3])
    px0, px1, py0, py1 = padding
    if px0 == px1 >= 0 and py0 == py1 >= 0:
        xp, conv_pad = x.permute(0, 3, 1, 2), (py0, px0)
    else:
        xp, conv_pad = zero_insert_pad(x, (1, 1), padding), (0, 0)
    y = F.conv2d(xp, w.to(x.dtype), stride=stride, padding=conv_pad,
                 groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def _phases(k: int, pad0: int, up: int
            ) -> Tuple[int, int, List[Tuple[int, int, int]]]:
    """One axis of the up path's phases.  The folded kernel (``k`` taps)
    correlates the zero-inserted input padded by ``pad0``, where input
    sample ``i`` sits at ``pad0 + up·i``; output ``up·m + r`` then reads
    taps ``first, first + up, ...`` (``pad0 - r = up·q + first``) at input
    samples ``m - q, m - q + 1, ...``.  Returns the offset ``lo`` of the
    window all phases read (input samples ``m + lo ... m + lo + width -
    1``), its ``width``, and per phase its first tap and the window's zero
    taps before and after its own."""
    taps = []
    for r in range(up):
        q, first = divmod(pad0 - r, up)
        taps.append((first, -q, (k - first + up - 1) // up))
    lo = min(start for _, start, _ in taps)
    width = max(start + n for _, start, n in taps) - lo
    return lo, width, [(first, start - lo, width - (start - lo) - n)
                       for first, start, n in taps]


def _phase_kernel(wf: torch.Tensor, up: int, ys, xs) -> torch.Tensor:
    """The folded correlation kernel ``wf`` ``[C_out, C_in, K, K]`` as
    ``[up·up·C_out, C_in, th, tw]``: phase ``(ry, rx)``'s taps in the common
    window, phases outermost."""
    kernels = []
    for fy, by, ay in ys:
        for fx, bx, ax in xs:
            k = wf[:, :, fy::up, fx::up]
            if by or ay or bx or ax:
                k = F.pad(k, (bx, ax, by, ay))
            kernels.append(k)
    return torch.cat(kernels)


def _up_phases(x: torch.Tensor, wf: torch.Tensor, up: int,
               padding: Tuple[int, int, int, int]) -> torch.Tensor:
    """Correlate the zero-inserted NHWC ``x`` (×``up``, padded by
    ``(px0, px1, py0, py1)``) with ``wf`` as one conv over ``x`` and a
    pixel shuffle of its ``up²`` phases."""
    n, h, w = x.shape[:3]
    co, kh, kw = wf.shape[0], wf.shape[2], wf.shape[3]
    px0, px1, py0, py1 = padding
    oh = py0 + up * h + py1 - kh + 1
    ow = px0 + up * w + px1 - kw + 1
    mh, mw = -(-oh // up), -(-ow // up)
    loy, th, ys = _phases(kh, py0, up)
    lox, tw, xs = _phases(kw, px0, up)
    y = _conv(x, _phase_kernel(wf, up, ys, xs),
              padding=(-lox, mw + tw - 1 - w + lox,
                       -loy, mh + th - 1 - h + loy))
    y = y.reshape(n, mh, mw, up, up, co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, mh * up, mw * up, co)[:, :oh, :ow]


def conv2d_resample(x: torch.Tensor, w: torch.Tensor,
                    f: Optional[torch.Tensor] = None, up: int = 1,
                    down: int = 1, padding=0, groups: int = 1,
                    flip_weight: bool = True,
                    flip_filter: bool = False) -> torch.Tensor:
    """Convolve NHWC ``x`` with ``w`` ``[C_out, C_in // groups, kh, kw]``,
    resampling with FIR filter ``f``.

    Args:
        x: ``[N, H, W, C_in]``.
        f: FIR filter from ``setup_filter`` or None.
        up / down: integer resampling factors.
        padding: int, ``[x, y]`` or ``[x0, x1, y0, y1]`` w.r.t. the upsampled
            image; negative crops.
        flip_weight: False = convolution, True = correlation.
    """
    assert x.ndim == 4 and w.ndim == 4
    kh, kw = int(w.shape[2]), int(w.shape[3])
    fh, fw = _filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)

    # Padding adjustments for the FIR stages.
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    # Downsampling: the FIR folded into one strided conv.
    if down > 1 and up == 1:
        if f is not None:
            LOWERINGS['down_folded'] += 1
            wf = _fold_weight_fir(w, f, flip_weight, flip_filter)
            return _conv(x, wf, stride=down, padding=(px0, px1, py0, py1),
                         groups=groups)
        LOWERINGS['down_fir'] += 1
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1],
                      flip_filter=flip_filter)
        return _conv(x, w, stride=down, groups=groups, flip_weight=flip_weight)

    # Upsampling: the FIR folded in (gain up²), run as the kernel's phases.
    if up > 1:
        assert groups == 1, 'the up path takes groups == 1'
        LOWERINGS['up_phases'] += 1
        wf = _fold_weight_fir(w, _as_filter(f, w.device), flip_weight,
                              flip_filter, gain=float(up ** 2))
        x = _up_phases(x, wf, up, (px0, px1, py0, py1))
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    # Plain convolution (asymmetric / negative padding through the pad step).
    LOWERINGS['plain'] += 1
    return _conv(x, w, padding=(px0, px1, py0, py1), groups=groups,
                 flip_weight=flip_weight)
