"""2-D convolution with optional FIR up/downsampling.

Port of ``montage_gan_tpu/ops/conv2d_resample.py`` with its defaults: the
resample FIR is folded into the conv kernel (``_fold_weight_fir``) on the
down path and on the up path, and the up path is the dilated form.

Activations are NHWC at the interface; weights are in the PyTorch layout
``[C_out, C_in // groups, kh, kw]`` that the port's modules store.  Convs run
as ``F.conv2d`` on channels-last NCHW views, so no layout copy is made.

The JAX up path is one conv with ``lhs_dilation=(up, up)`` and padding
``((py0, py1 + up - 1), (px0, px1 + up - 1))``.  Here that is an explicit
zero-insert (``H*up`` rows, the trailing ``up - 1`` zeros included) with the
padding applied in the same buffer, followed by an unpadded ``F.conv2d`` —
exactly the same sums.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .precision import lower
from .upfirdn2d import (_filter_size, _parse_padding, upfirdn2d,
                        zero_insert_pad)


def _fold_weight_fir(w: torch.Tensor, f: torch.Tensor, flip_weight: bool,
                     flip_filter: bool, gain: float = 1.0) -> torch.Tensor:
    """Compose the depthwise FIR ``f`` into the dense kernel ``w`` (exact).

    Returns the correlation-form kernel ``[C_out, C_in, kh+fh-1, kw+fw-1]``
    equal to the full convolution of ``w`` (in correlation orientation) with
    ``f`` (in convolution orientation), computed in float32
    (``montage_gan_tpu/ops/conv2d_resample.py:68-97``)."""
    if not flip_weight:
        w = w.flip([2, 3])
    f2 = f.to(device=w.device, dtype=torch.float32)
    if f2.ndim == 1:
        f2 = torch.outer(f2, f2)
    if not flip_filter:
        f2 = f2.flip([0, 1])
    fh, fw = f2.shape
    co, ci, kh, kw = w.shape
    wr = w.float().reshape(co * ci, 1, kh, kw)
    ker = (f2.flip([0, 1]) * gain)[None, None]
    out = F.conv2d(wr, ker, padding=(fh - 1, fw - 1))
    return out.reshape(co, ci, kh + fh - 1, kw + fw - 1).to(w.dtype)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          padding=(0, 0, 0, 0), groups: int = 1, flip_weight: bool = True,
          up: int = 1) -> torch.Tensor:
    """Dense conv of NHWC ``x`` (optionally zero-inserted ×``up`` first),
    padding ``(px0, px1, py0, py1)``; flip_weight=True → correlation."""
    if not flip_weight:
        w = w.flip([2, 3])
    px0, px1, py0, py1 = padding
    if up == 1 and px0 == px1 >= 0 and py0 == py1 >= 0:
        xp, conv_pad = x.permute(0, 3, 1, 2), (py0, px0)
    else:
        xp, conv_pad = zero_insert_pad(x, (up, up), padding), (0, 0)
    y = F.conv2d(lower(xp), lower(w.to(x.dtype)), stride=stride,
                 padding=conv_pad, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


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
            wf = _fold_weight_fir(w, f, flip_weight, flip_filter)
            return _conv(x, wf, stride=down, padding=(px0, px1, py0, py1),
                         groups=groups)
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1],
                      flip_filter=flip_filter)
        return _conv(x, w, stride=down, groups=groups, flip_weight=flip_weight)

    # Upsampling: zero-insert + one conv with the FIR folded in (gain up²).
    if up > 1:
        if down == 1 and f is not None:
            wf = _fold_weight_fir(w, f, flip_weight, flip_filter,
                                  gain=float(up ** 2))
            return _conv(x, wf, up=up, padding=(px0, px1, py0, py1),
                         groups=groups)
        x = _conv(x, w, groups=groups, flip_weight=flip_weight, up=up,
                  padding=(kw - 1, kw - 1, kh - 1, kh - 1))
        x = upfirdn2d(x, f, padding=[px0 - (kw - 1), px1 - (kw - 1),
                                     py0 - (kh - 1), py1 - (kh - 1)],
                      gain=up ** 2, flip_filter=flip_filter)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    # Plain convolution (asymmetric / negative padding through the pad step).
    return _conv(x, w, padding=(px0, px1, py0, py1), groups=groups,
                 flip_weight=flip_weight)
