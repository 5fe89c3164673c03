"""FIR filter preparation for the resampling ops.

Port of ``montage_gan_tpu/ops/filters.py``: accepts a 2-D filter, a 1-D tap
list, a scalar impulse, or None (identity); normalizes to unit DC gain;
optionally flips; scales by ``gain ** (ndim / 2)``.  A 1-D filter stays
separable only with 8 or more taps; shorter ones become their 2-D outer
product (so ``[1, 3, 3, 1]`` gives a ``[4, 4]`` filter).  Returns a float32
tensor on ``device`` (modules register it as a buffer).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def setup_filter(f, normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1.0, separable: Optional[bool] = None,
                 device=None) -> torch.Tensor:
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (0, 1, 2)
    assert f.size > 0
    if f.ndim == 0:
        f = f[np.newaxis]

    if separable is None:
        separable = (f.ndim == 1 and f.size >= 8)
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    assert f.ndim == (1 if separable else 2)

    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[::-1] if f.ndim == 1 else f[::-1, ::-1]
    f = f * (gain ** (f.ndim / 2))
    return torch.tensor(np.ascontiguousarray(f, dtype=np.float32),
                        device=device)
