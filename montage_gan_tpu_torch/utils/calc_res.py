"""Resolution algebra for non-square / non-power-of-two image layers.

Port of ``montage_gan_tpu/utils/calc_res.py`` (pure Python).  A layer of
size (h, w) is generated by a synthesis pyramid that starts at
``init_res = (h, w) * 2**(conv_config_index - log2(resolution))`` and doubles
``log2(resolution) - conv_config_index`` times; ``resolution`` is the
power-of-two nominal resolution assigned to the shape.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple


def calc_res(shape: Sequence[int]) -> int:
    """Nominal power-of-two resolution for a (h, w) shape."""
    base0 = 2 ** int(math.log2(shape[0]))
    base1 = 2 ** int(math.log2(shape[1]))
    base = min(base0, base1)
    min_res = min(shape[0], shape[1])

    def divisible_at(xs, b):
        # every extent must be a multiple of b / 4
        scale = 2 ** (2 - int(math.log2(b)))
        return all((x * scale) % 1 == 0 for x in xs)

    if min_res != base or max(*shape) / min(*shape) >= 2:
        if math.log2(base) < 10 and divisible_at(shape, base * 2):
            base = base * 2
    return base


def calc_init_res(shape: Sequence[int], resolution: Optional[int] = None,
                  conv_config_index: int = 2) -> Tuple[List[int], int, int]:
    """Return (init_res [h, w], resolution, res_log2) for a layer shape."""
    shape = list(shape)
    if len(shape) == 1:
        shape = [shape[0], shape[0], 1]
    elif len(shape) == 2:
        shape = [*shape, 1]
    # fewer colors than pixels → channel dim is last
    size = shape[:2] if shape[2] < min(*shape[:2]) else shape[1:]
    if resolution is None:
        resolution = calc_res(size)
    res_log2 = int(math.log2(resolution))
    init_res = [int(s * 2 ** (conv_config_index - res_log2)) for s in size]
    return init_res, resolution, res_log2
