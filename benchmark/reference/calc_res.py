"""Resolution algebra for non-square / non-power-of-two image layers.

Port of ``montage_gan_tpu/utils/calc_res.py`` (pure Python).  A layer of
size (h, w) is generated by a synthesis pyramid that starts at
``init_res = (h, w) * 2**(conv_config_index - log2(resolution))`` and doubles
``log2(resolution) - conv_config_index`` times; ``resolution`` is the
power-of-two nominal resolution assigned to the shape.
"""

from __future__ import annotations

import math
from itertools import product
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


def calc_res_combination(conv_config_index: int = 2,
                         range_res: Tuple[int, int] = (32, 257),
                         index_range: Tuple[int, int] = (5, 9)
                         ) -> List[Tuple[int, int]]:
    """All (h, w) pairs the synthesis pyramid can produce exactly."""
    acceptable: List[int] = []
    for i in range(*range_res):
        for j in range(*index_range):
            if i % (2 ** j) == 0 and i not in acceptable:
                acceptable.append(i)
                break

    combos: List[Tuple[int, int]] = []
    for pair in product(acceptable, acceptable):
        init_res, _, res_log2 = calc_init_res(
            pair, conv_config_index=conv_config_index)
        factor = 2 ** (res_log2 - conv_config_index)
        if init_res[0] * factor == pair[0] and init_res[1] * factor == pair[1]:
            combos.append(pair)
    return combos


def find_min_res_combination(shape: Sequence[int],
                             res_combination: Optional[
                                 List[Tuple[int, int]]] = None,
                             conv_config_index: int = 2
                             ) -> Optional[Tuple[int, int]]:
    """Smallest acceptable (h, w) that covers ``shape``."""
    if res_combination is None:
        res_combination = calc_res_combination(conv_config_index)
    for r1, r2 in res_combination:
        if r1 < shape[0] or r2 < shape[1]:
            continue
        return r1, r2
    return None
