"""The bytes a launch of a hand-written kernel has to move, worked out by
the benchmark from the arguments the launch is given (the sizes and dtypes
of ``csrc/``'s C entry points): each tensor the kernel needs read once,
each output written once.  The port's own counters (``CudaKernel.bytes``)
serve only as a cross-check, so that what a wrapper counts cannot move a
roofline.

``Recorder`` keeps each launch's arguments while the profiled steps run;
``bytes_of`` turns them into bytes afterwards.  An entry point whose
arguments no longer have the form below is not counted: the family's bytes
are ``None`` and the roofline that reads them is left out."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

F32 = 4
ITEMSIZE = {0: 4, 1: 2}         # csrc's dtype codes: float32, bfloat16
ACT_LINEAR, ACT_SWISH = 0, 8    # csrc/bias_act.cu's activation codes


def _bias_act(a) -> int:
    # x, b, y, n, C, dtype, act, alpha, gain, clamp, variant, grid, stream
    _, b, _, n, c, dtype = a[:6]
    return (2 * n + (c if b else 0)) * ITEMSIZE[dtype]


def _bias_act_grad(a) -> int:
    # g, x, b, y, dy, out, n, C, dtype, act, order, alpha, gain, clamp,
    # stream: g and out always; x and b for swish, y for the other
    # activations and the clamp mask, dy for order 2
    n, c, dtype, act, order, clamp = a[6], a[7], a[8], a[9], a[10], a[13]
    reads_x = act == ACT_SWISH
    reads_y = act not in (ACT_LINEAR, ACT_SWISH) or clamp >= 0
    elems = n * (2 + reads_x + reads_y + (order == 2))
    return (elems + (c if reads_x and a[2] else 0)) * ITEMSIZE[dtype]


def _upfirdn2d(a) -> int:
    # x, y, f, dtype, n, h, w, c, out_h, out_w, upx, upy, downx, downy,
    # padx0, pady0, fh, fw, separable, flip, gain, variant, smem, stream
    dtype, n, h, w, c, out_h, out_w = a[3:10]
    fh, fw, separable = a[16], a[17], a[18]
    taps = fh if separable else fh * fw
    return n * c * (h * w + out_h * out_w) * ITEMSIZE[dtype] + taps * F32


def _warp(a) -> int:
    # src, theta, taps, dst, n, h, w, c, out_h, out_w, taps, up, variant,
    # tile_h, tile_w, smem, counter, stream: float32 throughout; the
    # forward reads [n, h, w, c] and writes [n, out_h, out_w, c], the
    # transpose the other way round
    n, h, w, c, out_h, out_w, taps = a[4:11]
    return (n * c * (h * w + out_h * out_w) + n * 6 + taps) * F32


def _composite(a) -> int:
    # layers, translations, out, b, l, h, w, pad, variant, rows, stream
    b, l, h, w = a[3:7]
    return (b * l * h * w * 4 + b * l * 2 + b * h * w * 4) * F32


# symbol → (the number of arguments, the bytes of one launch)
ENTRY_POINTS: Dict[str, Tuple[int, Callable[[Sequence], int]]] = {
    'mgt_bias_act': (13, _bias_act),
    'mgt_bias_act_grad': (15, _bias_act_grad),
    'mgt_upfirdn2d': (24, _upfirdn2d),
    'mgt_warp_forward': (18, _warp),
    'mgt_warp_transpose': (18, _warp),
    'mgt_translate_composite': (11, _composite),
}


def bytes_of(symbol: str, launches: List[tuple]) -> Optional[int]:
    """The bytes of ``launches`` of ``symbol``; None where an entry point
    is unknown or a launch's arguments do not have its form."""
    if symbol not in ENTRY_POINTS:
        return None
    arity, fn = ENTRY_POINTS[symbol]
    total = 0
    for args in launches:
        if len(args) != arity:
            return None
        try:
            total += fn(args)
        except (KeyError, TypeError):
            return None
    return total


class Recorder:
    """Keeps the arguments of every launch of the given ``CudaKernel``s
    while it is entered (their ``launch`` is wrapped on the instance, and
    restored on exit)."""

    def __init__(self, kernels: Sequence[Tuple[str, object]]):
        self.kernels = list(kernels)
        self.args: Dict[str, List[tuple]] = {f: [] for f, _ in self.kernels}

    def __enter__(self):
        for fam, k in self.kernels:
            launch, sink = k.launch, self.args[fam]

            def recording(*args, _launch=launch, _sink=sink, **kw):
                _sink.append(args)
                return _launch(*args, **kw)
            k.launch = recording
        return self

    def __exit__(self, *exc):
        for _, k in self.kernels:
            del k.launch
        return False

    def bytes(self) -> Dict[str, Optional[int]]:
        """Bytes by family, by the entry points' forms above."""
        return {fam: bytes_of(k.symbol, self.args[fam])
                for fam, k in self.kernels}
