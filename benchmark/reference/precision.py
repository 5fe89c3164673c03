"""The precision the reference computes in below float32: where the
configuration says bfloat16 (the blocks of the top ``num_fp16_res``
resolutions) the reference convolves in bfloat16, unless ``fp8_blocks`` is
on, which rounds each such convolution's input and weight through float8
(e4m3, one scale per tensor from its largest magnitude), the step below
bfloat16.  Only the control turns it on."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0       # the largest finite float8_e4m3fn
_state = {'fp8': False}


@contextlib.contextmanager
def fp8_blocks(on: bool = True):
    before = _state['fp8']
    _state['fp8'] = on
    try:
        yield
    finally:
        _state['fp8'] = before


def lower(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 when ``fp8_blocks`` is on and ``t`` is
    bfloat16; else ``t``.  The rounding passes the gradient straight."""
    if not _state['fp8'] or t.dtype != torch.bfloat16:
        return t
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    q = (t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q.to(t.dtype) - t).detach()
