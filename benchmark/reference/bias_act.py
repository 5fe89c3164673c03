"""Bias + activation + gain + clamp, the plain version only.

Frozen copy of the port's ``bias_act_ref`` and its activation table: every
step rounds to ``x.dtype``, and autograd differentiates it (to second order
where R1 and path length ask)."""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F


def _spec(func, def_alpha, def_gain):
    return SimpleNamespace(func=func, def_alpha=def_alpha, def_gain=def_gain)


activation_funcs = {
    'linear':   _spec(lambda x, **_: x, 0.0, 1.0),
    'relu':     _spec(lambda x, **_: torch.relu(x), 0.0, math.sqrt(2)),
    'lrelu':    _spec(lambda x, alpha, **_: F.leaky_relu(x, alpha), 0.2,
                      math.sqrt(2)),
    'tanh':     _spec(lambda x, **_: torch.tanh(x), 0.0, 1.0),
    'sigmoid':  _spec(lambda x, **_: torch.sigmoid(x), 0.0, 1.0),
    'elu':      _spec(lambda x, **_: F.elu(x), 0.0, 1.0),
    'selu':     _spec(lambda x, **_: F.selu(x), 0.0, 1.0),
    'softplus': _spec(lambda x, **_: F.softplus(x), 0.0, 1.0),
    'swish':    _spec(lambda x, **_: torch.sigmoid(x) * x, 0.0, math.sqrt(2)),
}


def _resolve(act, alpha, gain, clamp):
    assert clamp is None or clamp >= 0
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    return spec, alpha, gain


def bias_act_ref(x: torch.Tensor, b: Optional[torch.Tensor] = None,
                 dim: int = -1, act: str = 'linear',
                 alpha: Optional[float] = None, gain: Optional[float] = None,
                 clamp: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version, on any device (the JAX function step by
    step)."""
    spec, alpha, gain = _resolve(act, alpha, gain, clamp)
    if b is not None:
        assert b.ndim == 1
        axis = dim % x.ndim
        assert b.shape[0] == x.shape[axis]
        shape = [1] * x.ndim
        shape[axis] = -1
        x = x + b.to(x.dtype).reshape(shape)
    x = spec.func(x, alpha=alpha)
    if gain != 1:
        # the gain rounds to x.dtype first, as jnp.asarray(gain, x.dtype)
        x = x * torch.tensor(gain, dtype=x.dtype).item()
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x


bias_act = bias_act_ref
