"""Fused bias + activation + gain + clamp.

Port of ``montage_gan_tpu/ops/bias_act.py``:
``y = clamp(gain * act(x + b), -clamp, clamp)`` with the per-activation
default gain/alpha registry.

Two paths, chosen by the device of ``x``:
  * a CPU tensor takes the plain PyTorch version (``bias_act_ref``), which
    rounds to ``x.dtype`` after each step as the JAX version does;
  * a CUDA tensor launches kernel K1' (``csrc/bias_act.cu``), which computes
    in float32 registers and rounds once.  It is forward-only: on a CUDA
    tensor that requires grad the wrapper raises (the autograd Function comes
    with the training port).
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F

from .cuda import CudaKernel, stream_handle

# Activation registry (montage_gan_tpu/ops/bias_act.py:31-50); `code` is the
# activation's number in csrc/bias_act.cu.
activation_funcs = {
    'linear':   SimpleNamespace(func=lambda x, **_: x, def_alpha=0.0,
                                def_gain=1.0, code=0),
    'relu':     SimpleNamespace(func=lambda x, **_: torch.relu(x),
                                def_alpha=0.0, def_gain=math.sqrt(2), code=1),
    'lrelu':    SimpleNamespace(func=lambda x, alpha, **_: F.leaky_relu(x, alpha),
                                def_alpha=0.2, def_gain=math.sqrt(2), code=2),
    'tanh':     SimpleNamespace(func=lambda x, **_: torch.tanh(x),
                                def_alpha=0.0, def_gain=1.0, code=3),
    'sigmoid':  SimpleNamespace(func=lambda x, **_: torch.sigmoid(x),
                                def_alpha=0.0, def_gain=1.0, code=4),
    'elu':      SimpleNamespace(func=lambda x, **_: F.elu(x),
                                def_alpha=0.0, def_gain=1.0, code=5),
    'selu':     SimpleNamespace(func=lambda x, **_: F.selu(x),
                                def_alpha=0.0, def_gain=1.0, code=6),
    'softplus': SimpleNamespace(func=lambda x, **_: F.softplus(x),
                                def_alpha=0.0, def_gain=1.0, code=7),
    'swish':    SimpleNamespace(func=lambda x, **_: torch.sigmoid(x) * x,
                                def_alpha=0.0, def_gain=math.sqrt(2), code=8),
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

kernel = CudaKernel('bias_act', 'mgt_bias_act', [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_void_p])


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


def bias_act_cuda(x: torch.Tensor, b: Optional[torch.Tensor] = None,
                  dim: int = -1, act: str = 'linear',
                  alpha: Optional[float] = None, gain: Optional[float] = None,
                  clamp: Optional[float] = None) -> torch.Tensor:
    """Kernel K1' on a CUDA tensor; raises on what the kernel does not take."""
    spec, alpha, gain = _resolve(act, alpha, gain, clamp)
    if x.device.type != 'cuda':
        raise ValueError(f'bias_act_cuda needs a CUDA tensor, got {x.device}')
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f'bias_act kernel takes float32 or bfloat16, got {x.dtype}')
    if not x.is_contiguous():
        raise ValueError('bias_act kernel needs a contiguous x')
    if torch.is_grad_enabled() and (x.requires_grad or (
            b is not None and b.requires_grad)):
        raise RuntimeError('bias_act kernel is forward-only; its autograd '
                           'Function comes with the training port')
    channels = 1
    if b is not None:
        if b.ndim != 1 or dim % x.ndim != x.ndim - 1 or \
                b.shape[0] != x.shape[-1]:
            raise ValueError('bias_act kernel takes a [C] bias along the last '
                             f'dim; got bias {tuple(b.shape)}, x {tuple(x.shape)}, dim {dim}')
        if b.device != x.device:
            raise ValueError(f'bias on {b.device}, x on {x.device}')
        b = b.to(x.dtype).contiguous()
        channels = b.shape[0]
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    kernel.launch(x.data_ptr(), b.data_ptr() if b is not None else None,
                  y.data_ptr(), x.numel(), channels, _DTYPE_CODES[x.dtype],
                  spec.code, alpha, gain,
                  -1.0 if clamp is None else float(clamp),
                  stream_handle(x.device))
    return y


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None,
             dim: int = -1, act: str = 'linear', alpha: Optional[float] = None,
             gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    """Add bias along ``dim``, apply ``act``, scale by ``gain``, clamp to
    ±clamp.  ``dim`` defaults to -1 (channels-last)."""
    if x.device.type == 'cpu':
        return bias_act_ref(x, b, dim, act, alpha, gain, clamp)
    return bias_act_cuda(x, b, dim, act, alpha, gain, clamp)
