"""Fused bias + activation + gain + clamp.

Port of ``montage_gan_tpu/ops/bias_act.py``:
``y = clamp(gain * act(x + b), -clamp, clamp)`` with the per-activation
default gain/alpha registry.

Two paths, chosen by the device of ``x``:
  * a CPU tensor takes the plain PyTorch version (``bias_act_ref``), which
    rounds to ``x.dtype`` after each step as the JAX version does, and is
    differentiated by autograd;
  * a CUDA tensor goes through the autograd Function ``_BiasActCuda``: its
    forward launches kernel K1' (``csrc/bias_act.cu``), which computes in
    float32 registers and rounds once; its backward launches the gradient
    kernel (``mgt_bias_act_grad``) through ``_BiasActCudaGrad``, whose own
    backward gives the second order (R1 and path length need it).  This is
    the reference's ``BiasActCuda`` / ``BiasActCudaGrad`` pair.  The bias
    gradient is the input gradient summed over the non-channel dims.

K1''s forward has two variants, chosen from the parameters alone by
``_stream_plan`` and counted apart on ``kernel.variants``: ``vector`` (one
16-byte vector per thread per step) for tensors that allow 16-byte
vectors, and ``scalar`` for unaligned views and rows that are not a whole
number of vectors.

For ``torch.export`` the forward and the gradient kernel are also operators
of ``torch.library`` (``mgt::bias_act``, ``mgt::bias_act_grad``): an
exported program keeps each as one graph node, whose CUDA face launches the
kernel (counted as above) and whose CPU face is the plain version.
``bias_act`` routes to the operator only while exporting; eager code
launches the kernel directly, without a dispatcher hop per launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F

from .cuda import (CudaKernel, launch_device, stream_handle, takes_plain,
                   tensor_bytes)

# Activation registry (montage_gan_tpu/ops/bias_act.py:31-50); `code` is the
# activation's number in csrc/bias_act.cu.  `ref` names the saved tensor the
# gradient kernel reads ('x': the input, 'y': the output, '': none), and
# `has_2nd_grad` whether act'' is non-zero, as in the reference plugin.
def _spec(func, def_alpha, def_gain, code, ref, has_2nd_grad):
    return SimpleNamespace(func=func, def_alpha=def_alpha, def_gain=def_gain,
                           code=code, ref=ref, has_2nd_grad=has_2nd_grad)


activation_funcs = {
    'linear':   _spec(lambda x, **_: x, 0.0, 1.0, 0, '', False),
    'relu':     _spec(lambda x, **_: torch.relu(x), 0.0, math.sqrt(2), 1,
                      'y', False),
    'lrelu':    _spec(lambda x, alpha, **_: F.leaky_relu(x, alpha), 0.2,
                      math.sqrt(2), 2, 'y', False),
    'tanh':     _spec(lambda x, **_: torch.tanh(x), 0.0, 1.0, 3, 'y', True),
    'sigmoid':  _spec(lambda x, **_: torch.sigmoid(x), 0.0, 1.0, 4, 'y',
                      True),
    'elu':      _spec(lambda x, **_: F.elu(x), 0.0, 1.0, 5, 'y', True),
    'selu':     _spec(lambda x, **_: F.selu(x), 0.0, 1.0, 6, 'y', True),
    'softplus': _spec(lambda x, **_: F.softplus(x), 0.0, 1.0, 7, 'y', True),
    'swish':    _spec(lambda x, **_: torch.sigmoid(x) * x, 0.0, math.sqrt(2),
                      8, 'x', True),
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

kernel = CudaKernel('bias_act', 'mgt_bias_act', [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# The gradient entry point of the same library, counted on its own.
grad_kernel = CudaKernel('bias_act', 'mgt_bias_act_grad', [
    ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 4
    + [ctypes.c_float] * 3 + [ctypes.c_void_p])


# The forward's variants (csrc/bias_act.cu MgtBiasActVariant), its threads
# per block (BIAS_ACT_THREADS) and the most blocks it launches (common.cuh
# mgt_grid's cap: 64 a block's worth of SMs on 132 SMs).
VARIANT_CODES = {'scalar': 0, 'vector': 1}
THREADS = 256
MAX_BLOCKS = 132 * 64


@dataclass(frozen=True)
class StreamPlan:
    """How K1''s forward covers ``n`` elements: the variant (``code`` as
    the kernel takes it), ``vec`` elements a thread takes per step (16
    bytes, or 1 element), a ``grid`` of ``THREADS``-thread blocks whose
    thread ``t`` takes vectors ``t, t + stride, ...`` (``stride`` threads
    in all), and the bytes the launch moves (x read, y written, the bias
    read)."""
    variant: str
    code: int
    vec: int
    grid: int
    moved: int

    @property
    def stride(self) -> int:
        return self.grid * THREADS


@functools.lru_cache(maxsize=1024)
def _stream_plan(n: int, C: int, itemsize: int, aligned: bool,
                 bias: bool = True) -> StreamPlan:
    """The variant and grid of K1' for ``n`` elements of ``itemsize``
    bytes with ``C`` channels, an input 16-byte ``aligned`` or not (the
    output is a fresh allocation)."""
    vec = 16 // itemsize
    variant = 'vector'
    if not (aligned and n % vec == 0 and (not bias or C % vec == 0)):
        variant, vec = 'scalar', 1
    grid = max(1, min(-(-(n // vec) // THREADS), MAX_BLOCKS))
    return StreamPlan(variant, VARIANT_CODES[variant], vec, grid,
                      (2 * n + bias * C) * itemsize)


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
    """Kernel K1' forward on a CUDA tensor (no autograd); raises on what the
    kernel does not take."""
    spec, alpha, gain = _resolve(act, alpha, gain, clamp)
    _check(x, 'x')
    b = _kernel_bias(x, b, dim)
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    C = 1 if b is None else b.shape[0]
    xp = x.data_ptr()
    plan = _stream_plan(n, C, x.element_size(), xp % 16 == 0, b is not None)
    kernel.launch(xp, _ptr(b), y.data_ptr(), n, C, _DTYPE_CODES[x.dtype],
                  spec.code, alpha, gain, _clamp_arg(clamp), plan.code,
                  plan.grid, stream_handle(launch_device(x)),
                  variant=plan.variant, nbytes=plan.moved)
    return y


def bias_act_grad_cuda(g: torch.Tensor, x: Optional[torch.Tensor],
                       b: Optional[torch.Tensor], y: Optional[torch.Tensor],
                       dy: Optional[torch.Tensor] = None, order: int = 1,
                       act: str = 'linear', alpha: Optional[float] = None,
                       gain: Optional[float] = None,
                       clamp: Optional[float] = None) -> torch.Tensor:
    """The gradient kernel on CUDA tensors (no autograd): order 1 gives
    ``g · gain · act'(x + b)`` masked where ``|y| ≥ clamp``; order 2 gives
    ``g · dy · gain · act''(x + b)`` under the same mask.  ``x`` (with ``b``)
    is read for swish, ``y`` for the other activations and the clamp."""
    spec, alpha, gain = _resolve(act, alpha, gain, clamp)
    _check(g, 'g')
    others = {'x': x, 'y': y, 'dy': dy}
    for name, t in others.items():
        if t is not None:
            _check(t, name)
            if t.shape != g.shape or t.dtype != g.dtype:
                raise ValueError(f'{name} {tuple(t.shape)} {t.dtype} does not '
                                 f'match g {tuple(g.shape)} {g.dtype}')
    b = _kernel_bias(g, b, -1)
    out = torch.empty_like(g)
    if g.numel() == 0:
        return out
    # what the kernel reads: x and b for swish, y for the other
    # activations and the clamp mask, dy for order 2
    reads_x = act == 'swish'
    reads_y = act not in ('linear', 'swish') or clamp is not None
    grad_kernel.launch(g.data_ptr(), _ptr(x), _ptr(b), _ptr(y), _ptr(dy),
                       out.data_ptr(), g.numel(),
                       1 if b is None else b.shape[0], _DTYPE_CODES[g.dtype],
                       spec.code, order, alpha, gain, _clamp_arg(clamp),
                       stream_handle(launch_device(g)),
                       nbytes=tensor_bytes(g, x if reads_x else None,
                                           b if reads_x else None,
                                           y if reads_y else None,
                                           dy if order == 2 else None, out))
    return out


def _act_deriv(act: str, order: int, yy, z, alpha: float):
    """``act'`` (order 1) or ``act''`` (order 2) as the gradient kernel reads
    them (``csrc/bias_act.cu::mgt_act_deriv``): from ``yy = y / gain``, or
    for swish from ``z = x + b``."""
    one = order == 1
    if act == 'linear':
        return 1.0 if one else 0.0
    if act == 'relu':
        return (yy > 0).float() if one else 0 * yy
    if act == 'lrelu':
        return torch.where(yy > 0, 1.0, alpha) if one else 0 * yy
    if act == 'tanh':
        d = 1 - yy * yy
        return d if one else -2 * yy * d
    if act == 'sigmoid':
        d = yy * (1 - yy)
        return d if one else d * (1 - 2 * yy)
    if act == 'elu':
        return torch.where(yy > 0, 1.0 if one else 0.0, yy + 1)
    if act == 'selu':
        sc, al = 1.0507009873554804934, 1.6732632423543772848
        return torch.where(yy > 0, sc if one else 0.0, yy + sc * al)
    if act == 'softplus':
        s = -torch.expm1(-yy)
        return s if one else (1 - s) * s
    s = torch.sigmoid(z)                                   # swish
    return (s * (1 + z * (1 - s)) if one
            else s * (1 - s) * (2 + z * (1 - 2 * s)))


def bias_act_grad_ref(g: torch.Tensor, x: Optional[torch.Tensor],
                      b: Optional[torch.Tensor], y: Optional[torch.Tensor],
                      dy: Optional[torch.Tensor] = None, order: int = 1,
                      act: str = 'linear', alpha: Optional[float] = None,
                      gain: Optional[float] = None,
                      clamp: Optional[float] = None) -> torch.Tensor:
    """The plain version of the gradient kernel, on any device: what
    ``bias_act_grad_cuda`` computes, in float32 with one rounding."""
    _, alpha, gain = _resolve(act, alpha, gain, clamp)
    yy = None if y is None else y.float() / gain
    z = None
    if x is not None:
        z = x.float() + (b.to(x.dtype).float() if b is not None else 0)
    d = _act_deriv(act, order, yy, z, alpha) * gain * g.float()
    if order == 2:
        d = d * dy.float()
    if clamp is not None:
        bound = float(torch.tensor(clamp, dtype=g.dtype))
        d = torch.where(y.float().abs() < bound, d, 0.0)
    return d.to(g.dtype)


@torch.library.custom_op('mgt::bias_act', mutates_args=())
def bias_act_op(x: torch.Tensor, b: Optional[torch.Tensor], dim: int,
                act: str, alpha: float, gain: float,
                clamp: Optional[float]) -> torch.Tensor:
    """K1' as an operator (CPU face: the plain version)."""
    y = bias_act_ref(x, b, dim, act, alpha, gain, clamp)
    return y.clone() if y is x else y


@bias_act_op.register_kernel('cuda')
def _bias_act_op_cuda(x, b, dim, act, alpha, gain, clamp):
    return bias_act_cuda(x.contiguous(), b, dim, act, alpha, gain, clamp)


@bias_act_op.register_fake
def _bias_act_op_fake(x, b, dim, act, alpha, gain, clamp):
    return x.new_empty(x.shape)


@torch.library.custom_op('mgt::bias_act_grad', mutates_args=())
def bias_act_grad_op(g: torch.Tensor, x: Optional[torch.Tensor],
                     b: Optional[torch.Tensor], y: Optional[torch.Tensor],
                     dy: Optional[torch.Tensor], order: int, act: str,
                     alpha: float, gain: float,
                     clamp: Optional[float]) -> torch.Tensor:
    """K1''s gradient kernel as an operator (CPU face: the plain
    version)."""
    return bias_act_grad_ref(g, x, b, y, dy, order, act, alpha, gain, clamp)


@bias_act_grad_op.register_kernel('cuda')
def _bias_act_grad_op_cuda(g, x, b, y, dy, order, act, alpha, gain, clamp):
    return bias_act_grad_cuda(g.contiguous(), x, b, y, dy, order, act, alpha,
                              gain, clamp)


@bias_act_grad_op.register_fake
def _bias_act_grad_op_fake(g, x, b, y, dy, order, act, alpha, gain, clamp):
    return g.new_empty(g.shape)


def _check(t: torch.Tensor, name: str) -> None:
    if t.device.type != 'cuda':
        raise ValueError(f'bias_act kernel needs a CUDA tensor, got {name} '
                         f'on {t.device}')
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f'bias_act kernel takes float32 or bfloat16, got '
                        f'{name} {t.dtype}')
    if not t.is_contiguous():
        raise ValueError(f'bias_act kernel needs a contiguous {name}')


def _kernel_bias(x: torch.Tensor, b: Optional[torch.Tensor],
                 dim: int) -> Optional[torch.Tensor]:
    """The bias as the kernels read it: [C] along the last dim, x's dtype."""
    if b is None:
        return None
    if b.ndim != 1 or dim % x.ndim != x.ndim - 1 or b.shape[0] != x.shape[-1]:
        raise ValueError('bias_act kernel takes a [C] bias along the last '
                         f'dim; got bias {tuple(b.shape)}, x {tuple(x.shape)}, '
                         f'dim {dim}')
    if b.get_device() != x.get_device():
        raise ValueError(f'bias on {b.device}, x on {x.device}')
    if b.dtype != x.dtype:
        b = b.to(x.dtype)
    return b if b.is_contiguous() else b.contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _clamp_arg(clamp: Optional[float]) -> float:
    return -1.0 if clamp is None else float(clamp)


class _BiasActCuda(torch.autograd.Function):
    """K1' forward; its backward is ``_BiasActCudaGrad`` (or the identity for
    a linear activation with unit gain and no clamp)."""

    @staticmethod
    def forward(ctx, x, b, act, alpha, gain, clamp):
        spec, alpha, gain = _resolve(act, alpha, gain, clamp)
        y = bias_act_cuda(x, b, act=act, alpha=alpha, gain=gain, clamp=clamp)
        ctx.set_materialize_grads(False)
        ctx.params = (act, alpha, gain, clamp)
        keep_x = spec.ref == 'x' or spec.has_2nd_grad
        keep_y = spec.ref == 'y' or clamp is not None
        ctx.save_for_backward(x if keep_x else None,
                              b if keep_x else None,
                              y if keep_y else None)
        ctx.trivial = act == 'linear' and gain == 1 and clamp is None
        ctx.b_dtype = None if b is None else b.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return (None,) * 6
        x, b, y = ctx.saved_tensors
        dx = dy
        if not ctx.trivial:
            dx = _BiasActCudaGrad.apply(dy.contiguous(), x, b,
                                        None if y is None else y.detach(),
                                        *ctx.params)
        db = None
        if ctx.needs_input_grad[1]:
            db = dx.sum(dim=tuple(range(dx.ndim - 1))).to(ctx.b_dtype)
        return dx, db, None, None, None, None


class _BiasActCudaGrad(torch.autograd.Function):
    """Order 1 of K1' (``dx`` from ``dy``); its backward gives the order-2
    terms: ``dx`` is linear in ``dy`` (the same kernel again) and, where
    act'' is non-zero, depends on ``x`` and ``b`` (order 2 of the kernel)."""

    @staticmethod
    def forward(ctx, dy, x, b, y, act, alpha, gain, clamp):
        dx = bias_act_grad_cuda(dy, x, b, y, order=1, act=act, alpha=alpha,
                                gain=gain, clamp=clamp)
        ctx.set_materialize_grads(False)
        ctx.params = (act, alpha, gain, clamp)
        ctx.save_for_backward(dy, x, b, y)
        ctx.b_dtype = None if b is None else b.dtype
        return dx

    @staticmethod
    def backward(ctx, d_dx):
        if d_dx is None:
            return (None,) * 8
        dy, x, b, y = ctx.saved_tensors
        act = ctx.params[0]
        d_dx = d_dx.contiguous()
        d_dy = d_x = d_b = None
        if ctx.needs_input_grad[0]:
            d_dy = _BiasActCudaGrad.apply(d_dx, x, b, y, *ctx.params)
        if activation_funcs[act].has_2nd_grad and (ctx.needs_input_grad[1]
                                                   or ctx.needs_input_grad[2]):
            act, alpha, gain, clamp = ctx.params
            d_x = bias_act_grad_cuda(d_dx, x, b, y, dy.detach(), order=2,
                                     act=act, alpha=alpha, gain=gain,
                                     clamp=clamp)
            if ctx.needs_input_grad[2]:
                d_b = d_x.sum(dim=tuple(range(d_x.ndim - 1))).to(ctx.b_dtype)
        return d_dy, d_x, d_b, None, None, None, None, None


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None,
             dim: int = -1, act: str = 'linear', alpha: Optional[float] = None,
             gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    """Add bias along ``dim``, apply ``act``, scale by ``gain``, clamp to
    ±clamp.  ``dim`` defaults to -1 (channels-last)."""
    if torch.compiler.is_exporting():
        _, alpha, gain = _resolve(act, alpha, gain, clamp)
        return bias_act_op(x, b, dim, act, alpha, gain,
                           None if clamp is None else float(clamp))
    if takes_plain(x):
        return bias_act_ref(x, b, dim, act, alpha, gain, clamp)
    if b is not None:
        _kernel_bias(x, b, dim)              # raises on a bias it cannot take
    return _BiasActCuda.apply(x.contiguous(), b, act, alpha, gain, clamp)
