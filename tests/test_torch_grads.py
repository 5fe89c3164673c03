"""Gradients of the port's ops against the JAX package's, on the CPU, and the
kernels' autograd Functions against plain autograd.

1. First- and second-order gradients of the plain versions (``bias_act``,
   ``upfirdn2d``, ``conv2d_resample``, ``modulated_conv2d``,
   ``grid_sample``) against ``jax.grad`` of the JAX ops, on the same numpy
   inputs.  Order 2 is the gradient of ``<∇_x L, s>`` (what R1 and path
   length differentiate).
2. The CUDA path's autograd Functions (``_BiasActCuda``/``_BiasActCudaGrad``,
   ``_Upfirdn2dCuda``) run here with every kernel entry point replaced by a
   plain PyTorch computation of what the kernel computes
   (``emulate_kernels``), and must give plain autograd's gradients, orders 1
   and 2.  The CUDA sources themselves are held to the plain versions on the
   card (``chip_smoke.py``).

Tolerances: float32 elementwise ``rtol 1e-5, atol 1e-5``; convolutions and
grid sampling ``atol 1e-4`` (sums in another order); bfloat16 (emulated
kernels, which round once, against plain autograd, which rounds each step)
``rtol 3e-2, atol 3e-2``, a few bfloat16 ulps.
"""

import collections
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

jba = importlib.import_module('montage_gan_tpu.ops.bias_act')
jconv = importlib.import_module('montage_gan_tpu.ops.conv2d_resample')
jfilters = importlib.import_module('montage_gan_tpu.ops.filters')
jgs = importlib.import_module('montage_gan_tpu.ops.grid_sample')
jmod = importlib.import_module('montage_gan_tpu.ops.modulated_conv')
jup = importlib.import_module('montage_gan_tpu.ops.upfirdn2d')
from montage_gan_tpu_torch.ops import affine_warp as taw
from montage_gan_tpu_torch.ops import bias_act as tba
from montage_gan_tpu_torch.ops import composite as tcomp
from montage_gan_tpu_torch.ops import conv2d_resample as tconv
from montage_gan_tpu_torch.ops import filters as tfilters
from montage_gan_tpu_torch.ops import grid_sample as tgs
from montage_gan_tpu_torch.ops import modulated_conv as tmod
from montage_gan_tpu_torch.ops import upfirdn2d as tup

from test_torch_composite_plans import emulated_composite

torch.set_num_threads(1)

F2D = [1, 3, 3, 1]
F1D_8 = [1, 2, 3, 4, 4, 3, 2, 1]


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(
        requires_grad)


def _close(port, ref, atol=1e-5, rtol=1e-5):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def _grads_2(fn_t, fn_j, args, r, s, wrt2):
    """Orders 1 and 2 of ``L = <fn(args), r>`` in both frameworks: order 1
    is ∇ L for every arg; order 2 is ∇_{wrt2} <∇_{args[0]} L, s>.  Returns
    (port order 1, JAX order 1, port order 2, JAX order 2)."""
    targs = [_t(a, True) for a in args]
    out = fn_t(*targs)
    g1 = torch.autograd.grad((out * _t(r)).sum(), targs, create_graph=True)
    g2 = [None] * len(wrt2)
    if wrt2 and g1[0].requires_grad:     # else ∇_x L does not depend on args
        g2 = torch.autograd.grad((g1[0] * _t(s)).sum(),
                                 [targs[i] for i in wrt2], allow_unused=True)
    g2 = [torch.zeros_like(targs[i]) if g is None else g
          for g, i in zip(g2, wrt2)]

    def loss(*a):
        return jnp.sum(fn_j(*a) * r)

    jargs = [jnp.asarray(a) for a in args]
    j1 = jax.grad(loss, argnums=tuple(range(len(args))))(*jargs)

    def inner(*a):
        return jnp.sum(jax.grad(loss, argnums=0)(*a) * s)

    j2 = jax.grad(inner, argnums=tuple(wrt2))(*jargs) if wrt2 else ()
    return g1, j1, g2, j2


# ---------------------------------------------------------------------------
# 1. Plain versions against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('act', sorted(jba.activation_funcs))
def test_bias_act_grads_match_jax(act):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 3, 4, 6) * 2).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    r, s = rng.randn(2, *x.shape).astype(np.float32)
    clamp = 1.5 if act in ('linear', 'lrelu', 'swish') else None
    g1, j1, g2, j2 = _grads_2(
        lambda x, b: tba.bias_act(x, b, act=act, clamp=clamp),
        lambda x, b: jba.bias_act(x, b, act=act, clamp=clamp),
        [x, b], r, s, wrt2=(0, 1))
    for a, b_ in zip(g1 + tuple(g2), tuple(j1) + tuple(j2)):
        _close(a, b_, rtol=1e-5, atol=1e-5)


UPFIRDN_CASES = [
    dict(f=F2D, up=2, padding=[2, 1, 2, 1], gain=4.0),       # upsample2d
    dict(f=F2D, down=2, padding=1),
    dict(f=F1D_8, up=2, down=1, padding=3, gain=2.0),
    dict(f=F1D_8, up=[2, 1], down=[1, 2], padding=[3, 4, -1, 2],
         flip_filter=True),
]


@pytest.mark.parametrize('case', UPFIRDN_CASES,
                         ids=[f'case{i}' for i in range(len(UPFIRDN_CASES))])
def test_upfirdn2d_grad_matches_jax(case):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 11, 3).astype(np.float32)
    kw = {k: v for k, v in case.items() if k != 'f'}
    jf, tf = jfilters.setup_filter(case['f']), tfilters.setup_filter(case['f'])
    r = rng.randn(*tup.upfirdn2d(_t(x), tf, **kw).shape).astype(np.float32)
    s = rng.randn(*x.shape).astype(np.float32)
    g1, j1, _, _ = _grads_2(lambda x: tup.upfirdn2d(x, tf, **kw),
                            lambda x: jup.upfirdn2d(x, jf, **kw),
                            [x], r, s, wrt2=())
    _close(g1[0], j1[0])


CONV_CASES = [
    dict(k=3, up=2, down=1, padding=1, flip_weight=False),   # synthesis conv0
    dict(k=3, up=1, down=2, padding=1, flip_weight=True),    # D conv1
    dict(k=1, up=1, down=2, padding=0, flip_weight=True),    # D skip
    dict(k=3, up=1, down=1, padding=1, flip_weight=True),    # synthesis conv1
]


@pytest.mark.parametrize('case', CONV_CASES,
                         ids=lambda c: f"k{c['k']}-up{c['up']}-down{c['down']}")
def test_conv2d_resample_grads_match_jax(case):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 6, 5).astype(np.float32)
    w = rng.randn(case['k'], case['k'], 5, 7).astype(np.float32)   # HWIO
    jf, tf = jfilters.setup_filter(F2D), tfilters.setup_filter(F2D)
    kw = {k: v for k, v in case.items() if k != 'k'}
    out = jconv.conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=jf, **kw)
    r = rng.randn(*out.shape).astype(np.float32)
    s = rng.randn(*x.shape).astype(np.float32)
    g1, j1, g2, j2 = _grads_2(
        lambda x, w: tconv.conv2d_resample(x, w.permute(3, 2, 0, 1), f=tf, **kw),
        lambda x, w: jconv.conv2d_resample(x, w, f=jf, **kw),
        [x, w], r, s, wrt2=(1,))
    for a, b in zip(tuple(g1) + tuple(g2), tuple(j1) + tuple(j2)):
        _close(a, b, atol=1e-4)


@pytest.mark.parametrize('up,demodulate', [(1, True), (2, True), (1, False)])
def test_modulated_conv2d_grads_match_jax(up, demodulate):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 4, 8).astype(np.float32)
    w = rng.randn(6, 8, 3, 3).astype(np.float32)                   # OIHW
    styles = (rng.rand(2, 8) + 0.5).astype(np.float32)
    jf, tf = jfilters.setup_filter(F2D), tfilters.setup_filter(F2D)
    kw = dict(up=up, padding=1, demodulate=demodulate, flip_weight=(up == 1))
    r = rng.randn(2, 6 * up, 4 * up, 6).astype(np.float32)
    s = rng.randn(*x.shape).astype(np.float32)
    g1, j1, g2, j2 = _grads_2(
        lambda x, w, st: tmod.modulated_conv2d(x, w, st, resample_filter=tf,
                                               **kw),
        lambda x, w, st: jmod.modulated_conv2d(
            x, jnp.transpose(w, (2, 3, 1, 0)), st, resample_filter=jf, **kw),
        [x, w, styles], r, s, wrt2=(1, 2))
    for a, b in zip(tuple(g1) + tuple(g2), tuple(j1) + tuple(j2)):
        _close(a, b, atol=1e-4, rtol=1e-4)


def test_grid_sample_grads_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 7, 9, 3).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 5, 6, 2)).astype(np.float32)
    r = rng.randn(2, 5, 6, 3).astype(np.float32)
    s = rng.randn(*x.shape).astype(np.float32)
    g1, j1, g2, j2 = _grads_2(tgs.grid_sample, jgs.grid_sample, [x, grid],
                              r, s, wrt2=(1,))
    for a, b in zip(tuple(g1) + tuple(g2), tuple(j1) + tuple(j2)):
        _close(a, b, atol=1e-4)


# ---------------------------------------------------------------------------
# 2. The kernels' autograd Functions, with emulated kernels
# ---------------------------------------------------------------------------

def _emulated_bias_act(x, b=None, dim=-1, act='linear', alpha=None,
                       gain=None, clamp=None):
    """What K1' computes: float32 arithmetic, one rounding."""
    spec, alpha, gain = tba._resolve(act, alpha, gain, clamp)
    v = x.float()
    if b is not None:
        v = v + b.to(x.dtype).float()
    v = spec.func(v, alpha=alpha) * gain
    if clamp is not None:
        c = _storage_clamp(clamp, x.dtype)
        v = v.clamp(-c, c)
    plan = tba._stream_plan(x.numel(), 1 if b is None else b.shape[0],
                            x.element_size(), x.data_ptr() % 16 == 0,
                            b is not None)
    tba.kernel.count(plan.variant, plan.moved)
    return v.to(x.dtype)


def _storage_clamp(clamp, dtype):
    """The clamp bound as the storage type holds it (csrc mgt_round_to)."""
    return float(torch.tensor(clamp, dtype=dtype))


def _emulated_bias_act_grad(g, x, b, y, dy=None, order=1, act='linear',
                            alpha=None, gain=None, clamp=None):
    """What the gradient kernel computes (its plain version,
    ``bias_act_grad_ref``)."""
    out = tba.bias_act_grad_ref(g, x, b, y, dy, order, act, alpha, gain,
                                clamp)
    tba.grad_kernel.launches += 1
    return out


def _emulated_upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter=False,
                        gain=1.0):
    y = tup.upfirdn2d_ref(x, f, up, down, padding, flip_filter, gain)
    fh, fw = tup._filter_size(f)
    tup.kernel.count(tup.kernel_variant(tup._parse_scaling(up),
                                        tup._parse_scaling(down), fh, fw,
                                        x.shape[-1]),
                     (x.numel() + y.numel()) * x.element_size())
    return y


def _count_warp(kernel, kind, stored, out, theta, taps, up):
    """Count a warp launch under the variant the wrapper picks for it
    (``stored``: x or dx, ``out``: the warp's output or its cotangent)."""
    plan = taw.warp_plan(kind, stored.shape[0], tuple(stored.shape[1:3]),
                         tuple(out.shape[1:3]), stored.shape[-1],
                         taps.shape[0], up)
    kernel.count(plan.variant, sum(t.numel() * t.element_size()
                                   for t in (stored, theta, taps, out)))


def _emulated_warp_forward(x, theta, out_h, out_w, up, taps,
                           direct_blocks=None):
    out = taw.affine_warp_ref(x, theta, out_h, out_w, up,
                              taps if up > 1 else None)
    _count_warp(taw.forward_kernel, 'forward', x, out, theta, taps, up)
    return out


def _emulated_warp_transpose(g, theta, h, w, up, taps, direct_blocks=None):
    with torch.enable_grad():
        x0 = torch.zeros(g.shape[0], h, w, g.shape[-1], requires_grad=True)
        y = taw.affine_warp_ref(x0, theta, g.shape[1], g.shape[2], up,
                                taps if up > 1 else None)
        dx, = torch.autograd.grad(y, x0, g)
    _count_warp(taw.transpose_kernel, 'transpose', dx, g, theta, taps, up)
    return dx


def emulate_kernels(monkeypatch):
    """Route CPU tensors through the CUDA path (the autograd Functions), with
    each kernel entry point replaced by its emulation above, counted on the
    kernel's own launch counter."""
    for mod in (tba, tup, taw, tcomp):
        monkeypatch.setattr(mod, 'takes_plain', lambda x: False)
    monkeypatch.setattr(tba, 'bias_act_cuda', _emulated_bias_act)
    monkeypatch.setattr(tba, 'bias_act_grad_cuda', _emulated_bias_act_grad)
    monkeypatch.setattr(tup, 'upfirdn2d_cuda', _emulated_upfirdn2d)
    monkeypatch.setattr(taw, 'warp_forward_cuda', _emulated_warp_forward)
    monkeypatch.setattr(taw, 'warp_transpose_cuda', _emulated_warp_transpose)
    monkeypatch.setattr(tcomp, 'translate_and_composite_cuda',
                        emulated_composite)
    kernels = {'bias_act': tba.kernel, 'bias_act_grad': tba.grad_kernel,
               'upfirdn2d': tup.kernel, 'warp_forward': taw.forward_kernel,
               'warp_transpose': taw.transpose_kernel,
               'composite': tcomp.kernel}
    for k in kernels.values():
        monkeypatch.setattr(k, 'launches', 0)
        monkeypatch.setattr(k, 'bytes', 0)
        monkeypatch.setattr(k, 'variants', collections.Counter())
    return kernels


def _orders_1_2(fn, inputs, r, s):
    """∇ <fn(inputs)², r> for every input, and ∇ <∇_{inputs[0]}, s>.  The
    square makes the first-order cotangent depend on the inputs, so order 2
    also runs the backward of the first-order backward."""
    out = fn(*inputs)
    g1 = torch.autograd.grad((out.float().square() * r).sum(), inputs,
                             create_graph=True, allow_unused=True)
    g2 = torch.autograd.grad((g1[0].float() * s).sum(), inputs,
                             allow_unused=True)
    return out, g1, g2


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('act', sorted(tba.activation_funcs))
def test_bias_act_functions_match_plain_autograd(act, dtype, monkeypatch):
    gen = torch.Generator().manual_seed(0)
    x0 = (torch.randn(3, 5, 16, generator=gen) * 2).to(dtype)
    b0 = torch.randn(16, generator=gen)
    r, s = torch.randn(2, 3, 5, 16, generator=gen)
    clamp = 1.5 if act in ('linear', 'lrelu', 'swish') else None
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=3e-2, atol=3e-2))

    def run():
        x = x0.clone().requires_grad_(True)
        b = b0.clone().requires_grad_(True)
        return _orders_1_2(lambda x, b: tba.bias_act(x, b, act=act,
                                                     clamp=clamp),
                           (x, b), r, s)

    # Where the unclamped value rounds to exactly ±clamp (bfloat16 makes such
    # ties likely) the plain clamp passes the gradient (PyTorch: inclusive;
    # JAX: half) and the kernel, which cannot tell a tie from saturation in
    # y, does not; such inputs are moved off the tie.
    while clamp is not None:
        tie = tba.bias_act_ref(x0, b0, act=act).abs() == clamp
        if not tie.any():
            break
        x0 = torch.where(tie, x0 * 1.1, x0)
    ref = run()
    kernels = emulate_kernels(monkeypatch)
    out = run()
    grad_launches = kernels['bias_act_grad'].launches
    assert kernels['bias_act'].launches == 1
    spec = tba.activation_funcs[act]
    trivial = act == 'linear' and clamp is None
    # order 1 once; at order 2: its backward (d_dy), the order-2 term where
    # act'' != 0, and order 1 again for the forward node (the cotangent
    # depends on the output)
    assert grad_launches == (0 if trivial else 3 + spec.has_2nd_grad)
    for a, b in zip((out[0],) + out[1] + out[2], (ref[0],) + ref[1] + ref[2]):
        if b is None:
            assert a is None or not a.abs().any()
            continue
        torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.parametrize('case', UPFIRDN_CASES,
                         ids=[f'case{i}' for i in range(len(UPFIRDN_CASES))])
def test_upfirdn2d_function_matches_plain_autograd(case, monkeypatch):
    """K2' transposed is the backward, and its backward is K2' again."""
    gen = torch.Generator().manual_seed(1)
    f = tfilters.setup_filter(case['f'])
    kw = {k: v for k, v in case.items() if k != 'f'}
    x0 = torch.randn(2, 9, 11, 3, generator=gen)
    w = torch.randn(3, generator=gen)     # makes order 2 non-zero: x·x·w

    def fn(x):
        return tup.upfirdn2d(x * x * w, f, **kw)

    r = torch.randn(fn(x0).shape, generator=gen)

    def run():
        x = x0.clone().requires_grad_(True)
        return _orders_1_2(fn, (x,), r, torch.ones_like(x0))

    ref = run()
    kernels = emulate_kernels(monkeypatch)
    out = run()
    # forward, backward; at order 2 the backward's backward (K2' again) and
    # the forward node's backward (the cotangent depends on the output)
    assert kernels['upfirdn2d'].launches == 4
    for a, b in zip((out[0],) + out[1] + out[2], (ref[0],) + ref[1] + ref[2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
