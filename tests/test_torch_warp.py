"""The port's ADA warp (``montage_gan_tpu_torch.ops.affine_warp``) against the
JAX package's, on the CPU.

* The plain version against JAX's ``affine_warp`` (XLA engine, HIGHEST
  precision) and against JAX's gather composition ``_gather_warp``
  (``upsample2d`` + ``affine_grid`` + ``grid_sample``) at an identity theta,
  thetas drawn by ``sample_warp_theta`` at p = 1, and a theta that maps
  partly off the plane.
* Its gradient (autograd of the plain version) against JAX's exact adjoint,
  ``jax.vjp`` of the gather composition.
* The index algebra of kernels K3'/K4' (``csrc/warp.cu``:
  ``mgt_axis_weights``: the two bilinear taps on the virtual plane, the
  filter index ``m − up·l + k0``, gain ``up``) mirrored in numpy and held to
  the plain version, which pins ``p0`` and the gain to ``upsample2d_ref``.
* The mutually adjoint Functions ``_Warp``/``_WarpT`` with emulated kernels:
  orders 1 and 2 against plain autograd, with their launch counts.
* One small case against the Pallas kernels ``warp_forward_pallas`` and
  ``warp_transpose_pallas`` in interpret mode with float32 compute.

Tolerances: float32 ``atol 2e-5`` (sums of up to 49 taps in another order;
the inputs are O(1)).
"""

import functools
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental.pallas import tpu as pltpu
import torch

from montage_gan_tpu.ops.pallas.warp_kernel import (warp_forward_pallas,
                                                    warp_transpose_pallas)
from montage_gan_tpu.training import augment as jaug
from montage_gan_tpu_torch.ops import affine_warp as taw
from montage_gan_tpu_torch.training import augment as taug

from test_torch_grads import emulate_kernels
from test_torch_train import FAST_COMPILE

# montage_gan_tpu.ops re-exports functions under some module names, so its
# modules are imported by full name.
jaw = importlib.import_module('montage_gan_tpu.ops.affine_warp')
jgs = importlib.import_module('montage_gan_tpu.ops.grid_sample')
jup = importlib.import_module('montage_gan_tpu.ops.upfirdn2d')

torch.set_num_threads(1)

F_GEOM = np.asarray(jaug._HZ_GEOM, np.float32)     # 12-tap sym6, normalized
ATOL = 2e-5


def _thetas(kind, n, h, w):
    """(x shape, theta [n, 2, 3], out_h, out_w) for a case."""
    if kind == 'sampled':   # the pipe's own law at p = 1, 16x16 crops
        theta, ph, pw, oh, ow = jaug.sample_warp_theta(
            jax.random.PRNGKey(3), 1.0, jaug.make_augment_config('bgcfnc'),
            n, 16, 16)
        return (n, ph, pw, 4), np.array(theta, np.float32), oh, ow
    if kind == 'identity':
        theta = np.tile(np.eye(2, 3, dtype=np.float32), (n, 1, 1))
        return (n, h, w, 4), theta, 2 * h, 2 * w
    theta = np.asarray([[[1.3, 0.2, 0.7], [-0.1, 1.2, -0.6]]] * n,
                       np.float32)                       # partly off-plane
    return (n, h, w, 4), theta, 2 * h - 6, 2 * w + 4


def _jax_gather(x, theta, out_h, out_w):
    xx = jup.upsample2d(x, F_GEOM, up=2)
    return jgs.grid_sample(xx, jgs.affine_grid(theta, out_h, out_w))


@pytest.mark.parametrize('kind', ['identity', 'sampled', 'off_plane'])
def test_affine_warp_and_vjp_match_jax(kind):
    shape, theta, out_h, out_w = _thetas(kind, 3, 14, 18)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    g = rng.randn(shape[0], out_h, out_w, 4).astype(np.float32)
    engine = jax.jit(functools.partial(
        jaw.affine_warp, out_h=out_h, out_w=out_w, up=2, up_filter=F_GEOM,
        precision=lax.Precision.HIGHEST,
        weight_precision=lax.Precision.HIGHEST), compiler_options=FAST_COMPILE)
    ref_engine = engine(jnp.asarray(x), jnp.asarray(theta))
    ref, vjp = jax.vjp(lambda v: _jax_gather(v, jnp.asarray(theta), out_h,
                                             out_w), jnp.asarray(x))
    ref_dx, = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    out = taw.affine_warp(xt, torch.from_numpy(theta), out_h, out_w, up=2,
                          up_filter=F_GEOM)
    dx, = torch.autograd.grad(out, xt, torch.from_numpy(g))
    assert out.shape == (shape[0], out_h, out_w, 4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_engine),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), rtol=0,
                               atol=ATOL)
    if kind == 'off_plane':      # a part of the output really is off-plane
        assert (np.abs(out.detach().numpy()).max(axis=-1) == 0).mean() > 0.05


def _axis_weights(s, length, up, taps):
    """numpy mirror of csrc/warp.cu::mgt_axis_weights, for one coordinate:
    {stored index l: weight}."""
    n_taps = len(taps)
    k0 = n_taps - 1 - (n_taps + up - 1) // 2
    m0 = int(np.floor(s))
    t = s - m0
    lo = max(-((-(m0 + k0 - n_taps + 1)) // up), 0)      # ceil division
    hi = min((m0 + 1 + k0) // up, length - 1)            # floor division
    out = {}
    for l in range(lo, hi + 1):
        acc = 0.0
        for e, bw in ((0, 1.0 - t), (1, t)):
            m = m0 + e
            j = m - up * l + k0
            if 0 <= m < up * length and 0 <= j < n_taps:
                acc += bw * up * taps[j]
        out[l] = acc
    assert len(out) <= 8
    return out


def test_kernel_index_algebra_matches_plain():
    shape, theta, out_h, out_w = _thetas('off_plane', 1, 9, 7)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    ref = taw.affine_warp_ref(torch.from_numpy(x), torch.from_numpy(theta),
                              out_h, out_w, up=2, up_filter=F_GEOM).numpy()
    n, h, w, _ = shape
    out = np.zeros_like(ref)
    th = theta[0].astype(np.float64)
    for i in range(out_h):
        for j in range(out_w):
            xo, yo = (2 * j + 1) / out_w - 1, (2 * i + 1) / out_h - 1
            sx = (th[0, 0] * xo + th[0, 1] * yo + th[0, 2] + 1) * w - 0.5
            sy = (th[1, 0] * xo + th[1, 1] * yo + th[1, 2] + 1) * h - 0.5
            wy = _axis_weights(sy, h, 2, F_GEOM)
            wx = _axis_weights(sx, w, 2, F_GEOM)
            for ly, a in wy.items():
                for lx, b in wx.items():
                    out[0, i, j] += a * b * x[0, ly, lx]
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_warp_functions_match_plain_autograd(monkeypatch):
    """_Warp and _WarpT are each other's backward: orders 1 and 2 equal
    plain autograd, with one K3' (forward), one K4' (backward) and, at order
    2, K3' (the backward's backward) and K4' (the forward node again)."""
    shape, theta, out_h, out_w = _thetas('sampled', 2, 0, 0)
    gen = torch.Generator().manual_seed(2)
    x0 = torch.rand(shape, generator=gen)
    r = torch.randn(shape[0], out_h, out_w, 4, generator=gen)
    s = torch.randn(shape, generator=gen)
    th = torch.from_numpy(theta)
    f = torch.from_numpy(F_GEOM)

    def run():
        x = x0.clone().requires_grad_(True)
        out = taw.affine_warp(x * x, th, out_h, out_w, up=2, up_filter=f)
        g1, = torch.autograd.grad((out.square() * r).sum(), x,
                                  create_graph=True)
        g2, = torch.autograd.grad((g1 * s).sum(), x)
        return out, g1, g2

    ref = run()
    kernels = emulate_kernels(monkeypatch)
    got = run()
    assert kernels['warp_forward'].launches == 2
    assert kernels['warp_transpose'].launches == 2
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_plain_warp_matches_pallas_kernels_interpret():
    """Tiny canvas: the Pallas window covers the whole plane (block 64), so
    the TPU kernels are exact; compute in float32."""
    rng = np.random.RandomState(4)
    x = rng.uniform(0, 1, (1, 20, 24, 4)).astype(np.float32)
    theta = np.asarray([[[0.9, 0.1, 0.05], [-0.08, 1.1, -0.1]]], np.float32)
    g = rng.randn(1, 30, 26, 4).astype(np.float32)
    taps = tuple(float(v) for v in F_GEOM)
    with pltpu.force_tpu_interpret_mode():
        fwd = warp_forward_pallas(jnp.asarray(x), jnp.asarray(theta), 30, 26,
                                  tile=8, block=64, up=2, taps=taps,
                                  compute_dtype=jnp.float32)
        adj = warp_transpose_pallas(jnp.asarray(g), jnp.asarray(theta), 20,
                                    24, tile=8, block=64, up=2, taps=taps,
                                    compute_dtype=jnp.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = taw.affine_warp(xt, torch.from_numpy(theta), 30, 26, up=2,
                          up_filter=F_GEOM)
    dx, = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(fwd), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(dx.numpy(), np.asarray(adj), rtol=0, atol=1e-4)


def test_sample_warp_theta_geometry_matches_jax():
    """The port's theta law reaches the warp with JAX's plane geometry; at
    p = 0 every gate is off and both give the same identity-derived theta."""
    cfg_t = taug.make_augment_config('bgcfnc')
    cfg_j = jaug.make_augment_config('bgcfnc')
    for hw in ((16, 16), (64, 32), (96, 160)):
        assert taug._warp_geometry(cfg_t, *hw) == jaug._warp_geometry(cfg_j, *hw)
        theta_j, *geom_j = jaug.sample_warp_theta(jax.random.PRNGKey(0), 0.0,
                                                  cfg_j, 2, *hw)
        theta_t, *geom_t = taug.sample_warp_theta(
            taug.Draws(torch.Generator()), 0.0, cfg_t, 2, *hw, device='cpu')
        assert tuple(geom_t) == tuple(geom_j)
        np.testing.assert_allclose(theta_t.numpy(), np.asarray(theta_j),
                                   rtol=0, atol=1e-7)
