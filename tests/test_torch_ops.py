"""The port's ops (``montage_gan_tpu_torch.ops``) against the JAX package's on
the CPU: the same numpy inputs through both, float32.

Tolerances: elementwise ops and the FIR ops ``atol 1e-5`` (float32 rounding
of a few terms); convolutions ``atol 1e-4`` (sums over hundreds of products
in another order).  Where the JAX function reaches a Pallas kernel, it runs
in interpret mode, as ``tests/test_pallas_kernels.py`` runs it.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

# montage_gan_tpu.ops re-exports functions under some module names
# (bias_act, upfirdn2d, ...), so its modules are imported by full name.
jba = importlib.import_module('montage_gan_tpu.ops.bias_act')
jcomp = importlib.import_module('montage_gan_tpu.ops.composite')
jconv = importlib.import_module('montage_gan_tpu.ops.conv2d_resample')
jfilters = importlib.import_module('montage_gan_tpu.ops.filters')
jgs = importlib.import_module('montage_gan_tpu.ops.grid_sample')
jmod = importlib.import_module('montage_gan_tpu.ops.modulated_conv')
jup = importlib.import_module('montage_gan_tpu.ops.upfirdn2d')
from montage_gan_tpu_torch.ops import bias_act as tba
from montage_gan_tpu_torch.ops import composite as tcomp
from montage_gan_tpu_torch.ops import conv2d_resample as tconv
from montage_gan_tpu_torch.ops import filters as tfilters
from montage_gan_tpu_torch.ops import grid_sample as tgs
from montage_gan_tpu_torch.ops import modulated_conv as tmod
from montage_gan_tpu_torch.ops import upfirdn2d as tup

torch.set_num_threads(1)

ATOL = 1e-5        # elementwise / FIR ops, float32
ATOL_CONV = 1e-4   # convolutions: summation order


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(port, ref, atol=ATOL, rtol=1e-5):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def _interpret_pallas():
    from jax.experimental.pallas import tpu as pltpu
    return pltpu.force_tpu_interpret_mode()


# ---------------------------------------------------------------------------
# bias_act
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('with_bias,clamp', [(True, None), (False, 0.5)])
@pytest.mark.parametrize('act', sorted(jba.activation_funcs))
def test_bias_act_matches_jax(act, with_bias, clamp):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 4, 6) * 2).astype(np.float32)
    b = rng.randn(6).astype(np.float32) if with_bias else None
    ref = jba.bias_act(jnp.asarray(x), None if b is None else jnp.asarray(b),
                       act=act, clamp=clamp)
    out = tba.bias_act(_t(x), None if b is None else _t(b), act=act,
                       clamp=clamp)
    _close(out, ref, rtol=1e-6)


def test_bias_act_registry_matches_jax():
    assert sorted(tba.activation_funcs) == sorted(jba.activation_funcs)
    for name, spec in jba.activation_funcs.items():
        assert tba.activation_funcs[name].def_gain == spec.def_gain
        assert tba.activation_funcs[name].def_alpha == spec.def_alpha


def test_bias_act_matches_pallas_kernel():
    from montage_gan_tpu.ops.pallas.bias_act_kernel import bias_act_pallas
    rng = np.random.RandomState(1)
    x = rng.randn(4, 8, 8, 16).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    with _interpret_pallas():
        ref = bias_act_pallas(jnp.asarray(x), jnp.asarray(b), act='lrelu',
                              gain=np.sqrt(2), clamp=256.0)
    out = tba.bias_act(_t(x), _t(b), act='lrelu', gain=np.sqrt(2), clamp=256.0)
    _close(out, ref, rtol=1e-6)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never falls back: a CPU tensor is refused, and the
    launch count does not move."""
    before = (tba.kernel.launches, tup.kernel.launches)
    with pytest.raises(ValueError, match='CUDA tensor'):
        tba.bias_act_cuda(torch.zeros(2, 3))
    with pytest.raises(ValueError, match='CUDA tensor'):
        tup.upfirdn2d_cuda(torch.zeros(1, 4, 4, 2), tfilters.setup_filter(F2D),
                           up=2, padding=[2, 1, 2, 1])
    assert (tba.kernel.launches, tup.kernel.launches) == before


# ---------------------------------------------------------------------------
# upfirdn2d and its resampling wrappers
# ---------------------------------------------------------------------------

F2D = [1, 3, 3, 1]                  # setup_filter → [4, 4]
F1D_8 = [1, 2, 3, 4, 4, 3, 2, 1]    # ≥ 8 taps: stays separable

UPFIRDN_CASES = [
    dict(f=F2D, up=2, down=1, padding=[2, 1, 2, 1], gain=4.0),   # upsample2d
    dict(f=F2D, up=1, down=2, padding=1),
    dict(f=F2D, up=2, down=2, padding=[2, 1, 1, 2]),
    dict(f=F2D, up=1, down=1, padding=[-1, 2, 0, -2]),           # crop
    dict(f=F2D, up=2, down=1, padding=2, flip_filter=True, gain=2.0),
    dict(f=F1D_8, up=2, down=1, padding=3, gain=2.0),
    dict(f=F1D_8, up=1, down=2, padding=[3, 4, -1, 2], flip_filter=True),
    dict(f=None, up=1, down=1, padding=1),
]


def _filters(f):
    if f is None:
        return None, None
    return jfilters.setup_filter(f), tfilters.setup_filter(f)


def test_setup_filter_matches_jax():
    for f in (F2D, F1D_8, [1, 2, 1], None, 2.0):
        jf, tf = _filters(f) if f is not None else (
            jfilters.setup_filter(None), tfilters.setup_filter(None))
        np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(
        tfilters.setup_filter(F2D, flip_filter=True, gain=3.0).numpy(),
        jfilters.setup_filter(F2D, flip_filter=True, gain=3.0))


@pytest.mark.parametrize('case', UPFIRDN_CASES,
                         ids=[f'case{i}' for i in range(len(UPFIRDN_CASES))])
def test_upfirdn2d_matches_jax(case):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 11, 3).astype(np.float32)
    jf, tf = _filters(case['f'])
    kw = {k: v for k, v in case.items() if k != 'f'}
    ref = jup.upfirdn2d(jnp.asarray(x), jf, **kw)
    _close(tup.upfirdn2d(_t(x), tf, **kw), ref)


@pytest.mark.parametrize('fn', ['upsample2d', 'downsample2d', 'filter2d'])
@pytest.mark.parametrize('f', [F2D, F1D_8], ids=['2d', '1d'])
def test_resample_wrappers_match_jax(fn, f):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 6, 4).astype(np.float32)
    jf, tf = _filters(f)
    ref = getattr(jup, fn)(jnp.asarray(x), jf)
    _close(getattr(tup, fn)(_t(x), tf), ref)


def test_upfirdn2d_matches_pallas_kernel():
    from montage_gan_tpu.ops.pallas.upfirdn2d_kernel import upfirdn2d_pallas
    rng = np.random.RandomState(2)
    x = rng.randn(2, 12, 16, 8).astype(np.float32)
    jf = jfilters.setup_filter(F2D[:], separable=True)
    tf = tfilters.setup_filter(F2D[:], separable=True)
    assert jf.ndim == 1 and tf.ndim == 1
    with _interpret_pallas():
        ref = upfirdn2d_pallas(jnp.asarray(x), jf, up=2, down=1,
                               padding=(2, 1), gain=4.0)
    _close(tup.upfirdn2d(_t(x), tf, up=2, down=1, padding=(2, 1), gain=4.0),
           ref)


# ---------------------------------------------------------------------------
# conv2d_resample (FIR fold on) and modulated_conv2d
# ---------------------------------------------------------------------------

CONV_CASES = [
    dict(k=3, up=2, down=1, padding=1, flip_weight=False),   # synthesis conv0
    dict(k=3, up=1, down=2, padding=1, flip_weight=True),    # D conv1
    dict(k=1, up=1, down=2, padding=0, flip_weight=True),    # D skip
    dict(k=3, up=1, down=1, padding=1, flip_weight=True),    # synthesis conv1
    dict(k=3, up=1, down=1, padding=[0, 2, 1, 1], flip_weight=False),
]


@pytest.mark.parametrize('case', CONV_CASES,
                         ids=lambda c: f"k{c['k']}-up{c['up']}-down{c['down']}")
def test_conv2d_resample_matches_jax(case):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 6, 5).astype(np.float32)
    w = rng.randn(case['k'], case['k'], 5, 7).astype(np.float32)  # HWIO
    jf, tf = _filters(F2D)
    kw = dict(up=case['up'], down=case['down'], padding=case['padding'],
              flip_weight=case['flip_weight'])
    ref = jconv.conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=jf, **kw)
    out = tconv.conv2d_resample(_t(x), _t(w.transpose(3, 2, 0, 1)), f=tf, **kw)
    _close(out, ref, atol=ATOL_CONV)


def _zero_stuffed_up(x, w, f, up, down, padding, flip_weight):
    """The up path as a dense conv over the zero-inserted input: with a
    filter and no downsampling the FIR folded into the weight (gain up²),
    else the conv alone, then the FIR and the downsampling."""
    kh, kw = w.shape[2:]
    fh, fw = tup._filter_size(f)
    px0, px1, py0, py1 = tup._parse_padding(padding)
    px0 += (fw + up - 1) // 2
    px1 += (fw - up) // 2
    py0 += (fh + up - 1) // 2
    py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
    if down == 1 and f is not None:
        wf = tconv._fold_weight_fir(w, f, flip_weight, False, gain=up ** 2)
        xp = tup.zero_insert_pad(x, (up, up), (px0, px1, py0, py1))
        return torch.nn.functional.conv2d(xp, wf).permute(0, 2, 3, 1)
    wc = w if flip_weight else w.flip([2, 3])
    xp = tup.zero_insert_pad(x, (up, up), (kw - 1, kw - 1, kh - 1, kh - 1))
    y = torch.nn.functional.conv2d(xp, wc).permute(0, 2, 3, 1)
    y = tup.upfirdn2d(y, f, padding=[px0 - (kw - 1), px1 - (kw - 1),
                                     py0 - (kh - 1), py1 - (kh - 1)],
                      gain=up ** 2)
    return tup.upfirdn2d(y, f, down=down) if down > 1 else y


UP_CASES = [
    dict(k=3, h=8, padding=1, down=1, flip_weight=False),   # synthesis conv0
    dict(k=3, h=8, padding=1, down=1, flip_weight=True),
    dict(k=1, h=8, padding=0, down=1, flip_weight=False),
    dict(k=3, h=7, padding=1, down=1, flip_weight=False),   # odd H
    dict(k=3, h=8, padding=1, down=2, flip_weight=True),
    dict(k=3, h=5, padding=[0, 2, 1, -1], down=1, flip_weight=True),
    dict(k=2, h=6, padding=0, down=1, flip_weight=False),   # even kernel
    dict(k=3, h=5, padding=1, down=1, flip_weight=False, up=3),
    dict(k=3, h=6, padding=1, down=1, flip_weight=False, f=None),
]


@pytest.mark.parametrize('case', UP_CASES, ids=lambda c: (
    f"k{c['k']}-h{c['h']}-up{c.get('up', 2)}-down{c['down']}"
    f"-flip{int(c['flip_weight'])}-pad{c['padding']}"
    f"{'-nofilter' if 'f' in c else ''}".replace(' ', '')))
def test_conv2d_resample_up_matches_zero_stuffed(case):
    """The up path (the folded kernel's phases over the input) equals the
    dense conv over the zero-inserted input, float64."""
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(2, case['h'], 6, 5, generator=gen, dtype=torch.float64)
    w = torch.randn(7, 5, case['k'], case['k'], generator=gen,
                    dtype=torch.float64)
    f = None if 'f' in case else tfilters.setup_filter(F2D).double()
    kw = dict(up=case.get('up', 2), down=case['down'],
              padding=case['padding'], flip_weight=case['flip_weight'])
    tconv.reset()
    out = tconv.conv2d_resample(x, w, f=f, **kw)
    assert dict(tconv.LOWERINGS) == {'up_phases': 1}
    ref = _zero_stuffed_up(x, w, f, **kw)
    assert out.shape == ref.shape
    scale = ref.abs().max().item()
    assert (out - ref).abs().max().item() <= 1e-5 * scale


def test_conv2d_resample_up_gradgradcheck():
    """Orders 1 and 2 of the up path (path-length regularization's double
    backward), float64, against finite differences."""
    gen = torch.Generator().manual_seed(12)
    x = torch.randn(1, 3, 4, 2, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(3, 2, 3, 3, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    f = tfilters.setup_filter(F2D).double()

    def up(x, w):
        return tconv.conv2d_resample(x, w, f=f, up=2, padding=1,
                                     flip_weight=False)

    assert torch.autograd.gradcheck(up, (x, w))
    assert torch.autograd.gradgradcheck(up, (x, w))


@pytest.mark.parametrize('up,demodulate', [(1, True), (2, True), (1, False)])
def test_modulated_conv2d_matches_jax(up, demodulate):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 4, 8).astype(np.float32)
    w = rng.randn(3, 3, 8, 6).astype(np.float32)
    styles = (rng.rand(2, 8) + 0.5).astype(np.float32)
    noise = rng.randn(1, 6 * up, 4 * up, 1).astype(np.float32) * 0.3
    jf, tf = _filters(F2D)
    ref = jmod.modulated_conv2d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(styles), noise=jnp.asarray(noise),
                                up=up, padding=1, resample_filter=jf,
                                demodulate=demodulate, flip_weight=(up == 1))
    out = tmod.modulated_conv2d(_t(x), _t(w.transpose(3, 2, 0, 1)), _t(styles),
                                noise=_t(noise), up=up, padding=1,
                                resample_filter=tf, demodulate=demodulate,
                                flip_weight=(up == 1))
    _close(out, ref, atol=ATOL_CONV)


# ---------------------------------------------------------------------------
# translate_sample and alpha_composite
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('pad_value', [-1.0, 0.0])
def test_translate_sample_matches_jax(pad_value):
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (4, 10, 12, 4)).astype(np.float32)
    t = rng.uniform(-0.9, 0.9, (4, 2)).astype(np.float32)
    t[0] = 0.0
    ref = jgs.translate_sample(jnp.asarray(x), jnp.asarray(t),
                               pad_value=pad_value)
    _close(tgs.translate_sample(_t(x), _t(t), pad_value=pad_value), ref)
    _close(tgs.translate_to_theta(_t(t)), jgs.translate_to_theta(jnp.asarray(t)))


def test_alpha_composite_matches_jax():
    rng = np.random.RandomState(6)
    layers = rng.rand(2, 4, 6, 5, 4).astype(np.float32)
    layers[:, 1, ..., 3] = 0.0                 # a fully transparent layer
    layers[0, :, :2, :2, 3] = 0.0              # pixels transparent in all layers
    ref = jcomp.alpha_composite(jnp.asarray(layers))
    out = tcomp.alpha_composite(_t(layers))
    _close(out, ref)
    assert np.all(out[0, :2, :2].numpy() == 0.0)   # 0/0 → 0


def test_translate_and_composite_matches_jax():
    rng = np.random.RandomState(7)
    layers = rng.uniform(-1, 1, (2, 3, 8, 8, 4)).astype(np.float32)
    t = rng.uniform(-0.5, 0.5, (2, 3, 2)).astype(np.float32)
    ref = jcomp.translate_and_composite(jnp.asarray(layers), jnp.asarray(t),
                                        pad_value=-1.0, input_range='minus11')
    out = tcomp.translate_and_composite(_t(layers), _t(t), pad_value=-1.0,
                                        input_range='minus11')
    _close(out, ref)
