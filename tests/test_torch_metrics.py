"""The port's metrics path on the CPU, held to the JAX package on the same
inputs: the detectors (InceptionV3, VGG16-LPIPS, the random pyramid), the
statistics (FID, KID, IS, PR) and their float64 sums, the preprocessing,
PPL's machinery and distances, a FID through both packages' feature loops
on a micro ensemble, and the CLIs (``calc_metrics``, ``check_weights``,
``train_aio --metrics``, ``python -m montage_gan_tpu_torch``).

The detectors get the JAX package's seeded ``init_random`` parameters
through its ``.npz`` files (one file serves both packages); the random
pyramid gets the JAX ``RandomFeatures``' weights through
``utils/weights.py::random_features_from_jax``.  Where a test needs only a
distribution metric's machinery, the random pyramid projects to 64
features instead of 2048 (``scipy.linalg.sqrtm`` of a 2048² matrix takes
many seconds on a CPU).  Each test states its tolerance.
"""

import functools
import hashlib
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from montage_gan_tpu.data.dataset import DatasetAIO as JaxDataset
from montage_gan_tpu.data.synthetic import \
    make_synthetic_layer_dataset as jax_make_dataset
from montage_gan_tpu.metrics import features as jfeat
from montage_gan_tpu.metrics import frechet_inception_distance as jfid
from montage_gan_tpu.metrics import inception_net as jinc
from montage_gan_tpu.metrics import inception_score as jis
from montage_gan_tpu.metrics import kernel_inception_distance as jkid
from montage_gan_tpu.metrics import metric_main as jmain
from montage_gan_tpu.metrics import metric_utils as jutils
from montage_gan_tpu.metrics import perceptual_path_length as jppl
from montage_gan_tpu.metrics import precision_recall as jpr
from montage_gan_tpu.metrics import vgg16_net as jvgg
from montage_gan_tpu.models.ensemble import MontageConfig as JaxConfig
from montage_gan_tpu.models.ensemble import MontageEnsemble as JaxEnsemble
from montage_gan_tpu.ops.composite import alpha_composite as jax_composite
from montage_gan_tpu.utils import convert_inception as jconv_inc
from montage_gan_tpu.utils import convert_vgg16 as jconv_vgg
from montage_gan_tpu.utils import torch_import
from montage_gan_tpu.utils.image_utils import normalize_zero1 as jzero1
from montage_gan_tpu_torch import __main__ as port_main
from montage_gan_tpu_torch.cli import calc_metrics, train_aio
from montage_gan_tpu_torch.data.dataset import DatasetAIO
from montage_gan_tpu_torch.metrics import features as tfeat
from montage_gan_tpu_torch.metrics import frechet_inception_distance as tfid
from montage_gan_tpu_torch.metrics import inception_net as tinc
from montage_gan_tpu_torch.metrics import inception_score as tis
from montage_gan_tpu_torch.metrics import kernel_inception_distance as tkid
from montage_gan_tpu_torch.metrics import metric_main as tmain
from montage_gan_tpu_torch.metrics import metric_utils as tutils
from montage_gan_tpu_torch.metrics import perceptual_path_length as tppl
from montage_gan_tpu_torch.metrics import precision_recall as tpr
from montage_gan_tpu_torch.metrics import vgg16_net as tvgg
from montage_gan_tpu_torch.models.ensemble import MontageConfig, MontageEnsemble
from montage_gan_tpu_torch.training import loop_aio
from montage_gan_tpu_torch.utils import checkpoint as tckpt
from montage_gan_tpu_torch.utils import image_utils as timg
from montage_gan_tpu_torch.utils.weights import random_features_from_jax

from test_metrics_inception import make_random_state_dict
from test_torch_train import FAST_COMPILE

torch.set_num_threads(1)

SMALL_DIM = 64
# test_torch_global.py's micro config: two layers, the STN, a tanh renderer
MICRO_GLOBAL = dict(layer_names=('a', 'b'), layer_targets=((8, 8), (8, 4)),
                    base_resolution=8, img_channels=4, conv_config_index=2,
                    z_dim=16, w_dim=16, mapping_num_layers=2, channel_base=64,
                    channel_max=16, num_fp16_res=0, conv_clamp=256,
                    mbstd_group_size=2, train_global=True,
                    renderer_type='tanh', stn_stages=1)


@pytest.fixture(scope='module')
def detector_npz(tmp_path_factory):
    """The JAX package's seeded InceptionV3 and VGG16 parameters written as
    its ``.npz`` files: (params, path) of each."""
    d = tmp_path_factory.mktemp('detectors')
    inc, vgg = jinc.init_random(0), jvgg.init_random(0)
    # LPIPS heads that weigh channels unequally
    rng = np.random.RandomState(1)
    for i, c in enumerate(jvgg.TAP_CHANNELS):
        vgg[f'lin{i}'] = rng.uniform(0, 2.0 / c, c).astype(np.float32)
    jinc.save_params(inc, str(d / 'inception.npz'))
    jvgg.save_params(vgg, str(d / 'vgg16.npz'))
    return dict(inception=(inc, str(d / 'inception.npz')),
                vgg16=(vgg, str(d / 'vgg16.npz')))


@functools.lru_cache(maxsize=None)
def jax_random_features(dim=SMALL_DIM):
    """The JAX ``RandomFeatures`` projecting to ``dim``, its weights built."""
    ex = jfeat.RandomFeatures()
    ex.feature_dim = dim
    ex(np.zeros((1, 8, 8, 3), np.float32))
    return ex


def port_random_features(dim=SMALL_DIM):
    return random_features_from_jax(jax_random_features(dim)._params,
                                    device='cpu')


def _images(shape, seed=0):
    return np.random.RandomState(seed).uniform(0, 255, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# The detectors
# ---------------------------------------------------------------------------

# InceptionV3 at 299 (no resize), through the resize from 64 (bilinear up)
# and from 320x256 (both axes shrink: the antialiased triangle filter).
# Features within 2e-6 of the largest JAX feature (float32 convolutions in
# another order; the resize's own differences are below, at most 3.4e-3 on
# the [0, 255] scale where an axis shrinks).
@pytest.mark.parametrize('shape', [(2, 299, 299, 3), (2, 64, 64, 3),
                                   (1, 320, 256, 3)])
def test_inception_features_match_jax(shape, detector_npz):
    params, path = detector_npz['inception']
    x = _images(shape)
    ref = np.asarray(jax.jit(jinc.apply)(params, x))
    port = tfeat.InceptionV3Features(path, device='cpu')
    out = port(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (shape[0], 2048)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())


# jax.image.resize(..., 'bilinear') on the [0, 255] scale: where no axis
# shrinks within 1e-4 (the same taps in another order); where one shrinks
# within 5e-3 (PyTorch's antialiased filter computes its weights otherwise);
# mixed directions resize one axis at a time.
@pytest.mark.parametrize('hw', [(256, 256), (64, 64), (256, 128),
                                (299, 200), (320, 320), (512, 512),
                                (320, 200), (320, 299), (200, 320)])
def test_inception_resize_matches_jax(hw):
    x = _images((1, *hw, 3), seed=2)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3),
                                      'bilinear'))
    out = tinc.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2),
                               (299, 299)).permute(0, 2, 3, 1).numpy()
    shrinks = hw[0] > 299 or hw[1] > 299
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=5e-3 if shrinks else 1e-4)


def test_lpips_features_match_jax(detector_npz):
    """VGG16-LPIPS features at [2, 64, 64, 3], in the JAX package's NHWC
    order: within 1e-5 of the largest feature; the LPIPS distance within
    rtol 1e-5; the raw relu5_3 map within 1e-5 of its largest entry."""
    params, path = detector_npz['vgg16']
    x = _images((2, 64, 64, 3), seed=3)
    ref = np.asarray(jax.jit(jvgg.apply)(params, x))
    port = tfeat.VGG16Features(path, device='cpu')
    out = port(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, tvgg.feature_dim(64, 64))
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(((out[0] - out[1]) ** 2).sum(),
                               ((ref[0] - ref[1]) ** 2).sum(), rtol=1e-5)
    raw = port.net(torch.from_numpy(x), return_lpips=False).numpy()
    raw_ref = np.asarray(jvgg.apply(params, x, return_lpips=False))
    np.testing.assert_allclose(raw, raw_ref, rtol=0,
                               atol=1e-5 * np.abs(raw_ref).max())


# The random pyramid with the JAX weights: 'SAME' padding at stride 2 is
# (0, 1) for an even size and (1, 1) for an odd one; within 1e-5 of the
# largest feature.
@pytest.mark.parametrize('hw', [(32, 32), (33, 21)])
def test_random_features_match_jax(hw):
    x = _images((2, *hw, 3), seed=4)
    jex = jax_random_features()
    ref = np.asarray(jex(x))
    out = random_features_from_jax(jex._params, device='cpu')(
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_random_features_are_the_ports_own():
    """The port's seeded pyramid: deterministic, named apart from the JAX
    package's, on an explicit device; without a card 'cuda' raises."""
    a = tfeat.build_extractor('random', device='cpu')
    b = tfeat.RandomFeatures(device='cpu')
    x = torch.from_numpy(_images((2, 16, 16, 3)))
    assert torch.equal(a(x), b(x)) and a(x).shape == (2, 2048)
    assert a.name == 'random2048_torch' != jfeat.RandomFeatures.name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tfeat.RandomFeatures()


def test_build_extractor_resolves_the_dropin_dir(detector_npz, tmp_path,
                                                 monkeypatch):
    """The env vars first, then ``MGT_WEIGHTS_DIR``; neither: the random
    pyramid, as in the JAX package."""
    for env in ('MGT_INCEPTION_WEIGHTS', 'MGT_VGG16_WEIGHTS'):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv('MGT_WEIGHTS_DIR', str(tmp_path))
    assert isinstance(tfeat.build_extractor('auto', device='cpu'),
                      tfeat.RandomFeatures)
    assert isinstance(tfeat.build_extractor('auto_lpips', device='cpu'),
                      tfeat.RandomFeatures)
    monkeypatch.setenv('MGT_WEIGHTS_DIR',
                       os.path.dirname(detector_npz['inception'][1]))
    assert isinstance(tfeat.build_extractor('auto', device='cpu'),
                      tfeat.InceptionV3Features)
    assert isinstance(tfeat.build_extractor('auto_lpips', device='cpu'),
                      tfeat.VGG16Features)
    assert tfeat.resolve_weights('MGT_VGG16_WEIGHTS', 'vgg16.npz') == \
        jfeat.resolve_weights('MGT_VGG16_WEIGHTS', 'vgg16.npz')
    with pytest.raises(ValueError):
        tfeat.build_extractor('nope', device='cpu')


# ---------------------------------------------------------------------------
# The statistics, from the same feature arrays (float64, to 1e-10)
# ---------------------------------------------------------------------------

def _features(n_real=120, n_gen=100, dim=16, seed=5):
    rng = np.random.RandomState(seed)
    real = rng.randn(n_real, dim)
    gen = rng.randn(n_gen, dim) * 1.1 + 0.2
    return real, gen


def test_fid_matches_jax():
    real, gen = _features()
    stats = [(a.mean(0), np.cov(a, rowvar=False)) for a in (real, gen)]
    got = tfid.compute_fid_from_stats(*stats[0], *stats[1])
    ref = jfid.compute_fid_from_stats(*stats[0], *stats[1])
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0)


def test_kid_matches_jax():
    """KID on the device's float64 sums, the same subsets."""
    real, gen = _features()
    kw = dict(num_subsets=10, max_subset_size=50, seed=3)
    ref = jkid.compute_kid_from_features(real, gen, **kw)
    got = tkid.compute_kid_torch(torch.from_numpy(real),
                                 torch.from_numpy(gen), **kw)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-14)


def test_is_matches_jax():
    _, gen = _features()
    probs = tis.softmax_np(gen.astype(np.float32))
    e = np.exp(gen - gen.max(1, keepdims=True))
    ref_probs = e / e.sum(1, keepdims=True)
    np.testing.assert_allclose(tis.softmax_np(gen), ref_probs, rtol=1e-12)
    got = tis.compute_is_from_probs(probs, 10)
    ref = jis.compute_is_from_probs(probs, 10)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0)


@pytest.mark.parametrize('nhood', [1, 3])
def test_pr_matches_jax(nhood, monkeypatch):
    """Precision and recall on the device, blocks of rows (here 32), equal
    to the JAX package's numpy path on the same float64 features."""
    monkeypatch.setattr(tpr, 'BLOCK_ROWS', 32)
    real, gen = _features()
    ref = jpr.compute_pr_from_features(real, gen, nhood_size=nhood)
    got = tpr.compute_pr_torch(torch.from_numpy(real), torch.from_numpy(gen),
                               nhood)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0)
    assert 0 < ref[0] < 1 and 0 < ref[1] < 1


def test_feature_stats_match_jax(tmp_path):
    """Mean and covariance from the float64 sums (within 1e-12 of the
    largest entry), ``max_items`` cutting the last append, ``capture_all``,
    and the pickle: the port reads the JAX package's and writes its
    layout."""
    rng = np.random.RandomState(6)
    batches = [rng.randn(8, 12).astype(np.float32) * 3 + 1 for _ in range(4)]
    kw = dict(capture_all=True, capture_mean_cov=True, max_items=27)
    ours, ref = tutils.FeatureStats(**kw), jutils.FeatureStats(**kw)
    for b in batches:
        ours.append(torch.from_numpy(b))
        ref.append(b)
    assert ours.num_items == ref.num_items == 27 and ours.is_full()
    np.testing.assert_array_equal(ours.get_all(), ref.get_all())
    for a, b in zip(ours.get_mean_cov(), ref.get_mean_cov()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * np.abs(b).max())
    ref.save(str(tmp_path / 'jax.pkl'))
    ours.save(str(tmp_path / 'port.pkl'))
    for path in ('jax.pkl', 'port.pkl'):
        back = tutils.FeatureStats.load(str(tmp_path / path))
        assert back.num_items == 27 and back.max_items == 27
        np.testing.assert_array_equal(back.get_all(), ref.get_all())
        for a, b in zip(back.get_mean_cov(), ref.get_mean_cov()):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-12 * np.abs(b).max())
    back = jutils.FeatureStats.load(str(tmp_path / 'port.pkl'))
    np.testing.assert_array_equal(back.get_all(), ref.get_all())


# ---------------------------------------------------------------------------
# Preprocessing
# ---------------------------------------------------------------------------

def test_metric_rgb_matches_jax():
    """Layered and RGBA inputs to RGB in [0, 255]: the device version (the
    closed-form composite) within 1e-4 of the JAX package's (the
    recurrence); ``blend_white_bg`` against the JAX one within 1e-6."""
    rng = np.random.RandomState(7)
    layers = rng.uniform(0, 1, (2, 3, 8, 6, 4)).astype(np.float32)
    layers[:, :, :2, :, 3] = 0.0                       # transparent rows
    rgba = rng.uniform(0, 1, (2, 8, 6, 4)).astype(np.float32)
    rgb = rng.uniform(0, 1, (2, 8, 6, 3)).astype(np.float32)
    grey = rng.uniform(0, 1, (2, 8, 6, 1)).astype(np.float32)
    ref = jutils.layers_to_metric_rgb(layers)
    np.testing.assert_allclose(
        tutils.layers_to_metric_rgb(torch.from_numpy(layers)).numpy(), ref,
        rtol=0, atol=1e-4)
    for x in (rgba, rgb, grey):
        ref = jutils.images_to_metric_rgb(x)
        np.testing.assert_allclose(
            tutils.images_to_metric_rgb(torch.from_numpy(x)).numpy(), ref,
            rtol=0, atol=1e-4)
    from montage_gan_tpu.utils.image_utils import blend_white_bg
    np.testing.assert_allclose(
        timg.blend_white_bg(torch.from_numpy(rgba)).numpy(),
        np.asarray(blend_white_bg(jnp.asarray(rgba))), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# PPL
# ---------------------------------------------------------------------------

def test_ppl_machinery_matches_jax():
    """lerp, the crop and the percentile filter exactly; slerp within 2e-7
    (its norms sum in another order)."""
    rng = np.random.RandomState(8)
    a, b = (rng.randn(6, 32).astype(np.float32) for _ in range(2))
    t = rng.uniform(0, 1, (6, 1)).astype(np.float32)
    np.testing.assert_allclose(
        tppl.slerp(torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(t)).numpy(),
        np.asarray(jppl.slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t))),
        rtol=0, atol=2e-7)
    w0, w1 = (rng.randn(6, 3, 8).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(
        tppl.lerp(torch.from_numpy(w0), torch.from_numpy(w1),
                  torch.from_numpy(t)).numpy(),
        np.asarray(jppl._lerp_tree(jnp.asarray(w0), jnp.asarray(w1),
                                   jnp.asarray(t))))
    img = rng.rand(2, 64, 48, 4).astype(np.float32)
    np.testing.assert_array_equal(tppl.crop(torch.from_numpy(img)).numpy(),
                                  np.asarray(jppl._crop(jnp.asarray(img))))
    dist = rng.lognormal(size=257).astype(np.float32)
    lo = np.percentile(dist, 1, method='lower')
    hi = np.percentile(dist, 99, method='higher')
    assert tppl.filtered_mean(dist) == float(
        np.extract((dist >= lo) & (dist <= hi), dist).mean())


def _stn_variables(sd):
    """The port's STN state dict as the JAX STN's variables (the inverse of
    ``utils/weights.py::stn_state_dict``, for any number of stages)."""
    ti = torch_import
    convs = sorted({int(k.split('.')[1]) for k in sd
                    if k.startswith('localization.')})
    params = {f'Conv_{i}': {'kernel': ti.conv_w(sd[f'localization.{c}.weight']),
                            'bias': ti._np(sd[f'localization.{c}.bias'])}
              for i, c in enumerate(convs)}
    w0 = ti._np(sd['fc_loc.0.weight'])            # C-major input → HWC-major
    c_last = sd[f'localization.{convs[-1]}.weight'].shape[0]
    side = int(round((w0.shape[1] // c_last) ** 0.5))
    w0 = w0.reshape(-1, c_last, side, side).transpose(0, 2, 3, 1)
    params['Dense_0'] = {'kernel': w0.reshape(w0.shape[0], -1).T,
                         'bias': ti._np(sd['fc_loc.0.bias'])}
    params['Dense_1'] = {'kernel': ti.linear_w(sd['fc_loc.2.weight']),
                         'bias': ti._np(sd['fc_loc.2.bias'])}
    return {'params': params}


@functools.lru_cache(maxsize=None)
def micro_models():
    """The micro ensemble with seeded weights (the zero-initialised terms
    made random) in the port, and the same weights as the JAX ensemble's
    variables through the JAX package's ``utils/torch_import.py`` (no JAX
    init to compile): (port model, JAX config, JAX ensemble, variables)."""
    model = MontageEnsemble(MontageConfig(**MICRO_GLOBAL)).init_weights(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(('bias', 'noise_strength')) or \
                    name.startswith('stn.fc_loc.2'):
                p.add_(torch.randn(p.shape, generator=torch.Generator()
                                   .manual_seed(len(name))) * 0.1)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}
    cfg = JaxConfig(**MICRO_GLOBAL)
    variables = {
        'mapping': torch_import.mapping_params_from_torch(sub('mapping.')),
        'local_g': tuple(torch_import.synthesis_params_from_torch(
            sub(f'local_g.{i}.')) for i in range(cfg.num_layers)),
        'stn': _stn_variables(sub('stn.')),
        'renderer': torch_import.renderer_params_from_torch(
            sub('renderer.'))}
    return model.eval(), cfg, JaxEnsemble(cfg), variables


@pytest.fixture(scope='module')
def micro_pair():
    """The JAX micro ensemble's jitted metric functions and the port's,
    with the same weights."""
    model, cfg, ens, variables = micro_models()

    def composite(placed):
        return jax_composite(jzero1(jnp.clip(placed, -1, 1)))
    jit = functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    jax_fns = dict(
        sample_fn=jit(lambda z: composite(ens.run_global_g(
            variables, z, noise_mode='const')[0])),
        map_fn=jit(lambda z: ens.mapping.apply(variables['mapping'], z)),
        synth_fn=jit(lambda ws: composite(ens.run_global_g_from_ws(
            variables, ws, noise_mode='const')[0])))
    port_fns = dict(zip(('sample_fn', 'map_fn', 'synth_fn'),
                        tutils.ensemble_fns(model)))
    return cfg, jax_fns, port_fns


def _jax_ppl_draws(seed, batch, z_dim, num_batches, sampling):
    """The (z0, z1, t) of each batch of JAX's ``compute_ppl``."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(num_batches):
        key, k0, k1, kt = jax.random.split(key, 4)
        t = (jax.random.uniform(kt, (batch, 1)) if sampling == 'full'
             else jnp.zeros((batch, 1)))
        out.append(tuple(np.array(a) for a in (
            jax.random.normal(k0, (batch, z_dim)),
            jax.random.normal(k1, (batch, z_dim)), t)))
    return out


# PPL on the micro ensemble with the JAX package's draws: w-space endpoint
# (ppl2_wend) and z-space full with the crop.  The distances divide by
# eps^2 = 1e-8, so float32 differences of ~1e-7 between the two packages'
# images (test_torch_global holds the ensembles within 1e-5) become
# differences of a few per cent in a distance, more in a small one: each
# distance is held within 2e-2 of the largest, the filtered means within
# rtol 5e-2.
@pytest.mark.parametrize('space,sampling,crop', [('w', 'end', False),
                                                 ('z', 'full', True)])
def test_ppl_with_injected_draws_matches_jax(space, sampling, crop,
                                             micro_pair):
    cfg, jax_fns, port_fns = micro_pair
    batch, n = 4, 12
    draws = _jax_ppl_draws(0, batch, cfg.z_dim, 3, sampling)
    jex = jax_random_features()
    seen = []                       # the JAX distances, as the filter sees them
    extract = np.extract

    def spy(cond, arr):
        seen.append(np.array(arr))
        return extract(cond, arr)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jppl.np, 'extract', spy)
        ref = jppl.compute_ppl(None, cfg.z_dim, jex, num_samples=n,
                               space=space, sampling=sampling, crop=crop,
                               batch_size=batch, seed=0,
                               map_fn=jax_fns['map_fn'],
                               synth_fn=jax_fns['synth_fn'])
    kw = dict(num_samples=n, space=space, sampling=sampling, batch_size=batch,
              device='cpu', map_fn=port_fns['map_fn'],
              synth_fn=port_fns['synth_fn'], draw_fn=lambda k, m: draws[k])
    ex = port_random_features()
    dists = tppl.compute_ppl_distances(None, cfg.z_dim, ex, crop_images=crop,
                                       **kw)
    got = tppl.compute_ppl(None, cfg.z_dim, ex, crop=crop, **kw)
    assert np.isfinite(got) and got > 0
    assert got == tppl.filtered_mean(dists)
    np.testing.assert_allclose(dists, seen[0], rtol=0,
                               atol=2e-2 * seen[0].max())
    np.testing.assert_allclose(got, ref, rtol=5e-2)


# ---------------------------------------------------------------------------
# FID through both packages' feature loops
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def tiny_dataset(tmp_path_factory):
    """tests/test_train_aio_cli.py's dataset (written by PIL)."""
    path = str(tmp_path_factory.mktemp('ds') / 'layers')
    spec = (('#1_a', (8, 7), (5, 6)), ('#2_b', (8, 10), (6, 4)))
    jax_make_dataset(path, num_samples=8, size=32, spec=spec)
    return path


def _jax_z(seed, batch, z_dim, num_batches):
    """The z of each batch of JAX's generator loop."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(num_batches):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(sub, (batch, z_dim))))
    return out


def test_fid_loops_match_jax(micro_pair, tiny_dataset, tmp_path):
    """A FID of 36 generated images (batches of 8, the last cut) against
    the 8 dataset samples (batches of 3, the last ragged), with the JAX
    loop's z: the dataset's and the generator's statistics within 1e-4 of
    their largest entry (float32 images and features in another order; the
    dataset's layers composited in closed form on the device, by the
    recurrence in the JAX package), the FID within rtol 1e-3; a second call
    reads the dataset's cache."""
    cfg, jax_fns, port_fns = micro_pair
    num_gen, batch = 36, 8
    zs = _jax_z(1, batch, cfg.z_dim, 5)
    jopts = jmain.MetricOptions(dataset=JaxDataset(tiny_dataset),
                                sample_fn=jax_fns['sample_fn'],
                                z_dim=cfg.z_dim,
                                extractor=jax_random_features(),
                                batch_size=batch, seed=1)
    kw = dict(dataset=DatasetAIO(tiny_dataset),
              sample_fn=port_fns['sample_fn'], z_dim=cfg.z_dim,
              extractor=port_random_features(), batch_size=batch, seed=1,
              device='cpu', draw_fn=lambda k, n: zs[k],
              cache_dir=str(tmp_path / 'cache'))
    opts = tmain.MetricOptions(**kw)
    for kind, (ours, ref) in dict(
            dataset=(tutils.compute_feature_stats_for_dataset(
                         opts.dataset, opts.extractor, batch_size=3,
                         device='cpu', capture_mean_cov=True),
                     jutils.compute_feature_stats_for_dataset(
                         jopts.dataset, jopts.extractor, batch_size=3,
                         capture_mean_cov=True)),
            generator=(tutils.compute_feature_stats_for_generator(
                           opts.sample_fn, cfg.z_dim, opts.extractor,
                           num_gen, batch_size=batch, device='cpu',
                           draw_fn=opts.draw_fn, capture_mean_cov=True),
                       jutils.compute_feature_stats_for_generator(
                           jopts.sample_fn, cfg.z_dim, jopts.extractor,
                           num_gen, batch_size=batch, seed=1,
                           capture_mean_cov=True))).items():
        assert ours.num_items == ref.num_items, kind
        for a, b in zip(ours.get_mean_cov(), ref.get_mean_cov()):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-4 * np.abs(b).max(),
                                       err_msg=kind)
    ref = jfid.compute_fid(jopts, max_real=None, num_gen=num_gen)
    got = tfid.compute_fid(opts, max_real=None, num_gen=num_gen)
    np.testing.assert_allclose(got, ref, rtol=1e-3)
    assert len(os.listdir(tmp_path / 'cache')) == 1
    assert tfid.compute_fid(opts, max_real=None, num_gen=num_gen) == got
    # the draws default to the port's own generator, seeded per batch
    z = tutils.generator_draws(1, 3, batch, cfg.z_dim)
    assert torch.equal(z, tutils.generator_draws(1, 3, batch, cfg.z_dim))
    assert not torch.equal(z, tutils.generator_draws(1, 4, batch, cfg.z_dim))


def test_registry_matches_jax():
    """The 13 metric names; an unknown one raises with the valid list; a
    w-space PPL without the mapping split raises."""
    assert tmain.list_valid_metrics() == jmain.list_valid_metrics()
    assert len(tmain.list_valid_metrics()) == 13
    with pytest.raises(ValueError, match='valid: fid50k_full'):
        tmain.check_metrics(['fid2k', 'fid3k'])
    with pytest.raises(ValueError, match='mapping/synthesis'):
        tmain.calc_metric('ppl2_wend', dataset=None, sample_fn=lambda z: z,
                          z_dim=4, extractor=port_random_features(),
                          device='cpu')


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def _micro_snapshot(path):
    """A port EMA snapshot of the micro ensemble with seeded weights."""
    cfg = MontageConfig(**MICRO_GLOBAL)
    model = MontageEnsemble(cfg).init_weights(0)
    tckpt.save_checkpoint(str(path), cfg, model)
    return str(path), cfg, model


def test_calc_metrics_cli(tiny_dataset, tmp_path):
    """``calc_metrics`` on a port snapshot: the JAX record's keys in
    ``metric-<name>.jsonl`` beside it, the value of ``calc_metric`` on the
    loaded network; a ``.pkl`` that is not there raises; an unknown
    metric raises with the valid names; the card is the default."""
    snap, cfg, model = _micro_snapshot(tmp_path / 'ema-snapshot-000000.pt')
    argv = ['--network', snap, '--data', tiny_dataset, '--metrics',
            'ppl2_wend', '--ppl-samples', '16', '--extractor', 'random',
            '--batch', '8', '--cache-dir', str(tmp_path / 'cache')]
    results = calc_metrics.main([*argv, '--device', 'cpu'])
    with open(tmp_path / 'metric-ppl2_wend.jsonl') as f:
        record = json.loads(f.readline())
    assert set(record) == {'results', 'metric', 'total_time', 'num_gpus',
                           'snapshot_pkl', 'timestamp'}
    assert record['metric'] == 'ppl2_wend' and record['num_gpus'] == 1
    assert record['snapshot_pkl'] == snap
    sample_fn, map_fn, synth_fn = tutils.ensemble_fns(model.eval())
    direct = tmain.calc_metric(
        'ppl2_wend', z_dim=cfg.z_dim, sample_fn=sample_fn, map_fn=map_fn,
        synth_fn=synth_fn, ppl_samples=16, batch_size=8, device='cpu',
        extractor=tfeat.build_extractor('random', device='cpu'))
    assert record['results'] == dict(direct.results) == \
        dict(results[0].results)
    with pytest.raises(FileNotFoundError, match='net.pkl'):
        calc_metrics.main(['--network', str(tmp_path / 'net.pkl'), '--data',
                           tiny_dataset, '--device', 'cpu'])
    with pytest.raises(ValueError, match='valid'):
        calc_metrics.main([*argv[:5], 'fid2', '--device', 'cpu'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            calc_metrics.main(argv)


def test_calc_metrics_reads_a_jax_snapshot(micro_pair, tiny_dataset,
                                           tmp_path):
    """``--network`` takes a JAX EMA snapshot (``.msgpack`` with its
    ``.json``): the same result as the port's ensemble with those weights,
    exactly (the same computation)."""
    from montage_gan_tpu.utils.checkpoint import save_ema_snapshot
    model, cfg, _, variables = micro_models()
    base = str(tmp_path / 'ema-snapshot-000000')
    save_ema_snapshot(base, cfg, {k: variables[k] for k in
                                  ('mapping', 'local_g', 'stn')},
                      variables['renderer'])
    results = calc_metrics.main([
        '--network', base + '.msgpack', '--data', tiny_dataset, '--metrics',
        'ppl2_wend', '--ppl-samples', '8', '--extractor', 'random',
        '--batch', '4', '--device', 'cpu'])
    fns = tutils.ensemble_fns(model)
    direct = tmain.calc_metric(
        'ppl2_wend', z_dim=cfg.z_dim, ppl_samples=8, batch_size=4,
        device='cpu', extractor=tfeat.build_extractor('random', device='cpu'),
        **dict(zip(('sample_fn', 'map_fn', 'synth_fn'), fns)))
    assert dict(results[0].results) == dict(direct.results)
    assert os.path.exists(tmp_path / 'metric-ppl2_wend.jsonl')


def test_converters_write_the_jax_files(tmp_path):
    """The port's VGG16 converter writes the JAX converter's ``.npz`` from
    the same torch checkpoint (the InceptionV3 converter:
    ``test_check_weights_dropin_sha256_gate``)."""
    from montage_gan_tpu_torch.utils import convert_vgg16
    vsd = {f'features.{k}': v for k, v in _vgg_state_dict().items()}
    torch.save(vsd, str(tmp_path / 'vgg16.pth'))
    convert_vgg16.main([str(tmp_path / 'vgg16.pth'),
                        str(tmp_path / 'vport.npz')])
    jconv_vgg.main([str(tmp_path / 'vgg16.pth'), str(tmp_path / 'vjax.npz')])
    with np.load(tmp_path / 'vport.npz') as x, \
            np.load(tmp_path / 'vjax.npz') as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k])


def _vgg_state_dict():
    """A torchvision-layout ``vgg16().features`` state dict, seeded."""
    rng = np.random.RandomState(9)
    sd, idx, cin = {}, 0, 3
    for name, cout in tvgg.CONFIG:
        if name.startswith('pool'):
            idx += 1
            continue
        sd[f'{idx}.weight'] = torch.from_numpy(
            rng.randn(cout, cin, 3, 3).astype(np.float32) * 0.05)
        sd[f'{idx}.bias'] = torch.from_numpy(
            rng.randn(cout).astype(np.float32) * 0.1)
        idx, cin = idx + 2, cout
    return sd


def _check_weights(argv, capsys):
    """(exit code, printed text) of the port's check-weights."""
    try:
        port_main.main(['check-weights', *argv])
        code = 0
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def test_check_weights_cli(detector_npz, tmp_path, monkeypatch, capsys):
    """Missing (rc 1, the converters' one-liners, the drop-in path), present
    (rc 0; ``--smoke`` runs one image through each on the CPU), broken (a
    file that does not load), through ``python -m montage_gan_tpu_torch``."""
    for env in ('MGT_INCEPTION_WEIGHTS', 'MGT_VGG16_WEIGHTS'):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv('MGT_WEIGHTS_DIR', str(tmp_path / 'dropin'))
    code, out = _check_weights([], capsys)
    assert code == 1 and 'RELATIVE' in out
    assert 'montage_gan_tpu_torch.utils.convert_inception' in out
    assert 'montage_gan_tpu_torch.utils.convert_vgg16' in out
    assert str(tmp_path / 'dropin') in out
    monkeypatch.setenv('MGT_INCEPTION_WEIGHTS', detector_npz['inception'][1])
    monkeypatch.setenv('MGT_VGG16_WEIGHTS', detector_npz['vgg16'][1])
    code, out = _check_weights(['--smoke', '--device', 'cpu'], capsys)
    assert code == 0 and 'ABSOLUTE' in out, out
    assert 'feature shape (1, 2048)' in out
    assert f'feature shape (1, {tvgg.feature_dim(64, 64)})' in out
    assert '21.8M parameters' in out            # InceptionV3's, BN folded
    broken = tmp_path / 'broken.npz'
    broken.write_bytes(b'not an npz')
    monkeypatch.setenv('MGT_VGG16_WEIGHTS', str(broken))
    code, out = _check_weights([], capsys)
    assert code == 1 and 'BROKEN' in out


def test_check_weights_dropin_sha256_gate(tmp_path, monkeypatch, capsys):
    """A torch source whose name's digest its sha256 does not match is
    flagged and not converted; a verified one converts with ``--convert``
    to the ``.npz`` the JAX converter writes, found with no env var."""
    dropin = tmp_path / 'dropin'
    dropin.mkdir()
    for env in ('MGT_INCEPTION_WEIGHTS', 'MGT_VGG16_WEIGHTS'):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv('MGT_WEIGHTS_DIR', str(dropin))
    bad = dropin / 'pt_inception-2015-12-05-6726825d.pth'
    bad.write_bytes(b'not the official checkpoint')
    code, out = _check_weights(['--convert'], capsys)
    assert code == 1 and 'MISMATCH' in out
    assert not (dropin / 'inception.npz').exists()
    bad.unlink()
    staging = tmp_path / 'staging.bin'
    torch.save(make_random_state_dict(seed=3), str(staging))
    digest = hashlib.sha256(staging.read_bytes()).hexdigest()[:8]
    src = dropin / f'pt_inception-2015-12-05-{digest}.pth'
    staging.rename(src)
    code, out = _check_weights([], capsys)
    assert 'VERIFIED' in out and 'ready to convert' in out
    code, out = _check_weights(['--convert'], capsys)
    assert 'VERIFIED' in out and (dropin / 'inception.npz').exists()
    assert tfeat.resolve_weights('MGT_INCEPTION_WEIGHTS', 'inception.npz') \
        == str(dropin / 'inception.npz')
    jconv_inc.main([str(src), str(tmp_path / 'jax.npz')])
    with np.load(dropin / 'inception.npz') as x, \
            np.load(tmp_path / 'jax.npz') as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k])


def test_main_dispatches_the_ported_commands(capsys):
    """``python -m montage_gan_tpu_torch <command>``: the JAX package's
    names; every one is ported and reaches its CLI (none waits for a
    ROADMAP item any more)."""
    from montage_gan_tpu.__main__ import cli as jax_cli
    assert set(port_main.PORTED) | set(port_main.WAITING) == \
        set(jax_cli.commands)
    assert not set(port_main.PORTED) & set(port_main.WAITING)
    # checkpoint interop, stage 0 and the single-GAN path are ported
    assert {'convert-pickle', 'export-torch', 'pretrain-renderer',
            'pretrain-stn', 'train', 'run-recipe',
            'dataset-tool'} <= set(port_main.PORTED)
    assert not port_main.WAITING
    with open(os.path.join(os.path.dirname(__file__), '..',
                           'ROADMAP.md')) as f:
        roadmap = f.read()
    for command, item in port_main.WAITING.items():
        with pytest.raises(NotImplementedError, match=item):
            port_main.main([command])
        # the ROADMAP item names the JAX CLI
        assert f"cli/{command.replace('-', '_')}.py" in roadmap, command
    with pytest.raises(SystemExit, match='unknown command'):
        port_main.main(['nope'])
    port_main.main(['--help'])
    assert 'calc-metrics' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        port_main.main(['train-aio', '--help'])


def test_train_aio_metrics_option(tiny_dataset, tmp_path):
    """``--metrics a,b`` reaches the loop as a list; an unknown name raises
    with the valid ones; ``none`` is no metric."""
    base = ['--outdir', str(tmp_path), '--data', tiny_dataset, '--device',
            'cpu']
    kw = train_aio.setup_training_loop_kwargs(
        train_aio.parse_options([*base, '--metrics', 'fid2k,ppl2_wend']), 1)
    assert kw.metrics == ['fid2k', 'ppl2_wend']
    kw = train_aio.setup_training_loop_kwargs(train_aio.parse_options(base), 1)
    assert kw.metrics == []
    with pytest.raises(ValueError, match='valid: fid50k_full'):
        train_aio.parse_options([*base, '--metrics', 'fid2k,fid7k'])


def test_train_aio_scores_the_snapshot(tiny_dataset, tmp_path, monkeypatch):
    """``train_aio --metrics fid2k`` on the CPU: the EMA ensemble scored at
    the network snapshot, ``metric-fid2k.jsonl`` beside it and
    ``Metrics/fid2k`` in ``stats.jsonl``.  No detector weights: the random
    pyramid, here projecting to 64 features (the sqrtm of 2048² takes many
    seconds); the loop's wiring is what is checked, so the registry's
    ``fid2k`` here generates 64 images, not 2000 (on the card,
    ``chip_smoke.py`` runs the whole budget through this CLI)."""
    def fid2k(opts):
        return {'fid2k': tfid.compute_fid(opts, max_real=None, num_gen=64)}
    monkeypatch.setitem(tmain._metric_dict, 'fid2k', fid2k)
    monkeypatch.setattr(loop_aio, 'make_tensorboard_writer', lambda d: None)
    monkeypatch.setattr(tfeat.RandomFeatures, 'feature_dim', SMALL_DIM)
    for env in ('MGT_INCEPTION_WEIGHTS', 'MGT_VGG16_WEIGHTS'):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv('MGT_WEIGHTS_DIR', str(tmp_path / 'none'))
    outdir = str(tmp_path / 'runs')
    train_aio.main(['--outdir', outdir, '--data', tiny_dataset, '--gpus',
                    '1', '--kimg', '1', '--batch', '4', '--kimg-per-tick',
                    '1', '--snap', '1', '--net-snap', '1', '--cfg', 'auto',
                    '--aug', 'noaug', '--fp32', 'true',
                    '--conv-config-index', '2', '--channel-base', '256',
                    '--channel-max', '32', '--run-once', '--device', 'cpu',
                    '--metrics', 'fid2k'])
    run_dir = os.path.join(outdir, os.listdir(outdir)[0])
    with open(os.path.join(run_dir, 'metric-fid2k.jsonl')) as f:
        record = json.loads(f.readline())
    assert record['snapshot_pkl'].endswith('network-snapshot-000000.pt')
    fid = record['results']['fid2k']
    assert np.isfinite(fid) and fid > 0
    with open(os.path.join(run_dir, 'stats.jsonl')) as f:
        stats = json.loads(f.readline())
    assert stats['Metrics/fid2k']['mean'] == pytest.approx(fid, rel=1e-12)
    assert os.listdir(os.path.join(run_dir, 'metric-cache'))
