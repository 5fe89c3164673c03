"""The port's checkpoint interop against the JAX package's, on the CPU:
reference ``.pkl`` import (persistence pickles and TF1 stubs), ``.pth``
import and export, ``convert-pickle``, ``export-torch``, ``generate`` of a
``.pkl`` with ``--class``, ``train_aio --renderer-import`` and the simple
global Ds.

No reference checkout or checkpoint is used: every reference-format file
is written here from seeded weights.  A persistence pickle is crafted as
the reference's decorator writes one (``tools/seeded.py::
write_persistence_pkl``: a ``torch_utils.persistence.
_reconstruct_persistent_obj`` global whose meta holds the module state);
JAX variables are built from the port's seeded weights through the JAX
package's own ``torch_import`` converters (no JAX ``init_variables`` of an
ensemble).

Tolerances: unpickled, converted and exported state dicts exactly equal,
keys in the same order; generator and renderer outputs (in [-1, 1])
within 1e-4, ws within 1e-5; sampling a model read back from an export
bit for bit.
"""

import functools
import io
import os
import pickle
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from montage_gan_tpu.models.ensemble import MontageConfig as JaxConfig
from montage_gan_tpu.models.renderer import build_renderer as jax_renderer
from montage_gan_tpu.models.simple_d import (
    SimpleGlobalDiscriminator as JaxSimpleD,
    SimpleGlobalDiscriminatorV2 as JaxSimpleDV2)
from montage_gan_tpu.models.stn import STN as JaxSTN
from montage_gan_tpu.utils import pkl_import as jpkl
from montage_gan_tpu.utils import torch_export as jte
from montage_gan_tpu.utils import torch_import as jti
from montage_gan_tpu_torch.cli import convert_pickle, export_torch, generate
from montage_gan_tpu_torch.cli import train_aio
from montage_gan_tpu_torch.models.discriminator import Discriminator
from montage_gan_tpu_torch.models.ensemble import MontageConfig, MontageEnsemble
from montage_gan_tpu_torch.models.renderer import build_renderer
from montage_gan_tpu_torch.models.simple_d import (SimpleGlobalDiscriminator,
                                                  SimpleGlobalDiscriminatorV2)
from montage_gan_tpu_torch.models.stn import STN
from montage_gan_tpu_torch.tools.launches import expected_generator_launches
from montage_gan_tpu_torch.tools.seeded import (seeded_generator,
                                                write_persistence_pkl)
from montage_gan_tpu_torch.utils import checkpoint as tckpt
from montage_gan_tpu_torch.utils import pkl_import as tpkl
from montage_gan_tpu_torch.utils import torch_export as tte
from montage_gan_tpu_torch.utils import torch_import as tti
from montage_gan_tpu_torch.utils.png import read_png_rgba
from montage_gan_tpu_torch.utils.serving import build_inference_fn
from montage_gan_tpu_torch.utils.weights import simple_d_state_dict

from test_torch_grads import emulate_kernels
from test_torch_train import FAST_COMPILE

torch.set_num_threads(1)

G_KW = dict(z_dim=16, w_dim=16, img_resolution=16, img_channels=4,
            mapping_kwargs=dict(num_layers=2),
            synthesis_kwargs=dict(channel_base=256, channel_max=32,
                                  num_fp16_res=0, conv_clamp=256))
MICRO_AIO = dict(layer_names=('a', 'b', 'c'),
                 layer_targets=((32, 32), (32, 32), (16, 8)),
                 base_resolution=32, img_channels=4, conv_config_index=2,
                 z_dim=32, w_dim=32, mapping_num_layers=2, channel_base=512,
                 channel_max=32, num_fp16_res=0, conv_clamp=256,
                 renderer_type='tanh', mbstd_group_size=2, stn_stages=2)


def fast(fn):
    return jax.jit(fn, compiler_options=FAST_COMPILE)


def g_kw(c_dim):
    return dict(G_KW, c_dim=c_dim)


@pytest.fixture(scope='module', params=[0, 4], ids=['uncond', 'c_dim4'])
def pkl(request, tmp_path_factory):
    """A crafted SG2-ADA pickle of a seeded generator (G and G_ema)."""
    kw = g_kw(request.param)
    net = seeded_generator(kw, seed=request.param + 1)
    path = str(tmp_path_factory.mktemp('pkl') / 'net.pkl')
    write_persistence_pkl(path, {'G': net, 'G_ema': net},
                          {'G': kw, 'G_ema': kw},
                          training_set_kwargs={'resolution': 16})
    return path, net, kw


def assert_same_state(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_load_network_pkl_matches_jax(pkl):
    path, net, kw = pkl
    got, want = tpkl.load_network_pkl(path), jpkl.load_network_pkl(path)
    assert list(got) == list(want) == ['G', 'G_ema', 'training_set_kwargs']
    assert got['training_set_kwargs'] == {'resolution': 16}
    for key in ('G', 'G_ema'):
        assert got[key]['class_name'] == want[key]['class_name'] == \
            'training.networks.Generator'
        assert got[key]['init_kwargs'] == want[key]['init_kwargs'] == kw
        assert_same_state(got[key]['state_dict'], want[key]['state_dict'])
    assert_same_state(got['G_ema']['state_dict'],
                      {k: v.numpy() for k, v in net.state_dict().items()})


def test_generator_from_pkl_matches_jax(pkl):
    """The port's ``generator_from_pkl`` against the JAX one on one z (and
    label): ws within 1e-5, the image within 1e-4; truncation 0.7."""
    path, net, kw = pkl
    mapping, synthesis, got_kw = tpkl.generator_from_pkl(path)
    jm, jm_vars, js, js_vars, jkw = jpkl.generator_from_pkl(path)
    assert got_kw == jkw == kw
    c_dim = kw['c_dim']
    z = np.random.RandomState(0).randn(2, kw['z_dim']).astype(np.float32)
    c = np.eye(c_dim, dtype=np.float32)[[1, 3]] if c_dim else None

    @fast
    def jax_g(z, c):
        ws = jm.apply(jm_vars, z, c=c, truncation_psi=0.7)
        return ws, js.apply(js_vars, ws, noise_mode='const')

    ws_ref, img_ref = jax_g(jnp.asarray(z), None if c is None
                            else jnp.asarray(c))
    with torch.no_grad():
        ws = mapping(torch.from_numpy(z), None if c is None
                     else torch.from_numpy(c), truncation_psi=0.7)
        img = synthesis(ws, noise_mode='const')
    np.testing.assert_allclose(ws.numpy(), np.asarray(ws_ref), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_ref), rtol=0,
                               atol=1e-4)
    if c_dim:   # the label reaches the mapping
        with torch.no_grad():
            other = mapping(torch.from_numpy(z), torch.from_numpy(c[::-1]
                                                                  .copy()))
        assert not torch.allclose(other, mapping(torch.from_numpy(z),
                                                 torch.from_numpy(c)))


def test_pkl_generator_launches(pkl, monkeypatch):
    """One call of a ``.pkl`` generator through the kernels' autograd
    Functions (emulated) launches ``expected_generator_launches``."""
    path, _, kw = pkl
    mapping, synthesis, _ = tpkl.generator_from_pkl(path)
    kernels = emulate_kernels(monkeypatch)
    z = torch.randn(2, kw['z_dim'])
    c = torch.eye(kw['c_dim'])[:2] if kw['c_dim'] else None
    with torch.no_grad():
        synthesis(mapping(z, c), noise_mode='const')
    expect = expected_generator_launches(mapping, synthesis)
    assert {k: kernels[k].launches for k in expect} == expect
    assert expect['upfirdn2d'] == 2 and expect['bias_act'] > 0


def _fake_reconstruct(meta):  # a global to pickle; never called
    raise AssertionError('should never run')


def test_hostile_pickle_loads_inertly(tmp_path):
    """Embedded source and arbitrary globals stay inert
    (``tests/test_pkl_import.py:50-70``'s crafted pickle)."""
    meta = dict(type='class', version=6,
                module_src='raise RuntimeError("executed embedded source")',
                class_name='Evil', state={'_parameters': {}, '_buffers': {},
                                          '_modules': {}})

    class FakePersistent:
        def __reduce__(self):
            return (_fake_reconstruct, (meta,))

    payload = pickle.dumps({'G': FakePersistent()}, protocol=0)
    payload = payload.replace(_fake_reconstruct.__module__.encode(),
                              b'torch_utils.persistence')
    payload = payload.replace(b'_fake_reconstruct',
                              b'_reconstruct_persistent_obj')
    path = str(tmp_path / 'evil.pkl')
    with open(path, 'wb') as f:
        f.write(payload)
    got = tpkl.load_network_pkl(path)
    assert got['G']['class_name'] == 'Evil' == \
        jpkl.load_network_pkl(path)['G']['class_name']
    assert got['G']['state_dict'] == {}
    cls = tpkl._SafeUnpickler(io.BytesIO(b'')).find_class('os', 'system')
    assert isinstance(cls('echo pwned'), tpkl._Opaque)
    # a torch.save file with such a global loads inertly as well
    evil = str(tmp_path / 'evil.pth')
    torch.save({'x': _Shell()}, evil)
    assert isinstance(tti.load_torch_file(evil)['x'], tpkl._Opaque)


class _Shell:
    def __reduce__(self):
        return os.system, ('echo pwned',)


# ---------------------------------------------------------------------------
# TF1 pickles
# ---------------------------------------------------------------------------

def _tf_network_cls():
    """A dict subclass pickled under ``dnnlib.tflib.network.Network``, the
    name both unpicklers intercept."""
    mod = sys.modules.get('dnnlib.tflib.network')
    if mod is None:
        for name in ('dnnlib', 'dnnlib.tflib', 'dnnlib.tflib.network'):
            sys.modules.setdefault(name, types.ModuleType(name))
        mod = sys.modules['dnnlib.tflib.network']
    if not hasattr(mod, 'Network'):
        cls = type('Network', (dict,), {})
        cls.__module__ = 'dnnlib.tflib.network'
        mod.Network = cls
    return mod.Network


def _tf_conv(w, flip=False):
    v = w.numpy().transpose(2, 3, 1, 0)
    return np.ascontiguousarray(v[::-1, ::-1] if flip else v)


def _tf_pickle(tmp_path, res=16):
    """Seeded port G and D as TF1 variables (the names and layouts of
    legacy.py:117-320, inverted) in a (G, D, Gs) pickle."""
    fmap_base, fmap_max = 128, 32
    kw = dict(z_dim=16, c_dim=0, w_dim=16, img_resolution=res,
              img_channels=4, mapping_kwargs=dict(num_layers=2),
              synthesis_kwargs=dict(channel_base=2 * fmap_base,
                                    channel_max=fmap_max))
    g = seeded_generator(kw, seed=5)
    d = Discriminator(img_resolution=res, img_channels=4,
                      channel_base=2 * fmap_base, channel_max=fmap_max)
    d.reset_parameters(torch.Generator().manual_seed(6))
    gsd, dsd = g.state_dict(), d.state_dict()
    gv = {'dlatent_avg': gsd['mapping.w_avg'].numpy()}
    for i in range(2):
        gv[f'mapping/Dense{i}/weight'] = gsd[f'mapping.fc{i}.weight'].numpy().T
        gv[f'mapping/Dense{i}/bias'] = gsd[f'mapping.fc{i}.bias'].numpy()
    gv['synthesis/4x4/Const/const'] = gsd['synthesis.b4.const'].numpy()[None]
    layers = [('synthesis.b4.conv1', 'synthesis/4x4/Conv', 0)]
    for r in (8, 16):
        lg = int(np.log2(r))
        layers += [(f'synthesis.b{r}.conv0', f'synthesis/{r}x{r}/Conv0_up',
                    lg * 2 - 5),
                   (f'synthesis.b{r}.conv1', f'synthesis/{r}x{r}/Conv1',
                    lg * 2 - 4)]
    layers += [(f'synthesis.b{r}.torgb', f'synthesis/{r}x{r}/ToRGB', None)
               for r in (4, 8, 16)]
    for name, tf, noise in layers:
        gv[f'{tf}/weight'] = _tf_conv(gsd[f'{name}.weight'],
                                      tf.endswith('Conv0_up'))
        gv[f'{tf}/bias'] = gsd[f'{name}.bias'].numpy()
        gv[f'{tf}/mod_weight'] = gsd[f'{name}.affine.weight'].numpy().T
        gv[f'{tf}/mod_bias'] = gsd[f'{name}.affine.bias'].numpy() - 1
        if noise is not None:
            gv[f'{tf}/noise_strength'] = gsd[f'{name}.noise_strength'].numpy()
            gv[f'synthesis/noise{noise}'] = \
                gsd[f'{name}.noise_const'].numpy()[None, None]
    dv = {}
    for r in (16, 8):
        for name, tf in ((f'b{r}.fromrgb', f'{r}x{r}/FromRGB'),
                         (f'b{r}.conv0', f'{r}x{r}/Conv0'),
                         (f'b{r}.conv1', f'{r}x{r}/Conv1_down'),
                         (f'b{r}.skip', f'{r}x{r}/Skip')):
            if f'{name}.weight' in dsd:
                dv[f'{tf}/weight'] = _tf_conv(dsd[f'{name}.weight'])
                if f'{name}.bias' in dsd:
                    dv[f'{tf}/bias'] = dsd[f'{name}.bias'].numpy()
    dv['4x4/Conv/weight'] = _tf_conv(dsd['b4.conv.weight'])
    dv['4x4/Conv/bias'] = dsd['b4.conv.bias'].numpy()
    dv['4x4/Dense0/weight'] = dsd['b4.fc.weight'].numpy().T
    dv['4x4/Dense0/bias'] = dsd['b4.fc.bias'].numpy()
    dv['Output/weight'] = dsd['b4.out.weight'].numpy().T
    dv['Output/bias'] = dsd['b4.out.bias'].numpy()
    network = _tf_network_cls()

    def net(kwargs, variables):
        return network(version=4, static_kwargs=dict(kwargs), components={},
                       variables=list(variables.items()))

    g_kwargs = dict(latent_size=16, dlatent_size=16, resolution=res,
                    num_channels=4, mapping_layers=2, fmap_base=fmap_base,
                    fmap_max=fmap_max)
    d_kwargs = dict(resolution=res, num_channels=4, fmap_base=fmap_base,
                    fmap_max=fmap_max)
    path = str(tmp_path / 'tf1.pkl')
    with open(path, 'wb') as f:
        pickle.dump((net(g_kwargs, gv), net(d_kwargs, dv),
                     net(g_kwargs, gv)), f)
    return path, g, d


def test_tf1_conversion_matches_jax(tmp_path):
    """``convert_tf_generator``/``convert_tf_discriminator`` give the JAX
    package's dicts exactly; the port's generator read from the TF1 pickle
    samples as the seeded generator the variables came from."""
    path, g, d = _tf_pickle(tmp_path)
    got, want = tpkl.load_network_pkl(path), jpkl.load_network_pkl(path)
    assert list(got) == list(want)
    for key in ('G', 'D', 'G_ema'):
        assert got[key]['class_name'] == want[key]['class_name']
        assert got[key]['init_kwargs'] == want[key]['init_kwargs']
        assert_same_state(got[key]['state_dict'], want[key]['state_dict'])
    assert set(got['D']['state_dict']) == {
        k for k in d.state_dict() if not k.endswith('resample_filter')}
    mapping, synthesis, _ = tpkl.generator_from_pkl(path)
    z = torch.from_numpy(np.random.RandomState(1).randn(2, 16)
                         .astype(np.float32))
    with torch.no_grad():
        assert torch.equal(synthesis(mapping(z), noise_mode='const'),
                           g(z, noise_mode='const'))


# ---------------------------------------------------------------------------
# torch_import
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('rtype', ['tanh', 'sigmoid', 'subpixel'])
def test_reference_renderer_matches_jax(rtype, tmp_path):
    """A ``.pth.tar`` written by the JAX exporter from seeded parameters:
    the JAX and the port's loaders give one forward (1e-4)."""
    layers = 9 if rtype == 'subpixel' else 2
    res = 16
    port = build_renderer(rtype, img_resolution=res, img_channels=4,
                          img_layers=layers)
    port.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():
        for p in port.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator()
                               .manual_seed(p.numel())) * 0.05)
    params = jti.renderer_params_from_torch(port.state_dict(), rtype)
    path = str(tmp_path / 'renderer.pth.tar')
    torch.save({'renderer': jte.renderer_state_dict(params, rtype),
                'global_step': 1}, path)
    ours = tti.load_reference_renderer(path, rtype, img_resolution=res)
    jvars = jti.load_reference_renderer(path, rtype)
    jmod = jax_renderer(rtype, img_resolution=res, img_channels=4,
                        img_layers=layers)
    x = np.random.RandomState(2).uniform(-1, 1, (2, layers, res, res, 4)) \
        .astype(np.float32)
    ref = fast(jmod.apply)(jvars, jnp.asarray(x))
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    # a bare state dict reads the same
    torch.save(jte.renderer_state_dict(params, rtype), path)
    bare = tti.load_reference_renderer(path, rtype, img_resolution=res)
    assert_same_state(bare.state_dict(), ours.state_dict())


def test_reference_stn_and_widened_mapping_match_jax(tmp_path):
    """The STN's reference dict (written by the JAX exporter) loads
    strictly and places as JAX's does; ``widen_mapping_to_global`` equals
    the JAX package's, read back through its exporter.  The JAX importer
    reads the reference's five stages: 128 px."""
    geo = dict(img_resolution=128, img_channels=4, img_layers=2,
               num_stages=5)
    stn = STN(**geo)
    stn.reset_parameters(torch.Generator().manual_seed(4))
    with torch.no_grad():
        stn.fc_loc[2].bias.copy_(torch.randn(4, generator=torch.Generator()
                                             .manual_seed(5)) * 0.3)
    jvars = jti.stn_params_from_torch(stn.state_dict())
    path = str(tmp_path / 'stn.pth')
    torch.save(jte.stn_state_dict(jvars), path)
    ours = tti.load_module(STN(**geo), tti.load_torch_file(path), path)
    x = np.random.RandomState(6).uniform(-1, 1, (1, 2, 128, 128, 4)) \
        .astype(np.float32)
    jstn = JaxSTN(**geo)
    placed_ref, theta_ref = fast(jstn.apply)(jvars, jnp.asarray(x))
    with torch.no_grad():
        placed, theta = ours(torch.from_numpy(x))
    np.testing.assert_allclose(theta.numpy(), np.asarray(theta_ref), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(placed.numpy(), np.asarray(placed_ref),
                               rtol=0, atol=1e-4)
    with pytest.raises(KeyError, match='stn.pth'):
        tti.load_module(STN(**dict(geo, img_layers=3)),
                        tti.load_torch_file(path), path)

    net = seeded_generator(g_kw(0), seed=7)
    sd = net.mapping.state_dict()
    widened = tti.widen_mapping_to_global(sd, 3)
    want = jte.mapping_state_dict(jti.widen_mapping_to_global(
        jti.mapping_params_from_torch(sd), 3))
    assert_same_state({k: v.numpy() for k, v in widened.items()},
                      {k: v.numpy() for k, v in want.items()})
    assert_same_state(tti.slice_global_mapping(widened, 3, 1), sd)


# ---------------------------------------------------------------------------
# torch_export and export-torch
# ---------------------------------------------------------------------------

def jax_stn(sd):
    """A port STN's state dict as the JAX STN's params, for any number of
    stages (the JAX importer reads five): the inverse of
    ``weights.stn_state_dict``."""
    n = sum(k.endswith('.weight') for k in sd if k.startswith('local'))
    params = {f'Conv_{i}': {
        'kernel': sd[f'localization.{3 * i}.weight'].numpy()
        .transpose(2, 3, 1, 0),
        'bias': sd[f'localization.{3 * i}.bias'].numpy()} for i in range(n)}
    w0 = sd['fc_loc.0.weight'].numpy()
    c = params[f'Conv_{n - 1}']['kernel'].shape[-1]
    side = int(round((w0.shape[1] // c) ** 0.5))
    w0 = w0.reshape(-1, c, side, side).transpose(0, 2, 3, 1)
    params['Dense_0'] = {'kernel': w0.reshape(w0.shape[0], -1).T,
                         'bias': sd['fc_loc.0.bias'].numpy()}
    params['Dense_1'] = {'kernel': sd['fc_loc.2.weight'].numpy().T,
                         'bias': sd['fc_loc.2.bias'].numpy()}
    return {'params': params}


@pytest.fixture(scope='module')
def aio():
    """A micro AIO ensemble with its Ds, an EMA with other weights, and the
    JAX package's variables of both (through its own converters)."""
    cfg = MontageConfig(**MICRO_AIO)
    model = MontageEnsemble(cfg, with_d=True).init_weights(11)
    ema = MontageEnsemble(cfg).init_weights(12)
    aug_p = torch.tensor([0.1, 0.2, 0.3, 0.4])

    def jax_g(m, with_d):
        v = {'mapping': jti.mapping_params_from_torch(m.mapping.state_dict()),
             'local_g': tuple(jti.synthesis_params_from_torch(g.state_dict())
                              for g in m.local_g),
             'stn': jax_stn(m.stn.state_dict())}
        if with_d:
            v['local_d'] = tuple(jti.discriminator_params_from_torch(
                d.state_dict(), init_res=cfg.layer_geometry(i)[0])
                for i, d in enumerate(m.local_d))
            v['global_d'] = jti.discriminator_params_from_torch(
                m.global_d.state_dict(), init_res=cfg.base_init_res)
            v['renderer'] = jti.renderer_params_from_torch(
                m.renderer.state_dict(), 'tanh')
        return v

    jstate = types.SimpleNamespace(variables=jax_g(model, True),
                                   ema=jax_g(ema, False), aug_p=aug_p.numpy())
    state = types.SimpleNamespace(model=model, ema=ema, aug_p=aug_p)
    return cfg, state, jstate


def _assert_tensors_equal(got, want, key):
    assert list(got) == list(want), key
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, (key, k)
        assert torch.equal(got[k], want[k]), (key, k)


def _assert_payloads_equal(got, want):
    """Two reference AIO payloads: the same entries in the same order; each
    state dict's keys in the same order and its float32 tensors equal."""
    assert list(got) == list(want)
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, list):
            assert len(g) == len(w), key
            for a, b in zip(g, w):
                _assert_tensors_equal(a, b, key)
        elif key == 'training_set_kwargs':
            assert g == w
        else:
            _assert_tensors_equal(g, w, key)


def test_export_aio_snapshot_matches_jax(aio, tmp_path):
    cfg, state, jstate = aio
    got = tte.export_aio_snapshot(state, str(tmp_path / 'port.pth'),
                                  training_set_kwargs={'path': 'x'})
    want = jte.export_aio_snapshot(jstate, JaxConfig(**MICRO_AIO),
                                   str(tmp_path / 'jax.pth'),
                                   training_set_kwargs={'path': 'x'})
    _assert_payloads_equal(got, want)
    _assert_payloads_equal(tti.load_torch_file(str(tmp_path / 'port.pth')),
                           want)
    # the live models read back: Ds included, each strictly
    model = tti.load_aio_snapshot(str(tmp_path / 'jax.pth'), cfg, ema=False,
                                  with_d=True)
    assert_same_state(model.state_dict(), state.model.state_dict())


def test_export_torch_cli_pth_matches_jax_and_reads_back(aio, tmp_path):
    """``export-torch --format pth`` of a port EMA snapshot: the payload of
    ``montage_gan_tpu/cli/export_torch.py:79-100`` built from the same tree
    through the JAX functions; read back through ``torch_import``, the
    ensemble samples as the snapshot does, bit for bit."""
    cfg, state, jstate = aio
    snap = str(tmp_path / 'ema.pt')
    tckpt.save_ema_snapshot(snap, cfg, state.ema, state.model.renderer)
    dest = str(tmp_path / 'export.pth')
    export_torch.main(['--network', snap, '--dest', dest])
    tree = dict(jstate.ema, renderer=jstate.variables['renderer'])
    want = {'training_set_kwargs': {}}
    want['mapping_network'] = jte.mapping_state_dict(tree['mapping'])
    want['mapping_network_ema'] = jte.mapping_state_dict(tree['mapping'])
    want['local_G_list'] = [jte.synthesis_state_dict(g)
                            for g in tree['local_g']]
    want['local_G_ema'] = [jte.synthesis_state_dict(g)
                           for g in tree['local_g']]
    want['renderer'] = jte.renderer_state_dict(tree['renderer'], 'tanh')
    want['pos_estimator'] = jte.stn_state_dict(tree['stn'])
    want['pos_estimator_ema'] = jte.stn_state_dict(tree['stn'])
    _assert_payloads_equal(tti.load_torch_file(dest), want)

    _, snap_model = tckpt.load_network(snap, device='cpu')
    back = tti.load_aio_snapshot(dest, cfg).eval()
    z = torch.from_numpy(np.random.RandomState(3).randn(2, cfg.z_dim)
                         .astype(np.float32))
    for composite in ('alpha', 'renderer'):
        ref = build_inference_fn(cfg, snap_model, composite=composite)(z)
        out = build_inference_fn(cfg, back, composite=composite)(z)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)


def test_export_torch_pkl_needs_the_reference(aio, tmp_path):
    """``--format pkl`` raises the JAX package's ImportError without a
    reference checkout; a montage snapshot needs ``--layer``."""
    cfg, state, _ = aio
    snap = str(tmp_path / 'ema.pt')
    tckpt.save_ema_snapshot(snap, cfg, state.ema)
    with pytest.raises(ImportError, match='reference repo') as port_err:
        export_torch.main(['--network', snap, '--dest',
                           str(tmp_path / 'x.pkl'), '--format', 'pkl',
                           '--layer', 'c'])
    with pytest.raises(ImportError, match='reference repo') as jax_err:
        jte.export_network_pkl(str(tmp_path / 'y.pkl'), g_kwargs={},
                               mapping_vars=None, synthesis_vars=None)
    assert type(port_err.value.__cause__) is type(jax_err.value.__cause__)
    with pytest.raises(SystemExit):
        export_torch.main(['--network', snap, '--dest',
                           str(tmp_path / 'x.pkl'), '--format', 'pkl'])


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

def test_convert_pickle_then_generate_equals_the_pkl(tmp_path):
    """``generate`` of the ``.pkl`` and of its ``convert-pickle`` snapshot:
    the generator's image bit for bit (the snapshot's 1-layer ensemble
    writes it as its layer, ``--save-layers``)."""
    kw = g_kw(0)
    path = write_persistence_pkl(str(tmp_path / 'net.pkl'),
                                 {'G_ema': seeded_generator(kw, seed=9)},
                                 {'G_ema': kw})
    snap = convert_pickle.main(['--source', path, '--dest',
                                str(tmp_path / 'net.pt')])
    cfg, model = tckpt.load_network(snap, device='cpu')
    assert (cfg.num_layers, cfg.use_global_mapping, model.stn,
            model.renderer) == (1, False, None, None)
    for noise in ('const', 'none'):
        a, b = tmp_path / f'pkl-{noise}', tmp_path / f'snap-{noise}'
        common = ['--seeds', '0-2', '--trunc', '0.8', '--noise-mode', noise,
                  '--device', 'cpu']
        generate.main(['--network', path, '--outdir', str(a), *common])
        generate.main(['--network', snap, '--outdir', str(b),
                       '--save-layers', *common])
        for seed in range(3):
            img = read_png_rgba(str(a / f'seed{seed:04d}.png'))
            np.testing.assert_array_equal(
                img, read_png_rgba(str(b / f'seed{seed:04d}-0_image.png')))


def test_generate_pkl_class_contract(tmp_path, capsys):
    """``--class`` (the reference's generate.py:110-118): a conditional
    network needs a label in range, labels reach the mapping; on an
    unconditional network or a snapshot ``--class`` warns."""
    kw = g_kw(3)
    path = write_persistence_pkl(str(tmp_path / 'cond.pkl'),
                                 {'G_ema': seeded_generator(kw, seed=2)},
                                 {'G_ema': kw})
    common = ['--network', path, '--seeds', '0', '--device', 'cpu']
    with pytest.raises(SystemExit):
        generate.main([*common, '--outdir', str(tmp_path / 'x')])
    assert 'Must specify class label with --class' in capsys.readouterr().err
    with pytest.raises(SystemExit):
        generate.main([*common, '--outdir', str(tmp_path / 'x'),
                       '--class', '3'])
    assert 'out of range for c_dim=3' in capsys.readouterr().err
    imgs = []
    for ci in (0, 2):
        generate.main([*common, '--outdir', str(tmp_path / f'c{ci}'),
                       '--class', str(ci)])
        assert os.listdir(tmp_path / f'c{ci}') == ['seed0000.png']
        imgs.append(read_png_rgba(str(tmp_path / f'c{ci}' / 'seed0000.png')))
    assert not np.array_equal(*imgs)
    kw0 = g_kw(0)
    path0 = write_persistence_pkl(str(tmp_path / 'u.pkl'),
                                  {'G_ema': seeded_generator(kw0)},
                                  {'G_ema': kw0})
    capsys.readouterr()
    generate.main(['--network', path0, '--seeds', '0', '--class', '1',
                   '--outdir', str(tmp_path / 'u'), '--device', 'cpu'])
    assert 'ignored when running on an unconditional network' in \
        capsys.readouterr().out
    snap = convert_pickle.main(['--source', path0, '--dest',
                                str(tmp_path / 'u.pt')])
    generate.main(['--network', snap, '--seeds', '0', '--class', '1',
                   '--outdir', str(tmp_path / 's'), '--device', 'cpu'])
    assert 'ignored when running on an unconditional network' in \
        capsys.readouterr().out


def test_train_aio_renderer_import_is_not_read(tmp_path, capsys):
    """``--renderer-import`` is accepted and, as in the JAX CLI, not read:
    the run's every setting (and so every weight, all made from the seed
    and the config) is the one without it; one line says so."""
    from montage_gan_tpu_torch.data.synthetic import (
        DEFAULT_SPEC, make_synthetic_layer_dataset)
    data = make_synthetic_layer_dataset(str(tmp_path / 'layers'),
                                        num_samples=2, size=16,
                                        spec=DEFAULT_SPEC[:2])
    base = ['--outdir', str(tmp_path / 'runs'), '--data', data,
            '--device', 'cpu', '--cfg', 'auto', '--batch', '4',
            '--channel-base', '256', '--channel-max', '32']
    plain = train_aio.setup_training_loop_kwargs(
        train_aio.parse_options(base), 1, run_dir='r')
    assert capsys.readouterr().out == ''
    with_flag = train_aio.setup_training_loop_kwargs(
        train_aio.parse_options([*base, '--renderer-import', 'r.pth.tar']),
        1, run_dir='r')
    out = capsys.readouterr().out
    assert '--renderer-import r.pth.tar: not read' in out
    assert len(out.strip().splitlines()) == 1
    plain.pop('dataset')
    with_flag.pop('dataset')
    assert with_flag == plain


# ---------------------------------------------------------------------------
# The simple global Ds
# ---------------------------------------------------------------------------

def flax_params(port_state):
    """The inverse of ``weights.simple_d_state_dict``: a port simple D's
    state dict as flax params."""
    params = {}
    for k, v in port_state.items():
        *path, leaf = k.split('.')
        node = params
        for p in path:
            node = node.setdefault(p, {})
        v = v.numpy()
        if leaf == 'weight':
            node['kernel'] = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
        else:
            node[leaf] = v
    return {'params': params}


@pytest.mark.parametrize('version,res,batch', [(1, 16, 2), (2, 64, 1)],
                         ids=['v1', 'v2'])
def test_simple_d_matches_jax(version, res, batch):
    """The port's simple Ds against the JAX ones with the same weights
    (V1 at ``nf1`` 8), both ways through ``simple_d_state_dict``:
    logits within 1e-4 of their scale."""
    if version == 1:
        port = SimpleGlobalDiscriminator(img_resolution=res, img_channels=4,
                                         nf1=8)
        jmod = JaxSimpleD(img_resolution=res, img_channels=4, nf1=8)
    else:
        port = SimpleGlobalDiscriminatorV2(img_resolution=res, img_channels=4)
        jmod = JaxSimpleDV2(img_resolution=res, img_channels=4)
    port.reset_parameters(torch.Generator().manual_seed(version))
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith('bias'):
                p.add_(torch.randn(p.shape, generator=torch.Generator()
                                   .manual_seed(p.numel())) * 0.1)
    jvars = flax_params(port.state_dict())
    back = simple_d_state_dict(jvars)
    assert set(back) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k
    x = np.random.RandomState(version).uniform(-1, 1, (batch, res, res, 4)) \
        .astype(np.float32)
    ref = np.asarray(fast(jmod.apply)(jvars, jnp.asarray(x)))
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (batch, 1)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))
