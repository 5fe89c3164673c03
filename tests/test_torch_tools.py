"""The port's inference tools against the JAX package's, on the CPU: the
style-mixing grid, ``generate --projected-w`` and ``--composite renderer``,
``build_inference_fn(composite='renderer')``, ``random_position`` and the
renderer comparison.

A small ensemble (two layers of 8 px, the STN, a tanh renderer) is
initialised in JAX, its zero-initialised leaves given random values
(``test_torch_slice._perturb``); both packages read one JAX EMA snapshot of
it.  JAX CLIs run with ``FAST_COMPILE`` (``jax.jit`` patched for
the call) and load the snapshot through a template of zeros of its shapes
(``test_torch_slice._shaped_snapshot_template``).

Tolerances: PNGs within 1 of 255 (a float32 difference can move a value
across a rounding boundary); ``build_inference_fn(composite='renderer')``:
the montage within 1e-5 of its largest entry, the placed layers within
``test_torch_slice``'s 1e-4 (the STN's shifts, computed from layers that
differ in summation order, move the -1 padding edges by a fraction of a
pixel); ``random_position`` with JAX's uniform draw injected, 1e-5; the
average PSNR within 1e-3 dB.
"""

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from montage_gan_tpu.models.ensemble import MontageConfig as JaxConfig
from montage_gan_tpu.models.ensemble import MontageEnsemble as JaxEnsemble
from montage_gan_tpu.utils import checkpoint as jckpt
from montage_gan_tpu.utils import image_utils as jimg
from montage_gan_tpu.utils import serving as jserving
from montage_gan_tpu.utils import torch_export
from montage_gan_tpu_torch import __main__ as port_main
from montage_gan_tpu_torch.models.ensemble import MontageConfig
from montage_gan_tpu_torch.utils import checkpoint as tckpt
from montage_gan_tpu_torch.utils import image_utils as timg
from montage_gan_tpu_torch.utils import serving as tserving
from montage_gan_tpu_torch.utils.png import read_png_rgba

from montage_gan_tpu_torch.models.ensemble import MontageEnsemble
from montage_gan_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_slice import _perturb, _shaped_snapshot_template
from test_torch_train import FAST_COMPILE

torch.set_num_threads(1)

SMALL = dict(layer_names=('a', 'b'), layer_targets=((8, 8), (8, 4)),
             base_resolution=8, img_channels=4, conv_config_index=2,
             z_dim=16, w_dim=16, mapping_num_layers=2, channel_base=64,
             channel_max=16, num_fp16_res=0, conv_clamp=256,
             renderer_type='tanh', stn_stages=1)
_JIT = jax.jit


def fast_jit(monkeypatch, record=None):
    """``jax.jit`` with XLA's optimizations off for the rest of the test
    (a call inside another jit's trace, where XLA takes no options, runs
    the plain jit); with ``record`` (a list) each top-level call's result is
    appended to it."""
    jit = _JIT

    def patched(fn=None, **kw):
        if fn is None:
            return functools.partial(patched, **kw)
        fast, plain = jit(fn, compiler_options=FAST_COMPILE, **kw), jit(fn,
                                                                        **kw)

        def call(*a, **k):
            if any(isinstance(x, jax.core.Tracer)
                   for x in jax.tree_util.tree_leaves((a, k))):
                return plain(*a, **k)
            out = fast(*a, **k)
            if record is not None:
                record.append(out)
            return out
        return call
    monkeypatch.setattr(jax, 'jit', patched)


def jit_eager(monkeypatch, owner, name):
    """Run each eager call of the method ``owner.name`` as one jitted call
    with ``FAST_COMPILE`` (eager JAX compiles every primitive on its own:
    the JAX projector renders its result eagerly).  Calls inside a trace
    pass through."""
    eager, jitted = getattr(owner, name), {}

    def call(self, *a, **kw):
        if any(isinstance(x, jax.core.Tracer)
               for x in jax.tree_util.tree_leaves(a)):
            return eager(self, *a, **kw)
        key = (id(self), tuple(sorted(kw.items())))
        if key not in jitted:
            jitted[key] = _JIT(lambda *args: eager(self, *args, **kw),
                               compiler_options=FAST_COMPILE)
        return jitted[key](*a)
    monkeypatch.setattr(owner, name, call)


@functools.lru_cache(maxsize=None)
def small_tree():
    """The small ensemble's (JAX config, JAX tree, numpy tree), built once a
    process: the tools, projector and serving tests share it."""
    cfg = JaxConfig(**SMALL)
    ens = JaxEnsemble(cfg)

    @functools.partial(_JIT, compiler_options=FAST_COMPILE)
    def init(key):
        stack = jnp.zeros((1, cfg.num_layers, 8, 8, 4))
        local_g = tuple(g.init({'params': jax.random.fold_in(key, i),
                                'noise': jax.random.fold_in(key, 50 + i)},
                               jnp.zeros((1, g.num_ws, cfg.w_dim)),
                               noise_mode='const')
                        for i, g in enumerate(ens.local_gs))
        return {'mapping': ens.mapping.init(
                    {'params': jax.random.fold_in(key, 100)},
                    jnp.zeros((1, cfg.z_dim))),
                'local_g': local_g,
                'stn': ens.stn.init({'params': jax.random.fold_in(key, 101)},
                                    stack),
                'renderer': ens.renderer.init(
                    {'params': jax.random.fold_in(key, 102)}, stack)}

    tree = _perturb(init(jax.random.PRNGKey(0)), seed=1)
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)
    return cfg, tree, np_tree


@pytest.fixture(scope='module')
def small():
    return small_tree()


def port_model(np_tree):
    cfg = MontageConfig(**SMALL)
    model = MontageEnsemble(cfg)
    model.load_state_dict(state_dict_from_jax(cfg, np_tree))
    return cfg, model.eval().requires_grad_(False)


@pytest.fixture(scope='module')
def snapshot(small, tmp_path_factory):
    """A JAX EMA snapshot of the small ensemble with its renderer."""
    jcfg, tree, _ = small
    path = str(tmp_path_factory.mktemp('snap') / 'ema')
    jckpt.save_ema_snapshot(path, jcfg, {k: v for k, v in tree.items()
                                         if k != 'renderer'},
                            tree['renderer'])
    return path + '.msgpack'


def assert_same_pngs(a_dir, b_dir, expect_count):
    names = sorted(os.listdir(a_dir))
    assert len(names) == expect_count, names
    assert sorted(os.listdir(b_dir)) == names
    for name in names:
        a = read_png_rgba(os.path.join(a_dir, name)).astype(np.int16)
        b = read_png_rgba(os.path.join(b_dir, name)).astype(np.int16)
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1, name


def run_jax_cli(main, args):
    from click.testing import CliRunner
    res = CliRunner().invoke(main, args, catch_exceptions=False)
    assert res.exit_code == 0, res.output
    return res.output


def test_style_mixing_cli_matches_jax(snapshot, tmp_path, monkeypatch):
    from montage_gan_tpu.cli.style_mixing import main as jax_main
    from montage_gan_tpu_torch.cli.style_mixing import main as port_main_

    _shaped_snapshot_template(monkeypatch)
    fast_jit(monkeypatch)
    args = ['--network', snapshot, '--rows', '0,1', '--cols', '2,5',
            '--styles', '0-2', '--trunc', '0.7']
    run_jax_cli(jax_main, args + ['--outdir', str(tmp_path / 'jax')])
    images = port_main_(args + ['--outdir', str(tmp_path / 'port'),
                                '--device', 'cpu'])
    assert sorted(images) == [(0, 2), (0, 5), (1, 2), (1, 5)]
    assert_same_pngs(tmp_path / 'jax', tmp_path / 'port', 1 + 4)
    grid = read_png_rgba(str(tmp_path / 'port' / 'grid.png'))
    assert grid.shape == (2 * 10 + 2, 2 * 10 + 2, 4)
    # the mixed styles came from the column seed: another column differs
    assert not np.array_equal(images[(0, 2)], images[(0, 5)])


def test_generate_projected_w_matches_jax(snapshot, tmp_path, monkeypatch):
    """Two projected w replayed through the renderer, with their layers,
    against the JAX CLI; through the alpha composite, the mapping's w of a
    seed gives the seed's own montage, bit for bit."""
    from montage_gan_tpu.cli.generate import main as jax_main
    from montage_gan_tpu_torch.cli.generate import main as port_main_

    _shaped_snapshot_template(monkeypatch)
    fast_jit(monkeypatch)
    w = (np.random.RandomState(4).randn(2, 2, 4, 16) * 0.5).astype(
        np.float32)
    np.savez(tmp_path / 'projected_w.npz', w=w)
    args = ['--network', snapshot, '--projected-w',
            str(tmp_path / 'projected_w.npz'), '--save-layers',
            '--composite', 'renderer']
    run_jax_cli(jax_main, args + ['--outdir', str(tmp_path / 'jax')])
    port_main_(args + ['--outdir', str(tmp_path / 'port'), '--device', 'cpu'])
    assert_same_pngs(tmp_path / 'jax', tmp_path / 'port', 2 * (1 + 2))

    _, model = tckpt.load_network(snapshot, device='cpu')
    z = np.random.RandomState(3).randn(1, 16).astype(np.float32)
    with torch.no_grad():
        np.savez(tmp_path / 'seed3.npz',
                 w=model.mapping(torch.from_numpy(z)).numpy())
    for args in (['--projected-w', str(tmp_path / 'seed3.npz')],
                 ['--seeds', '3']):
        port_main_(['--network', snapshot, '--outdir', str(tmp_path / 'a'),
                    '--device', 'cpu', *args])
    np.testing.assert_array_equal(
        read_png_rgba(str(tmp_path / 'a' / 'proj00.png')),
        read_png_rgba(str(tmp_path / 'a' / 'seed0003.png')))


def test_generate_renderer_composite_matches_jax(snapshot, tmp_path,
                                                 monkeypatch):
    from montage_gan_tpu.cli.generate import main as jax_main
    from montage_gan_tpu_torch.cli.generate import main as port_main_

    _shaped_snapshot_template(monkeypatch)
    fast_jit(monkeypatch)
    args = ['--network', snapshot, '--seeds', '3', '--trunc', '0.7',
            '--composite', 'renderer']
    run_jax_cli(jax_main, args + ['--outdir', str(tmp_path / 'jax')])
    port_main_(args + ['--outdir', str(tmp_path / 'port'), '--device', 'cpu'])
    assert_same_pngs(tmp_path / 'jax', tmp_path / 'port', 1)
    # the renderer's montage is not the alpha composite
    port_main_(['--network', snapshot, '--seeds', '3', '--trunc', '0.7',
                '--outdir', str(tmp_path / 'alpha'), '--device', 'cpu'])
    assert not np.array_equal(
        read_png_rgba(str(tmp_path / 'port' / 'seed0003.png')),
        read_png_rgba(str(tmp_path / 'alpha' / 'seed0003.png')))


def test_generate_refuses_pkl_and_needs_seeds(tmp_path):
    """A ``.pkl`` now goes to the pickle reader (``utils/pkl_import.py``;
    ``tests/test_torch_interop.py`` samples one): a missing file raises
    there, not as a port that waits."""
    from montage_gan_tpu_torch.cli.generate import main as port_main_
    with pytest.raises(FileNotFoundError, match='net.pkl'):
        port_main_(['--network', 'net.pkl', '--seeds', '0', '--outdir',
                    str(tmp_path), '--device', 'cpu'])
    with pytest.raises(SystemExit):
        port_main_(['--network', 'net.pt', '--outdir', str(tmp_path)])


def test_inference_fn_renderer_matches_jax(small):
    jcfg, tree, np_tree = small
    jfn = jax.jit(jserving.build_inference_fn(
        jcfg, JaxEnsemble(jcfg), tree, truncation_psi=0.7,
        noise_mode='const', composite='renderer'),
        compiler_options=FAST_COMPILE)
    cfg, model = port_model(np_tree)
    assert model.renderer is not None
    tfn = tserving.build_inference_fn(cfg, model, truncation_psi=0.7,
                                      noise_mode='const',
                                      composite='renderer')
    z = np.random.RandomState(2).randn(2, cfg.z_dim).astype(np.float32)
    ref_placed, ref_img = jfn(jnp.asarray(z), jnp.uint32(0))
    placed, img = tfn(torch.from_numpy(z), 0)
    # the placed layers at test_torch_slice's tolerance; the renderer's
    # montage within 1e-5 of its largest entry
    for out, ref, tol in ((placed, ref_placed, 1e-4), (img, ref_img, 1e-5)):
        ref = np.asarray(ref)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=tol * np.abs(ref).max())
    # the renderer's output leaves [0, 1]: it is not clipped
    alpha = tserving.build_inference_fn(cfg, model, truncation_psi=0.7)
    assert not torch.allclose(alpha(torch.from_numpy(z))[1], img)


def test_random_position_matches_jax():
    rng = np.random.RandomState(0)
    layers = rng.uniform(0, 1, (2, 3, 16, 12, 4)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = jax.jit(jimg.random_position, compiler_options=FAST_COMPILE)(
        jnp.asarray(layers), key)
    t = np.array(jax.random.uniform(key, (6, 2), minval=-1.0, maxval=1.0))
    out = timg.random_position(torch.from_numpy(layers),
                               translations=torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    # drawn from a generator: in [-1, 1), reproducible, and it moves layers
    a = timg.random_position(torch.from_numpy(layers),
                             torch.Generator().manual_seed(1))
    b = timg.random_position(torch.from_numpy(layers),
                             torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, torch.from_numpy(layers))


@pytest.fixture(scope='module')
def renderer_data(small, tmp_path_factory):
    """A tiny layered dataset (4 samples, 2 layers of 16 px) and the small
    ensemble's renderer as a JAX ``.msgpack`` checkpoint ``{'renderer':
    ...}``."""
    import flax.serialization

    from montage_gan_tpu_torch.data.synthetic import (
        DEFAULT_SPEC, make_synthetic_layer_dataset)
    d = tmp_path_factory.mktemp('renderer')
    data = make_synthetic_layer_dataset(str(d / 'layers'), num_samples=4,
                                        size=16, spec=DEFAULT_SPEC[:2])
    ckpt = str(d / 'renderer.msgpack')
    with open(ckpt, 'wb') as f:
        f.write(flax.serialization.msgpack_serialize(
            {'global_step': 3, 'renderer': small[2]['renderer']}))
    return data, ckpt


def test_compare_renderers_matches_jax(renderer_data, small, tmp_path,
                                       monkeypatch):
    from montage_gan_tpu.cli.compare_renderers import main as jax_main
    from montage_gan_tpu_torch.cli.compare_renderers import main as port_cmp

    data, ckpt = renderer_data
    psnrs = []
    fast_jit(monkeypatch, record=psnrs)
    args = ['--data', data, '--ckpt', ckpt, '--batch', '2',
            '--no-random-place']
    out = run_jax_cli(jax_main, args)
    ref = float(np.mean(np.concatenate([np.asarray(p) for p in psnrs])))
    assert f'{ref:7.2f} dB (4 samples)' in out
    got = port_cmp(args + ['--device', 'cpu'])[ckpt]
    assert abs(got - ref) <= 1e-3, (got, ref)

    # the same renderer from a port EMA snapshot and from a reference
    # .pth.tar (its 'renderer' entry, as the JAX package's exporter writes it)
    cfg, model = port_model(small[2])
    tckpt.save_ema_snapshot(str(tmp_path / 'ema.pt'), cfg, model)
    pth = str(tmp_path / 'r.pth.tar')
    torch.save({'renderer': torch_export.renderer_state_dict(
        small[2]['renderer'], 'tanh'), 'global_step': 3}, pth)
    res = port_cmp(args + ['--ckpt', str(tmp_path / 'ema.pt'), '--ckpt', pth,
                           '--device', 'cpu'])
    assert res[str(tmp_path / 'ema.pt')] == res[ckpt] == res[pth]
    # random placement moves the layers, from a generator keyed by the seed
    placed = [port_cmp(['--data', data, '--ckpt', ckpt, '--batch', '2',
                        '--seed', str(s), '--device', 'cpu'])[ckpt]
              for s in (0, 0, 1)]
    assert placed[0] == placed[1] != placed[2] and placed[0] != got


@pytest.mark.parametrize('command', ['style-mixing', 'projector',
                                     'export-model', 'compare-renderers'])
def test_main_dispatches_the_tools(command, capsys):
    assert command in port_main.PORTED and command not in port_main.WAITING
    with pytest.raises(SystemExit) as e:
        port_main.main([command, '--help'])
    assert e.value.code == 0
    assert '--device' in capsys.readouterr().out
    assert not port_main.WAITING
