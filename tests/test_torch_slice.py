"""The port's sampling path end to end against the JAX package's, on the CPU.

A micro ensemble (3 layers, two sharing a geometry) is initialised once in
JAX, with the zero-init STN head, biases, noise strengths and w_avg given
random values so that every term of the path does work.  Its variables
cross into the port as numpy arrays through ``state_dict_from_jax``.

Tolerances: ``build_inference_fn`` in float32 ``atol 1e-4`` (convolutions
sum in another order); PNGs within 1 LSB (a float32 difference can move a
value across a rounding boundary).  With two bfloat16 resolutions the two
frameworks round at other places: one layer differs by a bfloat16 ulp, the
layer stack by a few, and the STN, which reads that stack, then translates
by a slightly different amount, moving the -1 padding edges (height up to 2)
by a fraction of a pixel.  So the bfloat16 case bounds the mean abs error by
2**-8 (half a bfloat16 ulp at 1: the typical element differs by less than
one rounding; running the port in float32 against JAX in bfloat16 gives
about twice that) and the max abs error by 0.15 (a sub-pixel shift across
such an edge).
"""

import ast
import dataclasses
import functools
import os
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from montage_gan_tpu.models.ensemble import MontageConfig as JaxConfig
from montage_gan_tpu.models.ensemble import MontageEnsemble as JaxEnsemble
from montage_gan_tpu.utils import checkpoint as jckpt
from montage_gan_tpu.utils import serving as jserving
from montage_gan_tpu.utils import torch_export
from montage_gan_tpu_torch.models.ensemble import MontageConfig, MontageEnsemble
from montage_gan_tpu_torch.utils import checkpoint as tckpt
from montage_gan_tpu_torch.utils import serving as tserving
from montage_gan_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_train import FAST_COMPILE

torch.set_num_threads(1)

MICRO = dict(layer_names=('a', 'b', 'c'),
             layer_targets=((32, 32), (32, 32), (16, 8)),
             base_resolution=32, img_channels=4, conv_config_index=2,
             z_dim=32, w_dim=32, mapping_num_layers=2, channel_base=512,
             channel_max=32, num_fp16_res=0, conv_clamp=256,
             renderer_type='none', stn_stages=2)


def _perturb(tree, seed):
    """Random values for the zero-initialised leaves (biases, noise
    strengths, w_avg, the STN's last kernel)."""
    rng = np.random.RandomState(seed)

    def f(path, leaf):
        name = getattr(path[-1], 'key', None)
        if name in ('bias', 'noise_strength', 'w_avg') or (
                name == 'kernel' and 'Dense_1' in str(path)):
            scale = 0.3 if 'stn' in str(path[0]) else 0.1
            return jnp.asarray(np.asarray(
                rng.randn(*np.shape(leaf)) * scale, np.float32))
        return leaf
    return jax.tree_util.tree_map_with_path(f, tree)


def _micro_jax_tree():
    cfg = JaxConfig(**MICRO)
    ens = JaxEnsemble(cfg)

    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def init(key):                  # the G side of init_variables
        local_g = []
        for i, g in enumerate(ens.local_gs):
            kg = jax.random.fold_in(key, i)
            local_g.append(g.init(
                {'params': kg, 'noise': jax.random.fold_in(kg, 7)},
                jnp.zeros((1, g.num_ws, cfg.w_dim)), noise_mode='const'))
        return {'mapping': ens.mapping.init(
                    {'params': jax.random.fold_in(key, 100)},
                    jnp.zeros((1, cfg.z_dim))),
                'local_g': tuple(local_g),
                'stn': ens.stn.init({'params': jax.random.fold_in(key, 101)},
                                    jnp.zeros((1, cfg.num_layers, 32, 32, 4)))}

    tree = _perturb(init(jax.random.PRNGKey(0)), seed=1)
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)
    return cfg, tree, np_tree


@pytest.fixture(scope='module')
def micro():
    return _micro_jax_tree()


def _port_model(np_tree, **overrides):
    cfg = MontageConfig(**{**MICRO, **overrides})
    model = MontageEnsemble(cfg)
    model.load_state_dict(state_dict_from_jax(cfg, np_tree))
    return cfg, model.eval()


def test_state_dict_matches_torch_export(micro):
    _, _, np_tree = micro
    cfg, model = _port_model(np_tree)
    sd = state_dict_from_jax(cfg, np_tree)
    assert list(sd) == list(model.state_dict())   # same keys, same order
    expected = [('mapping.', torch_export.mapping_state_dict(np_tree['mapping'])),
                ('stn.', torch_export.stn_state_dict(np_tree['stn']))]
    expected += [(f'local_g.{i}.', torch_export.synthesis_state_dict(g))
                 for i, g in enumerate(np_tree['local_g'])]
    n = 0
    for prefix, ref in expected:
        ours = {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}
        assert list(ours) == list(ref), prefix
        for k, v in ref.items():
            assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
            assert torch.equal(ours[k], v), k
        n += len(ref)
    assert n == len(sd)


def _assert_agree(out, ref, num_fp16_res):
    ref = np.asarray(ref)
    err = np.abs(out.numpy() - ref)
    if num_fp16_res == 0:
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)
    else:
        assert err.mean() <= 2.0 ** -8, err.mean()
        assert err.max() <= 0.15, err.max()


@pytest.mark.parametrize('num_fp16_res', [0, 2])
def test_inference_fn_matches_jax(micro, num_fp16_res):
    _, tree, np_tree = micro
    jcfg = JaxConfig(**{**MICRO, 'num_fp16_res': num_fp16_res})
    jfn = jax.jit(jserving.build_inference_fn(
        jcfg, JaxEnsemble(jcfg), tree, truncation_psi=0.7,
        noise_mode='const'))
    cfg, model = _port_model(np_tree, num_fp16_res=num_fp16_res)
    tfn = tserving.build_inference_fn(cfg, model, truncation_psi=0.7,
                                      noise_mode='const')
    z = np.random.RandomState(2).randn(2, cfg.z_dim).astype(np.float32)
    ref_placed, ref_img = jfn(jnp.asarray(z), jnp.uint32(0))
    placed, img = tfn(torch.from_numpy(z), 0)
    assert placed.shape == ref_placed.shape == (2, 3, 32, 32, 4)
    assert img.shape == ref_img.shape == (2, 32, 32, 4)
    with torch.inference_mode():   # the STN really translates
        theta = model.run_global_g(torch.from_numpy(z), noise_mode='const')[1]
    assert theta[..., 2].abs().max() > 0.05
    _assert_agree(placed, ref_placed, num_fp16_res)
    _assert_agree(img, ref_img, num_fp16_res)


def test_random_noise_follows_the_seed(micro):
    _, _, np_tree = micro
    cfg, model = _port_model(np_tree)
    fn = tserving.build_inference_fn(cfg, model, noise_mode='random')
    z = torch.from_numpy(np.random.RandomState(3).randn(1, cfg.z_dim)
                         .astype(np.float32))
    a, b, c = fn(z, 5)[1], fn(z, 5)[1], fn(z, 6)[1]
    assert torch.equal(a, b) and not torch.equal(a, c)


_TEMPLATES = {}


def _shaped_snapshot_template(monkeypatch):
    """The JAX snapshot loader builds its template with an eager
    ``init_variables`` (hundreds of op-by-op compiles) and then overwrites
    every leaf with the snapshot's; zeros of the shapes that init traces give
    the same structure and so the same load.  Each config's zeros are built
    once a process (their ``eval_shape`` traces the whole init)."""
    eager = JaxEnsemble.init_variables

    def init_variables(self, key, batch=1, on_cpu=True):
        if (self.cfg, batch) not in _TEMPLATES:
            shapes = jax.eval_shape(
                lambda k: eager(self, k, batch=batch, on_cpu=False), key)
            _TEMPLATES[self.cfg, batch] = jax.tree_util.tree_map(
                lambda s: np.zeros(s.shape, s.dtype), shapes)
        return _TEMPLATES[self.cfg, batch]
    monkeypatch.setattr(JaxEnsemble, 'init_variables', init_variables)


def test_generate_cli_matches_jax(micro, tmp_path, monkeypatch):
    from click.testing import CliRunner
    from PIL import Image

    from montage_gan_tpu.cli.generate import main as jax_generate
    from montage_gan_tpu_torch.cli.generate import main as port_generate

    _shaped_snapshot_template(monkeypatch)
    cfg, tree, np_tree = micro
    snap = str(tmp_path / 'ema')
    jckpt.save_ema_snapshot(snap, cfg, tree)
    args = ['--network', snap + '.msgpack', '--seeds', '0-1',
            '--save-layers', '--trunc', '0.7']
    res = CliRunner().invoke(jax_generate,
                             args + ['--outdir', str(tmp_path / 'jax')])
    assert res.exit_code == 0, res.output
    port_generate(args + ['--outdir', str(tmp_path / 'port'),
                          '--device', 'cpu'])

    # the port's own checkpoint round-trips to the same pictures
    pcfg, model = tckpt.load_network(snap + '.msgpack', device='cpu')
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    tckpt.save_checkpoint(str(tmp_path / 'port.pt'), pcfg, model)
    port_generate(['--network', str(tmp_path / 'port.pt'), '--seeds', '0-1',
                   '--trunc', '0.7', '--outdir', str(tmp_path / 'port_ckpt'),
                   '--device', 'cpu'])

    jax_files = sorted(os.listdir(tmp_path / 'jax'))
    assert len(jax_files) == 2 * (1 + cfg.num_layers)
    assert sorted(os.listdir(tmp_path / 'port')) == jax_files
    for name in jax_files:
        ref = np.asarray(Image.open(tmp_path / 'jax' / name), np.int16)
        out = np.asarray(Image.open(tmp_path / 'port' / name), np.int16)
        assert out.shape == ref.shape and Image.open(
            tmp_path / 'port' / name).mode == 'RGBA'
        assert np.abs(out - ref).max() <= 1, name
    for name in ('seed0000.png', 'seed0001.png'):
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / 'port_ckpt' / name)),
            np.asarray(Image.open(tmp_path / 'port' / name)))


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax, flax,
    optax or the JAX package (read from the source: this process has them
    all loaded)."""
    root = Path(__file__).resolve().parent.parent / 'montage_gan_tpu_torch'
    banned = ('jax', 'jaxlib', 'flax', 'optax', 'montage_gan_tpu')
    # build/ is not source: it holds the kernels compiled at run time
    sources = [p for p in root.rglob('*.py')
               if (root / 'build') not in p.parents]
    sources.append(root.parent / 'chip_smoke.py')
    found = []
    for path in sorted(sources):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            for name in names:
                if name.split('.')[0] in banned:
                    found.append(f'{path.relative_to(root.parent)}: {name}')
    assert not found, found
    assert len(sources) >= 15
