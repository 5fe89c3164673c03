"""The serving artifact: ``export_model`` and ``utils/serving.py``'s export
half, and the kernels' ``torch.library`` operators, on the CPU.

One symbolic-batch artifact of a small ensemble (two layers, 8 px, a tanh
renderer, random synthesis noise, random biases and noise strengths) is
written by ``cli/export_model.py --verify --device cpu``; its reloaded
program is held to direct execution (``build_inference_fn``) at batch 1 and
3 within rtol 2e-4, atol 2e-5 (the JAX CLI's tolerance), and its graph holds
one ``mgt.bias_act`` node per K1' launch and one ``mgt.upfirdn2d`` node per
K2' launch of the sampling path (``tools/launches.py``).  On the CPU those
nodes run the plain versions.
"""

import collections
import json

import numpy as np
import pytest
import torch

from montage_gan_tpu_torch.cli import export_model
from montage_gan_tpu_torch.models.ensemble import MontageConfig, MontageEnsemble
from montage_gan_tpu_torch.ops import bias_act as tba
from montage_gan_tpu_torch.tools.launches import expected_launches
from montage_gan_tpu_torch.utils import checkpoint as tckpt
from montage_gan_tpu_torch.utils import serving

torch.set_num_threads(1)

SMALL = dict(layer_names=('a', 'b'), layer_targets=((8, 8), (8, 4)),
             base_resolution=8, img_channels=4, conv_config_index=2,
             z_dim=16, w_dim=16, mapping_num_layers=2, channel_base=64,
             channel_max=16, num_fp16_res=0, conv_clamp=256,
             renderer_type='tanh', stn_stages=1)
EXPORT_ARGS = ['--noise-mode', 'random', '--composite', 'renderer',
               '--trunc', '0.8']
# montage_gan_tpu/utils/serving.py:113-123, with 'device' for 'platforms'
JAX_META = {'z_dim', 'layer_names', 'base_resolution', 'truncation_psi',
            'noise_mode', 'composite', 'platforms', 'batch', 'outputs'}


def small_model():
    cfg = MontageConfig(**SMALL)
    model = MontageEnsemble(cfg).init_weights(0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(('bias', 'noise_strength')):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return cfg, model.eval().requires_grad_(False)


@pytest.fixture(scope='module')
def artifact(tmp_path_factory):
    """(path, export_model's metadata, the model) of one artifact written
    and verified by the CLI."""
    d = tmp_path_factory.mktemp('serve')
    cfg, model = small_model()
    tckpt.save_checkpoint(str(d / 'small.pt'), cfg, model)
    path = str(d / 'small.pt2')
    meta = export_model.main(['--network', str(d / 'small.pt'), '--out',
                              path, '--verify', '--device', 'cpu',
                              *EXPORT_ARGS])
    return path, meta, model


@pytest.fixture(scope='module')
def loaded(artifact):
    return serving.load_file(artifact[0])


def test_export_model_cli_verifies(artifact):
    _, meta, _ = artifact
    assert set(meta) == JAX_META - {'platforms'} | {'device'}
    assert meta['device'] == 'cpu' and meta['batch'] is None
    assert (meta['noise_mode'], meta['composite'],
            meta['truncation_psi']) == ('random', 'renderer', 0.8)


@pytest.mark.parametrize('batch', [1, 3])
def test_artifact_matches_direct_execution(artifact, loaded, batch):
    _, _, model = artifact
    meta, call = loaded
    fn = serving.build_inference_fn(model.cfg, model, truncation_psi=0.8,
                                    noise_mode='random', composite='renderer')
    z = torch.from_numpy(np.random.RandomState(batch).randn(batch, 16)
                         .astype(np.float32))
    for seed in (0, 11):
        got, ref = call(z, seed), fn(z, seed)
        assert [tuple(t.shape) for t in got] == [(batch, 2, 8, 8, 4),
                                                 (batch, 8, 8, 4)]
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    # the seed reaches the random noise
    assert not torch.equal(call(z, 0)[1], call(z, 11)[1])


def test_artifact_graph_holds_the_kernel_ops(artifact, loaded):
    _, _, model = artifact
    nodes = collections.Counter(str(n.target)
                                for n in loaded[1].program.graph.nodes
                                if str(n.target).startswith('mgt.'))
    expect = expected_launches(model)
    assert nodes == {'mgt.bias_act.default': expect['bias_act'],
                     'mgt.upfirdn2d.default': expect['upfirdn2d']}


def test_pinned_batch_and_alpha_composite(tmp_path):
    cfg, model = small_model()
    blob = serving.export_generator(cfg, model, batch=2)
    meta, call = serving.load_exported(blob)
    assert meta['batch'] == 2 and meta['composite'] == 'alpha'
    z = torch.randn(2, 16, generator=torch.Generator().manual_seed(0))
    ref = serving.build_inference_fn(cfg, model)(z)
    for a, b in zip(call(z), ref):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    with pytest.raises(Exception):
        call(torch.zeros(3, 16))


def test_load_refuses_foreign_files(tmp_path):
    torch.save({'x': torch.zeros(2)}, tmp_path / 'ckpt.pt')
    foreign = [b'\x00' * 64,
               # the JAX package's artifact header
               b'MGTSERVE\x00\x01\x00\x00\x00\x00\x00\x00' + b'\x00' * 32,
               (tmp_path / 'ckpt.pt').read_bytes()]
    for data in foreign:
        with pytest.raises(ValueError, match='not a montage_gan_tpu_torch'):
            serving.load_exported(data)


def test_export_model_refuses_platforms(tmp_path, capsys):
    with pytest.raises(SystemExit):
        export_model.main(['--network', 'x.pt', '--out', 'y', '--platforms',
                           'tpu,cpu'])
    assert '--device' in capsys.readouterr().err


def test_eager_calls_launch_directly(monkeypatch):
    """Outside an export the wrappers never take the operators."""
    from montage_gan_tpu_torch.ops import upfirdn2d as tup

    def refuse(*args):
        raise AssertionError('operator called outside an export')
    monkeypatch.setattr(tba, 'bias_act_op', refuse)
    monkeypatch.setattr(tup, 'upfirdn2d_op', refuse)
    cfg, model = small_model()
    placed, img = serving.build_inference_fn(cfg, model)(torch.zeros(1, 16))
    assert torch.isfinite(img).all()


@pytest.mark.parametrize('act', ['linear', 'lrelu', 'tanh', 'swish'])
def test_bias_act_grad_op_is_the_plain_gradient(act):
    """``mgt::bias_act_grad`` on the CPU (order 1) is the gradient of the
    plain version; it stays a node when exported."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 8, generator=g) * 2
    b = torch.randn(8, generator=g)
    dy = torch.randn(3, 5, 8, generator=g)
    clamp = 1.5 if act in ('linear', 'lrelu') else None
    _, alpha, gain = tba._resolve(act, None, None, clamp)
    xr = x.clone().requires_grad_(True)
    y = tba.bias_act_ref(xr, b, act=act, clamp=clamp)
    ref, = torch.autograd.grad(y, xr, dy)
    got = torch.ops.mgt.bias_act_grad(dy, x, b, y.detach(), None, 1, act,
                                      alpha, gain, clamp)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)

    class Grad(torch.nn.Module):
        def forward(self, dy, x, y):
            return tba.bias_act_grad_op(dy, x, b, y, None, 1, act, alpha,
                                        gain, clamp)
    program = torch.export.export(Grad(), (dy, x, y.detach()))
    assert 'mgt.bias_act_grad.default' in {str(n.target)
                                           for n in program.graph.nodes}


def test_seed_draws_are_a_function_of_the_seed():
    def draw(seed, shape=(64, 64, 32)):
        return serving.SeedDraws(torch.tensor(seed)).normal(shape, 'noise')
    a, b = draw(3), draw(3)
    assert torch.equal(a, b) and not torch.equal(a, draw(4))
    two = serving.SeedDraws(torch.tensor(3))
    first, second = two.normal((8,), 'n'), two.normal((8,), 'n')
    assert not torch.equal(first, second)     # each draw its own stream
    assert abs(a.mean().item()) < 0.01 and abs(a.std().item() - 1) < 0.01
    assert json.dumps(serving.MAGIC)
