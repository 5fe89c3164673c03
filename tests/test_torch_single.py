"""The single-GAN slice of the port against the JAX package, on the CPU: the
conditional D, the monolithic ``Generator`` with ``truncation_cutoff``, a
labelled training step (and one with Freeze-D), ``.pkl`` transfer into a
train state, ``url_util``, ``run-recipe``, ``calc-metrics`` of a ``.pkl``,
the ``train`` CLI, and two gloo ranks of a labelled step.

Micro sizes and seeded numpy inputs throughout.  The JAX functions are
jitted with ``FAST_COMPILE``; weights cross by ``utils/weights.py``, and
the zero-initialised terms (biases, noise strengths, ``w_avg``) are given
random values so that they do work.  The step tests inject JAX's draws
through the port's ``Draws`` seam as ``tests/test_torch_step.py`` does (z
and path-length noise of each phase from the keys the JAX step folds, the
synthesis noise a fixed field), and each phase's permutation of the label
pool from the JAX step's ``permutation(fold_in(k, 2), ...)``.

JAX is imported inside the tests, not at the top: the gloo ranks spawned
by ``test_ranks_with_labels_equal_one_process`` import this module.

Tolerances: D logits and the generator's image ``atol 1e-4``, gradients
within ``1e-3`` of the tensor's largest JAX gradient (those of
``tests/test_torch_train.py``); the step within the bounds of
``tests/test_torch_step.py`` (parameters and EMA ``atol 2e-5`` outside the
entries whose gradient is below 1e-6 of the tensor's largest, stats rtol
1e-4); the transfer, the dataset-tool outputs and the metrics' results
exactly; the ranks within ``tests/test_torch_ddp.py``'s bounds.
"""

import dataclasses
import functools
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from montage_gan_tpu_torch.cli import calc_metrics, convert_pickle, run_recipe
from montage_gan_tpu_torch.cli import train as ttrain_cli
from montage_gan_tpu_torch.data.synthetic import make_synthetic_layer_dataset
from montage_gan_tpu_torch.models.discriminator import Discriminator
from montage_gan_tpu_torch.models.ensemble import MontageConfig, MontageEnsemble
from montage_gan_tpu_torch.parallel import distributed, mesh
from montage_gan_tpu_torch.tools.ddp_check import rank_rows
from montage_gan_tpu_torch.tools.seeded import (seeded_generator,
                                                write_persistence_pkl)
from montage_gan_tpu_torch.training import augment as taug
from montage_gan_tpu_torch.training import train_step as ttrain
from montage_gan_tpu_torch.utils import pkl_import as tpkl
from montage_gan_tpu_torch.utils import url_util as turl
from montage_gan_tpu_torch.utils import weights
from montage_gan_tpu_torch.utils.png import write_png

torch.set_num_threads(1)

# test_torch_train.py's micro widths, one RGB layer, a 4x4 start and no
# global path: the single-GAN ensemble of cli/train.py
MICRO_SINGLE = dict(layer_names=('image',), layer_targets=((8, 8),),
                    base_resolution=8, img_channels=3, conv_config_index=2,
                    z_dim=16, w_dim=16, c_dim=3, mapping_num_layers=2,
                    channel_base=64, channel_max=16, num_fp16_res=0,
                    conv_clamp=256, mbstd_group_size=2,
                    use_global_mapping=False, train_global=False,
                    renderer_type='none')
BATCH = 4
# test_torch_step.py's step: p = 0, ADA every step with a target below
# every mean sign
HYPER = dict(batch_size=BATCH, train_global=False, train_renderer=False,
             bypass_renderer=True, style_mixing_prob=0.0, augment_p_init=0.0,
             ada_interval=1, ada_target=-2.0)
ATOL = 2e-5
SMALL_GRAD = 1e-6
GRAD_RTOL = 1e-3
G_KW = dict(z_dim=16, w_dim=16, img_channels=3, c_dim=3,
            mapping_kwargs=dict(num_layers=2),
            synthesis_kwargs=dict(channel_base=64, channel_max=16,
                                  num_fp16_res=0, conv_clamp=256))


def _fast():
    from test_torch_train import FAST_COMPILE
    return FAST_COMPILE


def _np(tree):
    import jax
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _labels(n, seed, c_dim=3):
    rng = np.random.RandomState(seed)
    return np.eye(c_dim, dtype=np.float32)[rng.randint(0, c_dim, n)]


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

D_CASES = {'c3': dict(c_dim=3), 'c5-cmap7-freeze1': dict(c_dim=5, cmap_dim=7,
                                                         freeze_layers=1)}


@pytest.mark.parametrize('case', sorted(D_CASES))
def test_conditional_discriminator_matches_jax(case):
    """The projection head: the label map (``mapping``: no z, no w_avg) and
    ``sum(x · cmap) / sqrt(cmap_dim)``; logits and every gradient, with the
    weights crossed by ``weights.discriminator_state_dict`` under the
    reference's names."""
    import jax
    import jax.numpy as jnp
    from montage_gan_tpu.models import discriminator as jdisc
    from test_torch_train import _assert_grads, _perturb
    kw = dict(img_resolution=16, img_channels=3, init_res=(4, 4),
              conv_config_index=2, channel_base=128, channel_max=16,
              num_fp16_res=0, conv_clamp=256, mbstd_group_size=2,
              **D_CASES[case])
    c_dim = kw['c_dim']
    jnet, tnet = jdisc.Discriminator(**kw), Discriminator(**kw)
    rng = np.random.RandomState(0)
    img = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    c = _labels(4, 1, c_dim)
    r = rng.randn(4, 1).astype(np.float32)
    init = jax.jit(jnet.init, compiler_options=_fast())
    variables = _perturb(init(jax.random.PRNGKey(0), jnp.asarray(img),
                              jnp.asarray(c)), seed=1)
    sd = weights.discriminator_state_dict(_np(variables))
    assert list(sd) == list(tnet.state_dict())
    assert 'mapping.embed.weight' in sd and 'mapping.w_avg' not in sd
    assert sd['b4.out.weight'].shape[0] == kw.get('cmap_dim', 16)
    tnet.load_state_dict(sd)

    @functools.partial(jax.jit, compiler_options=_fast())
    def run(params):
        def loss(p):
            out = jnet.apply({**variables, 'params': p}, jnp.asarray(img),
                             jnp.asarray(c))
            return jnp.sum(out * r), out
        return jax.value_and_grad(loss, has_aux=True)(params)
    (_, ref), grads = run(variables['params'])
    ref_grads = weights.discriminator_state_dict(_np({'params': grads}))
    out = tnet(torch.from_numpy(img), torch.from_numpy(c))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-4)
    params = dict(tnet.named_parameters())
    got = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                              list(params.values()), allow_unused=True)
    port = {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), got)}
    if kw.get('freeze_layers'):
        assert not port['b16.fromrgb.weight'].abs().any()
    _assert_grads(port, {k: ref_grads[k] for k in port}, GRAD_RTOL)
    with pytest.raises(ValueError, match='needs a label'):
        tnet(torch.from_numpy(img))


def test_generator_truncation_cutoff_matches_jax():
    """The monolithic mapping + synthesis ``Generator`` (conditional, the
    reference's submodule order) with ``truncation_psi`` applied to the
    first ``truncation_cutoff`` ws only."""
    import jax
    import jax.numpy as jnp
    from montage_gan_tpu.models.synthesis import Generator as JaxGenerator
    from montage_gan_tpu_torch.models.synthesis import Generator
    from test_torch_train import _perturb
    kw = dict(img_resolution=16, img_channels=3, z_dim=8, w_dim=8, c_dim=2,
              mapping_num_layers=2, channel_base=64, channel_max=16,
              conv_clamp=256)
    jnet, tnet = JaxGenerator(**kw), Generator(**kw)
    assert [n for n, _ in tnet.named_children()] == ['synthesis', 'mapping']
    rng = np.random.RandomState(4)
    z = rng.randn(3, 8).astype(np.float32)
    c = _labels(3, 5, 2)
    variables = _perturb(jax.jit(jnet.init, compiler_options=_fast())(
        {'params': jax.random.PRNGKey(1), 'noise': jax.random.PRNGKey(2)},
        jnp.asarray(z), jnp.asarray(c)), seed=3)
    v = _np(variables)
    sd = {f'mapping.{k}': t for k, t in weights.mapping_state_dict(
        {'params': v['params']['mapping'],
         'moving_stats': v['moving_stats']['mapping']}).items()}
    sd.update({f'synthesis.{k}': t for k, t in weights.synthesis_state_dict(
        {'params': v['params']['synthesis'],
         'noise': v['noise']['synthesis']}).items()})
    tnet.load_state_dict(sd)
    assert tnet.num_ws == jnet.num_ws
    for psi, cutoff in ((0.6, 2), (0.6, None), (1.0, None)):
        ref = jax.jit(functools.partial(
            jnet.apply, truncation_psi=psi, truncation_cutoff=cutoff,
            noise_mode='const'), compiler_options=_fast())(
            variables, jnp.asarray(z), jnp.asarray(c))
        out = tnet(torch.from_numpy(z), torch.from_numpy(c),
                   truncation_psi=psi, truncation_cutoff=cutoff,
                   noise_mode='const')
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-4, err_msg=str(cutoff))
    ws = tnet.mapping(torch.from_numpy(z), torch.from_numpy(c),
                      truncation_psi=0.6, truncation_cutoff=2)
    full = tnet.mapping(torch.from_numpy(z), torch.from_numpy(c))
    assert torch.equal(ws[:, 2:], full[:, 2:])
    assert not torch.equal(ws[:, :2], full[:, :2])


# ---------------------------------------------------------------------------
# A labelled training step, and Freeze-D
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_single(freeze):
    """(config, JAX ensemble, variables with random zero-init terms, numpy
    copy) of the conditional micro ensemble."""
    import jax
    from montage_gan_tpu.models.ensemble import MontageConfig as JaxConfig
    from montage_gan_tpu.models.ensemble import MontageEnsemble as JaxEns
    from test_torch_train import _perturb
    cfg = JaxConfig(**MICRO_SINGLE, freeze_d_layers=freeze)
    ens = JaxEns(cfg)
    init = jax.jit(lambda k: ens.init_variables(k, on_cpu=False),
                   compiler_options=_fast())
    variables = _perturb(init(jax.random.PRNGKey(0)), seed=2)
    return cfg, ens, variables, _np(variables)


def _reals():
    rng = np.random.RandomState(9)
    crops = rng.uniform(-1, 1, (BATCH, 8, 8, 3)).astype(np.float32)
    return crops, _labels(BATCH, 10), _labels(BATCH, 11)


def _jax_draws(cfg, key):
    """z, path-length noise and label permutation of step 0's phases in the
    port's order (Gmain, Greg, Dmain: phases 1, 2, 3 of the JAX step)."""
    import jax
    import jax.numpy as jnp
    z, pl, perms = [], [], []
    for idx in (1, 2, 3):
        k = jax.random.fold_in(key, idx)
        z.append(np.array(jax.random.normal(jax.random.fold_in(k, 0),
                                            (BATCH, cfg.z_dim))))
        perms.append(np.array(jax.random.permutation(
            jax.random.fold_in(k, 2), jnp.arange(BATCH))))
        if idx == 2:
            k_pl = jax.random.split(jax.random.fold_in(k, 1), 3)[2]
            pl.append(np.array(jax.random.normal(
                k_pl, (BATCH // 2, 8, 8, 3))))
    return z, pl, perms


def _label_draws(z, pl, perms):
    from test_torch_train import InjectedDraws

    class LabelDraws(InjectedDraws):
        """JAX's z, path-length noise and label permutations."""

        def __init__(self):
            super().__init__(z=z, pl_noise=pl)
            self.perms = list(perms)

        def permutation(self, n, kind):
            assert kind == 'gen_c'
            p = torch.from_numpy(np.asarray(self.perms.pop(0), np.int64))
            assert p.numel() == n
            return p
    return LabelDraws()


@pytest.fixture(scope='module', params=[0, 2], ids=['cond', 'cond-freeze2'])
def labelled_step(request):
    """Step 0 of the conditional micro ensemble (Freeze-D of 2 layers in
    the second case) in JAX's ``partial_step`` and in the port's
    ``train_step``, on the same weights, reals, labels and draws."""
    import jax
    import jax.numpy as jnp
    from montage_gan_tpu.training import augment as jaug
    from montage_gan_tpu.training import train_step as jtrain
    from test_torch_step import record_grads
    from test_torch_train import inject_jax_synthesis_noise
    freeze = request.param
    cfg, ens, variables, np_tree = jax_single(freeze)
    mp = pytest.MonkeyPatch()
    inject_jax_synthesis_noise(mp)
    trainer = jtrain.MontageTrainer(ens, jtrain.TrainHyper(
        augment=jaug.AugmentConfig(brightness=1), **HYPER))
    state = trainer.state_from_variables(variables)
    crops, real_c, gen_c = _reals()
    stack = jnp.zeros((BATCH, 1, 8, 8, 3))
    key = jax.random.PRNGKey(11)
    jstate, jstats = jax.jit(lambda s, k: trainer.partial_step(
        s, stack, (jnp.asarray(crops),), k, do_global=False,
        do_renderer=False, real_c=jnp.asarray(real_c),
        gen_c=jnp.asarray(gen_c)), compiler_options=_fast())(state, key)
    mp.undo()

    tcfg = MontageConfig(**MICRO_SINGLE, freeze_d_layers=freeze)
    tens = MontageEnsemble(tcfg, with_d=True)
    tens.load_state_dict(weights.state_dict_from_jax(tcfg, np_tree))
    trainer = ttrain.MontageTrainer(tens, ttrain.TrainHyper(
        augment=taug.AugmentConfig(brightness=1), **HYPER), device='cpu')
    tstate = trainer.state_from_variables(tens.state_dict())
    before = {k: v.clone() for k, v in tens.local_d[0].state_dict().items()}
    grads = {}
    trainer.phase_hook = lambda name, g: grads.__setitem__(name, g)
    mp = pytest.MonkeyPatch()
    ratio = record_grads(mp)
    tstate, tstats = trainer.train_step(
        tstate, None, [crops], _label_draws(*_jax_draws(cfg, key)),
        real_c=real_c, gen_c=gen_c)
    mp.undo()
    return dict(cfg=tcfg, tens=tens, state=tstate, stats=tstats,
                ratio=ratio, jstate=jstate, jstats=jstats, before=before,
                grads=grads, freeze=freeze)


def test_labelled_step_matches_jax(labelled_step):
    """Gmain, Greg, Dmain and Dr1 with labels, then EMA and ADA: stats,
    parameters, EMA, w_avg, pl_mean and ADA's p."""
    import jax
    s = labelled_step
    tens, state, jstate = s['tens'], s['state'], s['jstate']
    assert state.step == int(jstate.step) == 1
    assert set(s['stats']) == set(s['jstats'])
    for k, v in s['stats'].items():
        np.testing.assert_allclose(float(v), float(s['jstats'][k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(state.pl_mean.numpy(),
                               np.asarray(jstate.pl_mean), rtol=0, atol=ATOL)
    np.testing.assert_allclose(state.aug_p.numpy(), np.asarray(jstate.aug_p),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        tens.mapping.w_avg.numpy(),
        np.asarray(jstate.variables['mapping']['moving_stats']['w_avg']),
        rtol=0, atol=1e-6)
    ref = weights.state_dict_from_jax(s['cfg'], _np(jstate.variables))
    ref_ema = weights.state_dict_from_jax(s['cfg'], _np(jstate.ema))
    for name, p in tens.named_parameters():
        keep = s['ratio'][id(p)] >= SMALL_GRAD
        diff = (p.detach() - ref[name]).abs()
        assert diff[keep].max() <= ATOL, (name, diff[keep].max())
    for name, p in state.ema.named_parameters():
        assert (p - ref_ema[name]).abs().max() <= ATOL, name
    # the label map of D and the embed of G moved
    assert 'local_d.0.mapping.fc0.weight' in ref
    assert 'mapping.embed.weight' in ref


def test_freeze_d_keeps_first_layers(labelled_step):
    """Freeze-D: the first ``freeze`` layers of D (``b8.fromrgb``,
    ``b8.conv0``) get no gradient in Dmain and Dr1 and are bit-identical
    after the step; every other D tensor moved."""
    s = labelled_step
    frozen = ('b8.fromrgb.', 'b8.conv0.')[:s['freeze']]
    after = s['tens'].local_d[0].state_dict()
    names = [k for k, _ in s['tens'].local_d[0].named_parameters()]
    for phase in ('image/Dmain', 'image/Dr1'):
        for k, g in zip(names, s['grads'][phase]):
            if k.startswith(frozen):
                assert g is None, (phase, k)
    for k, v in after.items():
        if k.endswith('resample_filter'):
            continue
        if k.startswith(frozen):
            assert torch.equal(v, s['before'][k]), k
        else:
            assert not torch.equal(v, s['before'][k]), k


# ---------------------------------------------------------------------------
# .pkl transfer
# ---------------------------------------------------------------------------

def _seeded_pkl(path, res, seed=0):
    """A reference SG2-ADA ``.pkl``: G and G_ema (seeded generators) and D
    (seeded, its biases random), all conditional (c_dim 3)."""
    kw = dict(G_KW, img_resolution=res)
    d_kw = dict(c_dim=3, img_resolution=res, img_channels=3,
                channel_base=64, channel_max=16, mbstd_group_size=2,
                conv_clamp=256, init_res=[4, 4])
    d = Discriminator(**{k: v for k, v in d_kw.items() if k != 'init_res'})
    g = torch.Generator().manual_seed(seed + 5)
    with torch.no_grad():
        d.reset_parameters(g)
        for name, t in d.named_parameters():
            if name.endswith('bias'):
                t.add_(torch.randn(t.shape, generator=g) * 0.1)
    return write_persistence_pkl(
        path, {'G': seeded_generator(kw, seed=seed),
               'D': d, 'G_ema': seeded_generator(kw, seed=seed + 1)},
        init_kwargs={'G': kw, 'D': d_kw, 'G_ema': kw})


@dataclasses.dataclass(frozen=True)
class _JaxState:
    """What the JAX ``transfer_into_train_state`` reads of a train state."""
    variables: dict
    ema: dict

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@pytest.mark.parametrize('res', [8, 16], ids=['same-res', 'other-res'])
def test_transfer_into_train_state_matches_jax(res, tmp_path, capsys):
    """G, D and G_ema of a seeded ``.pkl`` (at the state's 8 px, and at
    16 px) into a zeroed 1-layer train state, in JAX and in the port: the
    same ``copied N tensors, skipped M`` line and equal tensors (the copied
    ones the pickle's, the others zero)."""
    import jax
    from montage_gan_tpu.models.ensemble import MontageConfig as JaxConfig
    from montage_gan_tpu.models.ensemble import MontageEnsemble as JaxEns
    from montage_gan_tpu.utils import pkl_import as jpkl
    path = _seeded_pkl(str(tmp_path / 'net.pkl'), res)
    jens = JaxEns(JaxConfig(**MICRO_SINGLE))
    shapes = jax.eval_shape(lambda k: jens.init_variables(k, on_cpu=False),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    zeros = {k: (tuple(v) if isinstance(v, list) else v)
             for k, v in zeros.items()}
    jstate = jpkl.transfer_into_train_state(
        _JaxState(zeros, {k: zeros[k] for k in ('mapping', 'local_g')}),
        path)
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]

    cfg = MontageConfig(**MICRO_SINGLE)
    trainer = ttrain.MontageTrainer(MontageEnsemble(cfg, with_d=True),
                                    ttrain.TrainHyper(**HYPER), device='cpu')
    state = trainer.init_state(0)
    with torch.no_grad():
        for module in (state.model, state.ema):
            for k, t in module.state_dict().items():
                if not k.endswith('resample_filter'):
                    t.zero_()
    tpkl.transfer_into_train_state(state, path)
    assert capsys.readouterr().out.strip() == ref_line
    assert ref_line.startswith('transfer_into_train_state: copied')
    for module, tree in ((state.model, jstate.variables),
                         (state.ema, jstate.ema)):
        ref = weights.state_dict_from_jax(cfg, _np(tree))
        got = module.state_dict()
        for k, v in ref.items():
            if k in got:
                assert torch.equal(got[k], v), k
    copied = int(ref_line.split('copied ')[1].split()[0])
    skipped = int(ref_line.split('skipped ')[1])
    assert copied > 0 and (skipped > 0) == (res != 8)


# ---------------------------------------------------------------------------
# url_util
# ---------------------------------------------------------------------------

class _Response:
    def __init__(self, data, name):
        self.data, self.headers = data, {
            'Content-Disposition': f'attachment; filename="{name}"'}

    def read(self):
        return self.data

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_url_util_matches_jax(tmp_path, monkeypatch):
    """A local path, a ``file://`` URL, an alias already in a seeded
    ``MGT_CACHE_DIR``, and a URL whose download is answered by a patched
    ``urlopen`` (no test reaches the network): the same files and run-desc
    suffixes from the port's copy as from the JAX package's."""
    from montage_gan_tpu.utils import url_util as jurl
    calls = []

    def urlopen(url, timeout=None):
        calls.append(url)
        return _Response(b'downloaded bytes', 'net.pkl')
    monkeypatch.setattr(urllib.request, 'urlopen', urlopen)
    monkeypatch.setenv('MGT_CACHE_DIR', str(tmp_path / 'cache'))
    local = tmp_path / 'snap.pt'
    local.write_bytes(b'local')
    url = turl.RESUME_SPECS['ffhq256']
    assert turl.RESUME_SPECS == jurl.RESUME_SPECS
    cached = os.path.join(turl.make_cache_dir_path('downloads'),
                          __import__('hashlib').md5(url.encode()).hexdigest()
                          + '_ffhq.pkl')
    os.makedirs(os.path.dirname(cached))
    with open(cached, 'wb') as f:
        f.write(b'cached')
    for mod in (jurl, turl):
        assert mod.make_cache_dir_path('x') == str(tmp_path / 'cache' / 'x')
        assert mod.open_url(str(local), return_filename=True) == str(local)
        with mod.open_url(f'file://{local}') as f:
            assert f.read() == b'local'
        assert mod.resolve_resume('ffhq256') == (cached, '-resumeffhq256')
        assert mod.resolve_resume('noresume') == (None, '-noresume')
        assert mod.resolve_resume(None) == (None, '')
        assert mod.resolve_resume(str(local)) == (str(local),
                                                  '-resumecustom')
        assert mod.resolve_resume('https://example.com/a.pkl',
                                  fetch=False) == (
            'https://example.com/a.pkl', '-resumecustom')
        assert mod.is_url('https://example.com/a.pkl')
        assert not mod.is_url('snap.pt')
    assert calls == []
    got = [mod.open_url('https://example.com/x/net.pkl',
                        return_filename=True) for mod in (jurl, turl)]
    assert calls == ['https://example.com/x/net.pkl']  # the second: cached
    assert got[0] == got[1] and open(got[1], 'rb').read() == \
        b'downloaded bytes'


# ---------------------------------------------------------------------------
# run-recipe
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def layers(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('recipe') / 'layers')
    make_synthetic_layer_dataset(path, num_samples=2)
    return path


@pytest.mark.parametrize('recipe', sorted(run_recipe.RECIPES))
def test_run_recipe_dry_run_matches_jax(recipe, layers, tmp_path, capsys):
    """Each recipe with an override: the same ``run-recipe <name>:
    train-aio ...`` line as the JAX CLI, then the port's ``train_aio`` dry
    run; a recipe that needs ``--resume`` refuses to run without it."""
    from click.testing import CliRunner
    from montage_gan_tpu.cli.run_recipe import RECIPES, CANONICAL
    from montage_gan_tpu.cli.run_recipe import main as jax_recipe
    assert run_recipe.RECIPES == RECIPES and run_recipe.CANONICAL == CANONICAL
    args = [recipe, '--data', layers, '--outdir', str(tmp_path / 'o'),
            '--dry-run', '--kimg', '100', '--save-all-layers']
    if RECIPES[recipe][0]:
        args += ['--resume', str(tmp_path / 'snap.pt')]
    res = CliRunner().invoke(jax_recipe, args)
    assert res.exit_code == 0, res.output
    ref = [ln for ln in res.output.splitlines()
           if ln.startswith('run-recipe')]
    assert run_recipe.main(args) is None
    out = capsys.readouterr().out
    assert [ln for ln in out.splitlines() if ln.startswith('run-recipe')] \
        == ref and len(ref) == 1
    assert 'Dry run; exiting.' in out
    if RECIPES[recipe][0]:
        assert CliRunner().invoke(jax_recipe, args[:-2]).exit_code == 2
        with pytest.raises(SystemExit) as e:
            run_recipe.main(args[:-2])
        assert e.value.code == 2


# ---------------------------------------------------------------------------
# calc-metrics of a .pkl, and the train CLI
# ---------------------------------------------------------------------------

def _image_folder(root, n=12, res=8, labels=True):
    os.makedirs(root)
    rng = np.random.RandomState(6)
    names = []
    for i in range(n):
        names.append(f'img{i:03d}.png')
        write_png(os.path.join(root, names[-1]),
                  rng.randint(0, 256, (res, res, 3)).astype(np.uint8))
    with open(os.path.join(root, 'dataset.json'), 'w') as f:
        json.dump({'labels': [[k, i % 3] for i, k in enumerate(names)]
                   if labels else None}, f)
    return root


SMALL_FEATURES = 16


def _small_weights():
    """A small seeded random pyramid (one stage of 8 channels, 16 features):
    the Frechet distance's square root stays cheap."""
    rng = np.random.RandomState(8)
    return [rng.randn(3, 3, 3, 8).astype(np.float32) / 5,
            rng.randn(8, SMALL_FEATURES).astype(np.float32) / 3]


@pytest.fixture
def pkl_metrics(tmp_path, monkeypatch):
    """A seeded micro unconditional ``.pkl`` (its G_ema), its
    ``convert-pickle`` snapshot, a flat folder of 32 RGB images (more than
    the features, so that the covariances have full rank), the port's
    ``calc-metrics`` arguments, and the port's detector patched to the
    small pyramid."""
    from montage_gan_tpu_torch.metrics import features
    small = _small_weights()
    monkeypatch.setattr(features, 'build_extractor',
                        lambda name, device='cuda': features.RandomFeatures(
                            weights=small, device=device))
    kw = dict(G_KW, img_resolution=8, c_dim=0)
    pkl = write_persistence_pkl(str(tmp_path / 'net.pkl'), {
        'G_ema': seeded_generator(kw, seed=3)}, init_kwargs={'G_ema': kw})
    snap = convert_pickle.main(['--source', pkl, '--dest',
                                str(tmp_path / 'net.pt')])
    data = _image_folder(str(tmp_path / 'data'), n=32, labels=False)
    args = ['--data', data, '--metrics', 'fid2k,ppl2_wend', '--extractor',
            'random', '--batch', '250', '--ppl-samples', '8']
    return dict(pkl=pkl, snap=snap, data=data, args=args, small=small)


def test_calc_metrics_of_pkl_equals_its_snapshot(pkl_metrics, tmp_path):
    """``calc-metrics`` of a seeded micro ``.pkl`` (its G_ema on a flat
    dataset) and of its ``convert-pickle`` snapshot: the same results
    (``fid2k`` on the dataset and ``ppl2_wend``) exactly."""
    pkl, snap = pkl_metrics['pkl'], pkl_metrics['snap']
    base = [*pkl_metrics['args'], '--device', 'cpu']
    a = calc_metrics.main(['--network', pkl, *base, '--cache-dir',
                           str(tmp_path / 'c1')])
    b = calc_metrics.main(['--network', snap, *base, '--cache-dir',
                           str(tmp_path / 'c2')])
    for x, y in zip(a, b):
        assert dict(x.results) == dict(y.results)
    assert np.isfinite(a[0].results['fid2k'])
    with open(tmp_path / 'metric-fid2k.jsonl') as f:
        assert [json.loads(ln)['snapshot_pkl'] for ln in f] == [pkl, snap]


def test_calc_metrics_of_pkl_matches_jax(pkl_metrics, tmp_path, monkeypatch):
    """``calc-metrics`` of the seeded micro ``.pkl`` through the port and
    through the JAX CLI (click's runner) on the same flat folder and
    detector, the port given the JAX loops' z (the generator loop's and
    PPL's key streams): ``fid2k`` within rtol 1e-3 (float32 images and
    features in another order, as ``tests/test_torch_metrics.py``'s FID
    loops), ``ppl2_wend`` within rtol 5e-2 (its distances divide by
    1e-8, as there)."""
    import jax
    import jax.numpy as jnp
    from click.testing import CliRunner
    from montage_gan_tpu.cli import calc_metrics as jcalc
    from montage_gan_tpu.metrics import features as jfeatures
    from montage_gan_tpu_torch.metrics import metric_utils as tutils
    from test_torch_tools import fast_jit

    jex = jfeatures.RandomFeatures(num_stages=1, width=8)
    jex.feature_dim = SMALL_FEATURES
    jex._build(3)
    jex._params = [jnp.asarray(w) for w in pkl_metrics['small']]
    monkeypatch.setattr(jfeatures, 'build_extractor', lambda *a, **k: jex)
    fast_jit(monkeypatch)

    def keys(seed, k, parts):
        key = jax.random.PRNGKey(seed)
        for _ in range(k + 1):
            key, *sub = jax.random.split(key, parts)
        return sub

    def generator_draws(seed, k, n, z_dim):
        return np.array(jax.random.normal(keys(seed, k, 2)[0], (n, z_dim)))

    def ppl_draws(seed, k, n, z_dim, sampling):
        assert sampling == 'end'
        k0, k1, _ = keys(seed, k, 4)
        return (np.array(jax.random.normal(k0, (n, z_dim))),
                np.array(jax.random.normal(k1, (n, z_dim))),
                np.zeros((n, 1), np.float32))
    monkeypatch.setattr(tutils, 'generator_draws', generator_draws)
    monkeypatch.setattr(tutils, 'ppl_draws', ppl_draws)

    pkl = pkl_metrics['pkl']
    got = calc_metrics.main(['--network', pkl, *pkl_metrics['args'],
                             '--device', 'cpu', '--cache-dir',
                             str(tmp_path / 'c1')])
    res = CliRunner().invoke(jcalc.main, [
        '--network', pkl, *pkl_metrics['args'], '--cache-dir',
        str(tmp_path / 'c2')])
    assert res.exit_code == 0, res.output
    with open(os.path.join(os.path.dirname(pkl), 'metric-fid2k.jsonl')) as f:
        fid = [json.loads(ln)['results']['fid2k'] for ln in f]
    with open(os.path.join(os.path.dirname(pkl),
                           'metric-ppl2_wend.jsonl')) as f:
        ppl = [json.loads(ln)['results']['ppl2_wend'] for ln in f]
    assert fid[0] == got[0].results['fid2k']
    assert ppl[0] == got[1].results['ppl2_wend']
    assert np.isfinite(fid[1]) and fid[1] > 0
    np.testing.assert_allclose(fid[0], fid[1], rtol=1e-3)
    np.testing.assert_allclose(ppl[0], ppl[1], rtol=5e-2)


def test_calc_metrics_refuses_a_local_only_ensemble(tmp_path):
    """A snapshot of several layers without the global path
    (``train_aio --train-global false``) has no composite to score:
    ``calc-metrics`` raises, where a single-GAN snapshot is scored on a
    flat dataset."""
    from montage_gan_tpu_torch.utils import checkpoint as tckpt
    cfg = MontageConfig(**dict(
        MICRO_SINGLE, layer_names=('a', 'b'), layer_targets=((8, 8),) * 2,
        img_channels=4, c_dim=0))
    assert not cfg.single_gan and MontageConfig(**MICRO_SINGLE).single_gan
    snap = str(tmp_path / 'ema-snapshot-000000.pt')
    tckpt.save_ema_snapshot(snap, cfg, MontageEnsemble(cfg).init_weights(0))
    with pytest.raises(ValueError, match='without the global path'):
        calc_metrics.main(['--network', snap, '--data', str(tmp_path),
                           '--extractor', 'random', '--device', 'cpu'])


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """``train --cfg cifar --cond true --freezed 2`` for 2 steps on a
    labelled micro folder, and a ``--resume`` of its snapshot."""
    tmp = tmp_path_factory.mktemp('train')
    data = _image_folder(str(tmp / 'data'))
    base = ['--outdir', str(tmp / 'runs'), '--data', data, '--cfg', 'cifar',
            '--cond', 'true', '--freezed', '2', '--batch', '4', '--kimg',
            '0.008', '--channel-base', '64', '--channel-max', '16',
            '--snap', '1', '--device', 'cpu']
    state = ttrain_cli.main(base)
    run = os.path.join(str(tmp / 'runs'), sorted(os.listdir(tmp / 'runs'))[0])
    resumed = ttrain_cli.main([*base, '--resume', os.path.join(
        run, 'network-snapshot-000000.pt')])
    return dict(state=state, run=run, resumed=resumed, base=base, tmp=tmp)


def test_train_cli_writes_its_files(trained):
    """The run directory's files, finite stats, the cifar config's
    hyperparameters and a conditional, Freeze-D ensemble; the resume
    continues from the snapshot's step."""
    run, state = trained['run'], trained['state']
    assert os.path.basename(run) == '00000-data-cifar'
    assert {'log.txt', 'stats.jsonl', 'network-snapshot-000000.pt',
            'ema-snapshot-000000.pt', 'fakes000000.png'} <= \
        set(os.listdir(run))
    with open(os.path.join(run, 'stats.jsonl')) as f:
        stats = [json.loads(ln) for ln in f]
    assert stats and all(np.isfinite(v['mean']) for s in stats
                         for k, v in s.items() if isinstance(v, dict))
    assert 'image/Loss/D/loss' in stats[-1]
    cfg = state.model.cfg
    assert (cfg.c_dim, cfg.freeze_d_layers, cfg.mbstd_group_size,
            cfg.conv_config_index, cfg.img_channels) == (3, 2, 32, 2, 3)
    assert state.step == 2 and trained['resumed'].step == 4
    with open(os.path.join(run, 'log.txt')) as f:
        assert 'tick 0' in f.read()
    # generate of the conditional RGB EMA snapshot: its G with --class
    from montage_gan_tpu_torch.cli import generate
    out = str(trained['tmp'] / 'gen')
    generate.main(['--network', os.path.join(run, 'ema-snapshot-000000.pt'),
                   '--seeds', '0-1', '--class', '2', '--outdir', out,
                   '--device', 'cpu'])
    from PIL import Image
    img = Image.open(os.path.join(out, 'seed0001.png'))
    assert img.mode == 'RGB' and img.size == (8, 8)
    with pytest.raises(SystemExit):
        generate.main(['--network', os.path.join(
            run, 'ema-snapshot-000000.pt'), '--seeds', '0', '--outdir', out,
            '--device', 'cpu'])


def test_train_cli_resumes_from_pkl_and_refuses(trained, tmp_path, capsys):
    """``--resume`` of a ``.pkl`` transfers it (the counts printed); a
    dataset without labels refuses ``--cond``; a dry run writes
    nothing."""
    pkl = _seeded_pkl(str(tmp_path / 'net.pkl'), 8)
    base = [a if a != str(trained['tmp'] / 'runs') else str(tmp_path / 'r')
            for a in trained['base']]
    state = ttrain_cli.main([*base, '--resume', pkl, '--kimg', '0.004'])
    assert 'transfer_into_train_state: copied' in capsys.readouterr().out
    assert state.step == 1
    nolab = _image_folder(str(tmp_path / 'nolab'), labels=False)
    with pytest.raises(ValueError, match='requires labels'):
        ttrain_cli.main(['--outdir', str(tmp_path / 'x'), '--data', nolab,
                         '--cond', 'true', '--device', 'cpu'])
    assert ttrain_cli.main([*base[:-2], '--dry-run']) is None
    from montage_gan_tpu_torch import __main__ as port_main
    with pytest.raises(SystemExit) as e:
        port_main.main(['train', '--help'])
    assert e.value.code == 0


# ---------------------------------------------------------------------------
# Two gloo ranks of a labelled step
# ---------------------------------------------------------------------------

WORLD = 2
TOL_WEIGHTS = dict(rtol=2e-4, atol=2e-5)
TOL_STATS = dict(rtol=2e-3, atol=2e-4)


def _rank_model():
    cfg = MontageConfig(**dict(MICRO_SINGLE, mbstd_group_size=4))
    ens = MontageEnsemble(cfg, with_d=True).init_weights(3)
    with torch.no_grad():
        for name, p in ens.named_parameters():
            if name.endswith(('bias', 'noise_strength')):
                p.add_(torch.randn(p.shape, generator=torch.Generator()
                                   .manual_seed(len(name))) * 0.1)
    return ens


def run_labelled_step(dp=None):
    """Step 0 at a global batch of 8 in 2 rounds, labelled, on one process
    or as rank ``dp.rank``: (stats, the phases' gradients)."""
    hyper = ttrain.TrainHyper(augment=taug.make_augment_config('bgc'),
                              augment_p_init=0.6, batch_size=8,
                              microbatch=4, train_global=False,
                              train_renderer=False, bypass_renderer=True)
    ens = _rank_model()
    trainer = ttrain.MontageTrainer(ens, hyper, device='cpu',
                                    data_parallel=dp)
    state = trainer.state_from_variables(ens.state_dict())
    grads = {}
    trainer.phase_hook = lambda name, g: grads.__setitem__(
        name, [None if t is None else t.clone() for t in g])
    rng = np.random.RandomState(5)
    crops = rng.uniform(-1, 1, (8, 8, 8, 3)).astype(np.float32)
    real_c, gen_c = _labels(8, 12), _labels(8, 13)
    if dp is not None:
        crops, real_c, gen_c = (rank_rows(x, dp.rank, dp.world, 2)
                                for x in (crops, real_c, gen_c))
    _, stats = trainer.train_step(state, None, [crops],
                                  torch.Generator().manual_seed(7),
                                  real_c=real_c, gen_c=gen_c)
    return {k: float(v) for k, v in stats.items()}, grads


def _rank_worker(rank, port, outdir):
    distributed.maybe_initialize(f'localhost:{port}', WORLD, rank,
                                 device='cpu')
    try:
        dp = mesh.DataParallel.from_process_group('cpu')
        torch.save(run_labelled_step(dp),
                   os.path.join(outdir, f'rank{rank}.pt'))
    finally:
        distributed.shutdown()


def test_ranks_with_labels_equal_one_process(tmp_path):
    """Two gloo ranks (each its round-major rows of the reals, their labels
    and the label pool; every phase permutes the pool over the global
    batch) against one process at the global batch of 8 in 2 rounds: each
    phase's gradients and the stats."""
    distributed.launch(_rank_worker, WORLD,
                       args=(distributed.free_port(), str(tmp_path)),
                       device='cpu')
    stats, grads = run_labelled_step()
    for r in range(WORLD):
        got_stats, got = torch.load(str(tmp_path / f'rank{r}.pt'))
        assert set(got) == set(grads) and len(grads) == 4
        for phase, want in grads.items():
            scale = max(float(w.abs().max()) for w in want if w is not None)
            for g, w in zip(got[phase], want):
                assert (g is None) == (w is None)
                if w is not None:
                    np.testing.assert_allclose(
                        g.numpy(), w.numpy(), rtol=TOL_WEIGHTS['rtol'],
                        atol=TOL_WEIGHTS['atol'] * scale, err_msg=phase)
        for k in stats:
            np.testing.assert_allclose(got_stats[k], stats[k], **TOL_STATS,
                                       err_msg=k)
