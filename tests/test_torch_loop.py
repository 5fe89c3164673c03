"""The port's training loop and CLI on the CPU: microbatch accumulation
against the JAX package's ``accum_value_and_grad``, train-state snapshots,
and the ``train_aio`` CLI end to end (files, stats, resume, dry run, the
flags it accepts or refuses, the launches of an accumulated step).

Accumulation runs 2 rounds of local Dmain with the ADA pipe at p = 0.5 and
of local Greg (the micro ensemble of ``test_torch_train``), each round with
the draws of its JAX round key, and of global Dmain (that of
``test_torch_global``) without the pipe; style mixing is off and the
synthesis noise is ``test_torch_train``'s fixed field; z is an input.  The
summed gradients are held per tensor within 1e-3 of the tensor's largest
JAX gradient and the averaged stats within rtol 1e-4, as in
``test_torch_train``; ``sign_real`` exactly; ``pl_mean`` within rtol 1e-4;
``w_avg`` within 1e-6.

The CLI runs on the JAX CLI test's tiny dataset and arguments
(``tests/test_train_aio_cli.py``), with ``--device cpu``.
"""

import dataclasses
import json
import os

import click
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from montage_gan_tpu.cli import train_aio as jcli
from montage_gan_tpu.data.synthetic import \
    make_synthetic_layer_dataset as jax_make_dataset
from montage_gan_tpu.training import augment as jaug
from montage_gan_tpu.training import losses as jlosses
from montage_gan_tpu.training import train_step as jtrain
from montage_gan_tpu_torch.cli import train_aio
from montage_gan_tpu_torch.models.ensemble import MontageConfig, MontageEnsemble
from montage_gan_tpu_torch.training import augment as taug
from montage_gan_tpu_torch.training import loop_aio
from montage_gan_tpu_torch.training import losses as tlosses
from montage_gan_tpu_torch.training import train_step as ttrain
from montage_gan_tpu_torch.training.draws import Draws
from montage_gan_tpu_torch.utils import checkpoint as tckpt
from montage_gan_tpu_torch.utils import weights

import chip_smoke
from test_torch_global import MICRO_GLOBAL, jax_micro_global
from test_torch_global import port_ensemble as port_ensemble_global
from test_torch_grads import emulate_kernels
from test_torch_train import (FAST_COMPILE, InjectedDraws, _assert_grads,
                              _g_grads_jax, _np, inject_jax_synthesis_noise,
                              jax_micro, port_ensemble)

torch.set_num_threads(1)

ROUNDS = 2
BATCH = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Microbatch accumulation
# ---------------------------------------------------------------------------

def _check_aux(aux, jaux, tens):
    assert set(aux['stats']) == set(jaux['stats'])
    for k, v in aux['stats'].items():
        np.testing.assert_allclose(float(v), float(jaux['stats'][k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    if 'sign_real' in jaux:
        assert float(aux['sign_real']) == float(jaux['sign_real'])
    np.testing.assert_allclose(
        tens.mapping.w_avg.numpy(),
        np.asarray(jaux['moving_stats']['w_avg']), rtol=0, atol=1e-6)


class PerRoundDraws(InjectedDraws):
    """``InjectedDraws`` whose augment pipe draws are JAX's: the pipe of
    round ``r`` takes ``per_round`` draws, the ``i``-th from
    ``fold_in(aug_keys[r], i)`` (the JAX pipe's key stream), uniform or
    normal as the port asks."""

    def __init__(self, aug_keys=(), per_round=0, **kw):
        super().__init__(**kw)
        self.aug_keys, self.per_round, self.taken = aug_keys, per_round, 0

    def _augment(self, fn, shape):
        r, i = divmod(self.taken, self.per_round)
        self.taken += 1
        return torch.from_numpy(np.array(
            fn(jax.random.fold_in(self.aug_keys[r], i), tuple(shape))))

    def normal(self, shape, kind):
        if kind == 'augment':
            return self._augment(jax.random.normal, shape)
        return super().normal(shape, kind)

    def uniform(self, shape, kind):
        if kind == 'augment':
            return self._augment(jax.random.uniform, shape)
        return super().uniform(shape, kind)


class CountingDraws(Draws):
    def __init__(self):
        super().__init__(torch.Generator().manual_seed(0))
        self.count = 0

    def normal(self, shape, kind):
        self.count += 1
        return super().normal(shape, kind)

    def uniform(self, shape, kind):
        self.count += 1
        return super().uniform(shape, kind)


def _check_accumulated_local(phase, monkeypatch):
    """2 rounds of a local phase that draws, held to JAX's
    ``accum_value_and_grad``.  Round ``r`` of the port gets the draws of
    JAX's round key ``split(key, 2)[r]``: the augment pipe's key stream of
    ``split(round key, 3)[1]``, the path-length noise of
    ``split(round key, 3)[2]``."""
    layer = 1
    cfg, ens, variables, np_tree = jax_micro()
    tens = port_ensemble(np_tree)
    inject_jax_synthesis_noise(monkeypatch)
    rng = np.random.RandomState(23)
    z = rng.randn(BATCH, cfg.z_dim).astype(np.float32)
    th, tw = cfg.layer_targets[layer]
    key = jax.random.PRNGKey(8)
    round_keys = [jax.random.split(k, 3)
                  for k in jax.random.split(key, ROUNDS)]
    mvars, gvars = variables['mapping'], variables['local_g'][layer]
    dvars = variables['local_d'][layer]
    mb = BATCH // ROUNDS

    if phase == 'dmain':
        p = 0.5
        real = rng.uniform(-1, 1, (BATCH, th, tw, 4)).astype(np.float32)
        aug_j, aug_t = (m.make_augment_config('bgc') for m in (jaug, taug))
        counting = CountingDraws()
        taug.augment_pipe(torch.zeros(2 * mb, th, tw, 4), p, aug_t, counting)
        draws = PerRoundDraws([k[1] for k in round_keys], counting.count)

        def jloss(d, data, k):
            z_mb, real_mb = data
            return jlosses.local_dmain_loss(
                {**dvars, 'params': d}, ens, layer,
                {'mapping': mvars, 'g': gvars}, z_mb, real_mb, k, aug_j,
                jnp.float32(p), style_mixing_prob=0.0)
        jparams, data = dvars['params'], (z, real)

        def loss(z_mb, real_mb):
            loss, st, sign = tlosses.local_dmain_loss(
                tens, layer, z_mb, real_mb, draws, aug_t, p,
                style_mixing_prob=0.0)
            return loss, {'stats': st, 'sign_real': sign}
        named = [(f'local_d.{layer}.{k}', v)
                 for k, v in tens.local_d[layer].named_parameters()]
    else:
        pl_mean = 0.3
        pl = [jax.random.normal(k[2], (mb // 2, th, tw, 4))
              for k in round_keys]
        draws = PerRoundDraws(pl_noise=pl)

        def jloss(params, data, k):
            m, g = params
            return jlosses.local_gpl_loss(
                {'mapping': {**mvars, 'params': m},
                 'g': {**gvars, 'params': g}}, ens, layer, data[0], k,
                jnp.float32(pl_mean), style_mixing_prob=0.0)
        jparams, data = (mvars['params'], gvars['params']), (z,)

        def loss(z_mb):
            loss, pl_i, st = tlosses.local_gpl_loss(
                tens, layer, z_mb, draws, torch.tensor(pl_mean),
                style_mixing_prob=0.0)
            return loss, {'stats': st, 'pl_mean': pl_i}
        named = [(f'mapping.{k}', v)
                 for k, v in tens.mapping.named_parameters()] + [
            (f'local_g.{layer}.{k}', v)
            for k, v in tens.local_g[layer].named_parameters()]

    (_, jaux), jgrads = jax.jit(
        lambda prm, d, k: jtrain.accum_value_and_grad(jloss, prm, d, k,
                                                      ROUNDS),
        compiler_options=FAST_COMPILE)(
        jparams, tuple(jnp.asarray(x) for x in data), key)
    aux, grads = ttrain.accum_value_and_grad(
        loss, [v for _, v in named], tuple(torch.from_numpy(x) for x in data),
        ROUNDS, tens.mapping.w_avg)
    _check_aux(aux, jaux, tens)
    port = {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(named, grads)}
    if phase == 'dmain':
        assert draws.taken == ROUNDS * draws.per_round
        ref = {f'local_d.{layer}.{k}': v for k, v in
               weights.discriminator_state_dict(
                   _np({'params': jgrads}),
                   tens.cfg.layer_geometry(layer)[0]).items()}
    else:
        assert not draws.queue['pl_noise']          # both rounds drew
        np.testing.assert_allclose(float(aux['pl_mean']),
                                   float(jaux['pl_mean']), rtol=1e-4)
        ref = _g_grads_jax(np_tree, layer, *jgrads)
    _assert_grads(port, {k: ref[k] for k in port})


def test_accumulated_local_dmain_matches_jax(monkeypatch):
    """Dmain with the ADA pipe ('bgc') at p = 0.5: both rounds augment,
    each with its own round's draws."""
    _check_accumulated_local('dmain', monkeypatch)


def test_accumulated_local_greg_matches_jax(monkeypatch):
    """Greg: each round draws its path-length noise; ``pl_mean`` is the
    rounds' mean, held to JAX's."""
    _check_accumulated_local('greg', monkeypatch)


def test_accumulated_global_dmain_matches_jax(monkeypatch):
    cfg, ens, variables, np_tree = jax_micro_global()
    tens = port_ensemble_global(np_tree)
    inject_jax_synthesis_noise(monkeypatch)
    rng = np.random.RandomState(22)
    z = rng.randn(BATCH, cfg.z_dim).astype(np.float32)
    stack = rng.uniform(-1, 1, (BATCH, cfg.num_layers, cfg.base_resolution,
                                cfg.base_resolution, 4)).astype(np.float32)
    aug_j = aug_t = None
    v = variables

    def jloss(d, data, key):
        z_mb, stack_mb = data
        return jlosses.global_dmain_loss(
            {**v['global_d'], 'params': d}, ens, v, z_mb, stack_mb, key,
            aug_j, jnp.float32(0.0), style_mixing_prob=0.0)
    (_, jaux), dg = jax.jit(
        lambda d, data, key: jtrain.accum_value_and_grad(jloss, d, data, key,
                                                         ROUNDS),
        compiler_options=FAST_COMPILE)(
        v['global_d']['params'], (jnp.asarray(z), jnp.asarray(stack)),
        jax.random.PRNGKey(6))

    draws = InjectedDraws().scoped('global_')

    def gdmain(z_mb, stack_mb):
        loss, st, sign = tlosses.global_dmain_loss(
            tens, z_mb, stack_mb, draws, aug_t, 0.0, style_mixing_prob=0.0)
        return loss, {'stats': st, 'sign_real': sign}
    named = list(tens.global_d.named_parameters())
    aux, grads = ttrain.accum_value_and_grad(
        gdmain, [p for _, p in named],
        (torch.from_numpy(z), torch.from_numpy(stack)), ROUNDS,
        tens.mapping.w_avg)
    _check_aux(aux, jaux, tens)
    ref = weights.discriminator_state_dict(_np({'params': dg}),
                                           cfg.base_init_res)
    port = {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(named, grads)}
    _assert_grads(port, {k: ref[k] for k in port})


def test_accumulation_rounds_must_divide_the_batch():
    assert ttrain.TrainHyper(batch_size=32, microbatch=16,
                             global_microbatch=8).global_accum_rounds == 4
    assert ttrain.TrainHyper(batch_size=32, microbatch=16
                             ).global_accum_rounds == 2
    for kw in (dict(microbatch=3), dict(global_microbatch=5),
               dict(microbatch=0)):
        with pytest.raises(ValueError, match='does not divide'):
            ttrain.TrainHyper(batch_size=8, **kw).global_accum_rounds
    x = torch.zeros(5, 2, requires_grad=True)
    with pytest.raises(ValueError, match='not divisible'):
        ttrain.accum_value_and_grad(lambda a: (a.sum(), {}), [x], (x,), 2)


# ---------------------------------------------------------------------------
# Train-state snapshots
# ---------------------------------------------------------------------------

def _trainer(hyper):
    cfg = MontageConfig(**MICRO_GLOBAL)
    return ttrain.MontageTrainer(MontageEnsemble(cfg, with_d=True), hyper,
                                 device='cpu')


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    stack = rng.uniform(-1, 1, (BATCH, cfg.num_layers, cfg.base_resolution,
                                cfg.base_resolution, 4)).astype(np.float32)
    crops = [rng.uniform(-1, 1, (BATCH, h, w, 4)).astype(np.float32)
             for h, w in cfg.layer_targets]
    return stack, crops


def test_restored_train_state_steps_bit_identically(tmp_path):
    """Save after a step, restore into a fresh trainer and ensemble: the
    next step (with accumulation, ADA firing) equals the saving run's."""
    hyper = ttrain.TrainHyper(batch_size=BATCH, microbatch=2,
                              augment=taug.make_augment_config('bgc'),
                              augment_p_init=0.3, ada_interval=2,
                              ada_target=-2.0)
    trainer = _trainer(hyper)
    cfg = trainer.ens.cfg
    state = trainer.init_state(3)
    stack, crops = _batch(cfg, 1)
    state, _ = trainer.train_step(state, stack, crops,
                                  Draws(torch.Generator().manual_seed(1)))
    path = tckpt.save_train_state(str(tmp_path), 0, state)
    assert os.path.basename(path) == 'network-snapshot-000000.pt'

    restored_trainer = _trainer(hyper)
    restored = tckpt.restore_train_state(path, restored_trainer)
    chip_smoke.check_restored(restored, state)
    stack, crops = _batch(cfg, 2)
    outs = []
    for tr, st in ((trainer, state), (restored_trainer, restored)):
        st, stats = tr.train_step(st, stack, crops,
                                  Draws(torch.Generator().manual_seed(2)))
        outs.append((tr.ens, st, stats))
    (ens_a, a, stats_a), (ens_b, b, stats_b) = outs
    assert a.step == b.step == 2
    assert (a.aug_p != 0.3).any()              # the controller moved p
    for k, v in ens_a.state_dict().items():
        assert torch.equal(v, ens_b.state_dict()[k]), k
    for k, v in a.ema.state_dict().items():
        assert torch.equal(v, b.ema.state_dict()[k]), k
    for name in ('pl_mean', 'aug_p', 'ada_sign_sum', 'ada_sign_count'):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for k, v in stats_a.items():
        assert torch.equal(v, stats_b[k]), k
    for oa, ob in zip(a.opt_local_g + [a.opt_global_d, a.opt_renderer],
                      b.opt_local_g + [b.opt_global_d, b.opt_renderer]):
        for pa, pb in zip(oa.state_dict()['state'].values(),
                          ob.state_dict()['state'].values()):
            for k in pa:
                assert torch.equal(torch.as_tensor(pa[k]),
                                   torch.as_tensor(pb[k])), k


def test_restore_refuses_a_jax_train_state_and_another_config(tmp_path):
    hyper = ttrain.TrainHyper(batch_size=BATCH)
    with pytest.raises(ValueError, match='JAX train state'):
        tckpt.restore_train_state(str(tmp_path / 'x.msgpack'),
                                  _trainer(hyper))
    trainer = _trainer(hyper)
    path = tckpt.save_train_state(str(tmp_path), 1,
                                  trainer.init_state(0))
    other = ttrain.MontageTrainer(
        MontageEnsemble(dataclasses.replace(trainer.ens.cfg, w_dim=8),
                        with_d=True), hyper, device='cpu')
    with pytest.raises(ValueError, match='config'):
        tckpt.restore_train_state(path, other)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def tiny_dataset(tmp_path_factory):
    """tests/test_train_aio_cli.py's dataset (written by PIL)."""
    path = str(tmp_path_factory.mktemp('ds') / 'layers')
    spec = (('#1_a', (8, 7), (5, 6)), ('#2_b', (8, 10), (6, 4)))
    jax_make_dataset(path, num_samples=8, size=32, spec=spec)
    return path


# tests/test_train_aio_cli.py's arguments, on the CPU
CLI_ARGS = ['--gpus', '1', '--kimg', '1', '--batch', '4',
            '--kimg-per-tick', '1', '--snap', '1', '--net-snap', '1',
            '--cfg', 'auto', '--aug', 'noaug', '--fp32', 'true',
            '--conv-config-index', '2', '--channel-base', '256',
            '--channel-max', '32', '--run-once', '--device', 'cpu']


def _run_dir(outdir):
    runs = os.listdir(outdir)
    assert len(runs) == 1, runs
    return os.path.join(outdir, runs[0])


def test_train_aio_cli_end_to_end_and_resume(tiny_dataset, tmp_path,
                                             monkeypatch):
    """The JAX CLI test's run: the same files and stat names; then
    ``--resume`` from its snapshot with 2 accumulation rounds, through the
    kernels' autograd Functions (emulated), launching each kernel as often
    as ``chip_smoke.py`` expects (one step and the EMA grid)."""
    # the TensorBoard sink is left out: importing it can load TensorFlow,
    # which takes seconds
    monkeypatch.setattr(loop_aio, 'make_tensorboard_writer', lambda d: None)
    outdir = str(tmp_path / 'runs')
    train_aio.main(['--outdir', outdir, '--data', tiny_dataset, *CLI_ARGS])
    run_dir = _run_dir(outdir)
    files = set(os.listdir(run_dir))
    assert {'training_options.json', 'log.txt', 'stats.jsonl', 'reals.png',
            'fakes000000.png', 'fakes-layer000000.png',
            'network-snapshot-000000.pt', 'ema-snapshot-000000.pt'} <= files
    with open(os.path.join(run_dir, 'training_options.json')) as f:
        opts = json.load(f)
    assert opts['batch'] == 4 and opts['device'] == 'cpu'
    with open(os.path.join(run_dir, 'stats.jsonl')) as f:
        rec = json.loads(f.readline())
    assert any(k.endswith('Loss/G/loss') for k in rec), rec.keys()
    assert {'Timing/data_fetch', 'Progress/kimg', 'Timing/sec_per_kimg',
            'Renderer/loss_gen', 'global/Loss/D/loss',
            'Progress/augment_global'} <= set(rec)
    for k, v in rec.items():
        if isinstance(v, dict) and 'mean' in v:
            assert np.isfinite(v['mean']), (k, v)
    with open(os.path.join(run_dir, 'log.txt')) as f:
        assert 'tick 0' in f.read()

    snapshot = os.path.join(run_dir, 'network-snapshot-000000.pt')
    assert [s[:2] for s in chip_smoke.snapshot_lines(run_dir)] == [
        ('Saved', snapshot),
        ('Saved', os.path.join(run_dir, 'ema-snapshot-000000.pt'))]
    kernels = emulate_kernels(monkeypatch)
    resumed = str(tmp_path / 'resumed')
    argv = ['--outdir', resumed, '--data', tiny_dataset, *CLI_ARGS,
            '--resume', snapshot, '--batch-gpu', '2']
    hyper = train_aio.setup_training_loop_kwargs(
        train_aio.parse_options(argv)).hyper
    state = train_aio.main(argv)
    assert _run_dir(resumed).endswith('-resumecustom')
    assert chip_smoke.snapshot_lines(_run_dir(resumed))[0][:2] == (
        'Restored', snapshot)
    assert state.step == 2 and hyper.accum_rounds == 2
    assert hyper.ema_rampup is None and hyper.ada_kimg == 100
    # the resumed step is step 1 (no Greg, no R1): steps 0-1 less step 0
    two, one = (chip_smoke.expected_train_launches(state.model, hyper, n)
                for n in (2, 1))
    expect = {k: two[k] - one[k] for k in two}
    for name, n in chip_smoke.expected_launches(state.ema).items():
        expect[name] += n
    assert {k: kernels[k].launches for k in expect} == expect
    # the EMA snapshot samples through the port's generate CLI
    from montage_gan_tpu_torch.cli import generate
    monkeypatch.undo()
    gen = str(tmp_path / 'gen')
    generate.main(['--network', os.path.join(run_dir,
                                             'ema-snapshot-000000.pt'),
                   '--seeds', '0-1', '--outdir', gen, '--device', 'cpu'])
    assert sorted(os.listdir(gen)) == ['seed0000.png', 'seed0001.png']


def test_train_aio_cli_dry_run_writes_nothing(tiny_dataset, tmp_path,
                                              capsys):
    outdir = str(tmp_path / 'runs')
    train_aio.main(['--outdir', outdir, '--data', tiny_dataset, '--gpus',
                    '1', '--kimg', '1', '--batch', '4', '--cfg', 'auto',
                    '--dry-run'])
    assert 'batch' in capsys.readouterr().out
    assert os.listdir(outdir) == []


def test_train_aio_cli_needs_a_card_or_device_cpu(tiny_dataset, tmp_path):
    """Without ``--device cpu`` the CLI trains on the card, and raises where
    there is none; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    outdir = str(tmp_path / 'runs')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_aio.main(['--outdir', outdir, '--data', tiny_dataset])
    assert os.listdir(outdir) == []


WAITING = {'--metrics': ['--metrics', 'fid50k_fool'],
           '--resume': ['--resume', 'ffhq256']}


@pytest.mark.parametrize('flag', sorted(WAITING))
def test_train_aio_cli_flags_that_wait_raise(flag, tiny_dataset, tmp_path,
                                             monkeypatch):
    """No flag waits any more: a name that is no metric raises listing the
    valid ones, and an alias that is not in the cache (``MGT_CACHE_DIR``)
    is fetched, which fails without the network as the JAX CLI's fetch
    fails (``urlopen`` is patched: no test reaches the network); nothing is
    written."""
    import urllib.request
    calls = []

    def urlopen(url, timeout=None):
        calls.append(url)
        raise OSError('no network')
    monkeypatch.setattr(urllib.request, 'urlopen', urlopen)
    monkeypatch.setattr('time.sleep', lambda s: None)
    monkeypatch.setenv('MGT_CACHE_DIR', str(tmp_path / 'cache'))
    error, match = ((ValueError, 'valid: fid50k_full') if flag == '--metrics'
                    else (OSError, 'no network'))
    with pytest.raises(error, match=match):
        train_aio.main(['--outdir', str(tmp_path / 'runs'), '--data',
                        tiny_dataset, '--device', 'cpu', *WAITING[flag]])
    assert not os.path.exists(str(tmp_path / 'runs'))
    assert len(calls) == (10 if flag == '--resume' else 0)


def test_train_aio_cli_flag_parity():
    """Every flag of the JAX CLI is accepted by the port's parser or named
    in its list of flags not ported, and ROADMAP.md names the queue item of
    each flag that is not ported or waits."""
    ours = set(train_aio.make_parser()._option_string_actions)
    flags = set()
    for param in jcli.main.params:
        if isinstance(param, click.Option):
            flags |= {f for f in param.opts + param.secondary_opts
                      if f.startswith('--')}
    assert flags
    missing = flags - ours - set(train_aio.NOT_PORTED)
    assert not missing, missing
    assert not set(train_aio.NOT_PORTED) & ours
    # the metrics and the resume sources are ported: --metrics and
    # --resume are accepted and wait no more; --renderer-import is accepted
    # and, as in the JAX CLI, not read
    assert not train_aio.WAITING
    assert set(WAITING) <= ours & flags
    assert '--renderer-import' in ours & flags
    assert '--renderer-import' not in train_aio.WAITING
    assert '--metrics' in ours & flags
    # data parallelism is ported: both flags accepted, neither waits
    assert {'--gpus', '--coordinator'} <= ours & flags
    assert not {'--gpus', '--coordinator'} & set(train_aio.WAITING)
    with open(os.path.join(REPO, 'ROADMAP.md')) as f:
        roadmap = f.read()
    for flag in [*train_aio.NOT_PORTED, *train_aio.WAITING]:
        assert f'`{flag}`' in roadmap, flag
    with pytest.raises(SystemExit):
        train_aio.make_parser().parse_args(['--outdir', 'o', '--data', 'd',
                                            '--merge-locals', 'all'])


def test_loop_refuses_what_waits(tiny_dataset, tmp_path):
    """A metric name that is none of the registry's raises before anything
    is written (the metrics themselves are ported); ``num_devices`` is the
    process group's world size, so 2 without a group of 2 ranks raises
    (``cli/train_aio.py --gpus 2`` starts them)."""
    from montage_gan_tpu_torch.data.dataset import DatasetAIO
    ds = DatasetAIO(tiny_dataset)
    with pytest.raises(ValueError, match='valid: fid50k_full'):
        loop_aio.training_loop(str(tmp_path / 'r'), ds, device='cpu',
                               metrics=['fid50k_fool'])
    with pytest.raises(ValueError, match='num_devices=2, 1 rank'):
        loop_aio.training_loop(str(tmp_path / 'r'), ds, device='cpu',
                               num_devices=2)
    assert not os.path.exists(str(tmp_path / 'r'))


def test_loop_writes_a_profiler_trace(tiny_dataset, tmp_path, monkeypatch):
    """``trace_dir``: a torch.profiler trace of the chosen steps (here the
    first), on a micro local-phase config."""
    from montage_gan_tpu_torch.data.dataset import DatasetAIO
    monkeypatch.setattr(loop_aio, 'make_tensorboard_writer', lambda d: None)
    ds = DatasetAIO(tiny_dataset)
    cfg = loop_aio.config_from_dataset(
        ds, channel_base=256, channel_max=32, mapping_num_layers=2,
        num_fp16_res=0, conv_clamp=None, train_global=False,
        renderer_type='none', z_dim=16, w_dim=16)
    hyper = ttrain.TrainHyper(batch_size=2, train_global=False,
                              train_renderer=False)
    trace = str(tmp_path / 'trace')
    state = loop_aio.training_loop(
        str(tmp_path / 'run'), ds, cfg=cfg, hyper=hyper, total_kimg=1,
        image_snapshot_ticks=None, network_snapshot_ticks=None,
        run_once=True, trace_dir=trace, trace_start_iter=0,
        trace_num_iters=1, device='cpu')
    assert state.step == 1
    with open(os.path.join(trace, 'trace.json')) as f:
        assert 'traceEvents' in json.load(f)
