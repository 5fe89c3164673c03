"""Data parallelism of the port on the CPU: two gloo ranks against one
process at the global batch (torch only; no JAX).

The one-process step runs the micro config that ``test_torch_global.py``
holds to the JAX package (``MICRO_GLOBAL`` there, spelled out below so that
this module and the ranks it spawns import no JAX), so the ranks are held to
the JAX step through it.  Two ranks are spawned once for the module
(``parallel.distributed.launch``); each runs step 0, where every phase and
regularizer runs, on its rows of the global batch (round-major:
``parallel/mesh.py``), with its own ``RankDraws`` from the same seeded
generator, for two cases: the whole batch of 4 in one round, and a batch of
8 in 2 accumulation rounds of 4.  The minibatch-std groups (size 2) span the
ranks in both.  The ranks save what they computed and the test compares it
with the one-process step on the same global batch and draws, within the
tolerances of the JAX package's ``tests/test_parallel.py`` (weights rtol
2e-4, atol 2e-5: here each phase's gradients, the atol on the phase's
largest entry; stats rtol 2e-3, atol 2e-4).

The CLI: ``train_aio --gpus 2 --device cpu`` for one tick writes its files
once, by rank 0; two ``--coordinator`` processes started separately give
the spawned pair's snapshot bit for bit and then ``--resume`` from it.  The
spawned processes leave TensorBoard out (importing it can load TensorFlow,
which takes many seconds here): a stand-in ``tensorboard`` package that
fails to import is put first on their path.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from montage_gan_tpu_torch.cli import train_aio
from montage_gan_tpu_torch.data.synthetic import make_synthetic_layer_dataset
from montage_gan_tpu_torch.models.ensemble import MontageConfig, MontageEnsemble
from montage_gan_tpu_torch.models.layers import MinibatchStd
from montage_gan_tpu_torch.parallel import distributed, mesh
from montage_gan_tpu_torch.tools.ddp_check import rank_rows
from montage_gan_tpu_torch.training.augment import make_augment_config
from montage_gan_tpu_torch.training.draws import Draws, RankDraws
from montage_gan_tpu_torch.training.train_step import (MontageTrainer,
                                                       TrainHyper)
from montage_gan_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# test_torch_global.py's MICRO_GLOBAL (test_torch_train.py's MICRO with the
# global phases, the tanh renderer and one STN stage)
MICRO_GLOBAL = dict(layer_names=('a', 'b'), layer_targets=((8, 8), (8, 4)),
                    base_resolution=8, img_channels=4, conv_config_index=2,
                    z_dim=16, w_dim=16, mapping_num_layers=2, channel_base=64,
                    channel_max=16, num_fp16_res=0, conv_clamp=256,
                    mbstd_group_size=2, train_global=True,
                    renderer_type='tanh', stn_stages=1)
WORLD = 2
# the whole batch in one round; 2 accumulation rounds of 4
CASES = {'whole': dict(batch_size=4), 'rounds': dict(batch_size=8,
                                                     microbatch=4)}
PHASES = ['renderer', *(f'{name}/{phase}' for name in ('a', 'b')
                        for phase in ('Gmain', 'Greg', 'Dmain', 'Dr1')),
          'global/Gmain', 'global/Dmain', 'global/Dr1']
TOL_WEIGHTS = dict(rtol=2e-4, atol=2e-5)
TOL_STATS = dict(rtol=2e-3, atol=2e-4)
NUDGED = 'model.mapping.fc0.weight'


def _hyper(case):
    # ADA every step with target 0: p moves by the sign of each lane's
    # global mean sign
    return TrainHyper(augment=make_augment_config('bgcfnc'),
                      augment_p_init=0.6, ada_interval=1, ada_target=0.0,
                      **CASES[case])


def _model():
    """Seeded weights with the zero-initialised terms made random, so that
    every term does work (as chip_smoke.py's cross-device phases do)."""
    ens = MontageEnsemble(MontageConfig(**MICRO_GLOBAL), with_d=True)
    ens.init_weights(3)
    with torch.no_grad():
        for name, p in ens.named_parameters():
            if name.endswith(('bias', 'noise_strength')) or \
                    name.startswith('stn.fc_loc.2'):
                p.add_(torch.randn(p.shape, generator=torch.Generator()
                                   .manual_seed(len(name))) * 0.1)
    return ens


def _batch(case):
    """The global batch: the layer stack and the local Ds' crops."""
    cfg = MontageConfig(**MICRO_GLOBAL)
    b = CASES[case]['batch_size']
    rng = np.random.RandomState(5)
    stack = rng.uniform(-1, 1, (b, cfg.num_layers, cfg.base_resolution,
                                cfg.base_resolution, 4)).astype(np.float32)
    crops = [rng.uniform(-1, 1, (b, h, w, 4)).astype(np.float32)
             for h, w in cfg.layer_targets]
    return stack, crops


def run_step(case, dp=None):
    """Step 0 of ``case`` on one process or as rank ``dp.rank``: (state,
    stats, the phases' gradients)."""
    hyper = _hyper(case)
    ens = _model()
    trainer = MontageTrainer(ens, hyper, device='cpu', data_parallel=dp)
    state = trainer.state_from_variables(ens.state_dict())
    grads = {}
    trainer.phase_hook = lambda name, g: grads.__setitem__(
        name, [None if t is None else t.clone() for t in g])
    stack, crops = _batch(case)
    if dp is not None:
        rounds = hyper.accum_rounds
        stack = rank_rows(stack, dp.rank, dp.world, rounds)
        crops = [rank_rows(c, dp.rank, dp.world, rounds) for c in crops]
    state, stats = trainer.train_step(state, stack, crops,
                                      torch.Generator().manual_seed(7))
    return state, {k: float(v) for k, v in stats.items()}, grads


def _summary(state, stats, grads):
    return dict(stats=stats, grads=grads, w_avg=state.model.mapping.w_avg,
                pl_mean=state.pl_mean, aug_p=state.aug_p,
                ada_signs=torch.stack([state.ada_sign_sum,
                                       state.ada_sign_count]),
                tensors=dict(ckpt.train_state_tensors(state)))


def _mbstd_inputs():
    rng = np.random.RandomState(11)
    return (torch.from_numpy(rng.randn(4, 4, 4, 8).astype(np.float32)),
            torch.from_numpy(rng.randn(4, 4, 4, 9).astype(np.float32)))


def _mbstd(x, w):
    """MinibatchStd(2) and the gradient of ``sum(out · w)`` at ``x``."""
    x = x.clone().requires_grad_(True)
    out = MinibatchStd(2)(x)
    g, = torch.autograd.grad((out * w).sum(), x)
    return out.detach(), g


def _rank_worker(rank, port, outdir):
    """One of the spawned ranks: each case's step, MinibatchStd across the
    ranks, and ``assert_replicated`` with and without a nudged tensor."""
    distributed.maybe_initialize(f'localhost:{port}', WORLD, rank,
                                 device='cpu')
    try:
        dp = mesh.DataParallel.from_process_group('cpu')
        out = {}
        for case in CASES:
            state, stats, grads = run_step(case, dp)
            out[case] = _summary(state, stats, grads)
            out[case]['checked'] = mesh.assert_replicated(
                ckpt.train_state_tensors(state), dp)
        named = list(out['whole']['tensors'].items())
        if rank == 1:
            i = [k for k, _ in named].index(NUDGED)
            named[i] = (NUDGED, named[i][1] * (1 + 1e-7))
        try:
            mesh.assert_replicated(named, dp)
            out['nudged'] = None
        except AssertionError as e:
            out['nudged'] = str(e)
        x, w = _mbstd_inputs()
        n = x.shape[0] // WORLD
        rows = slice(rank * n, (rank + 1) * n)
        with mesh.activate(dp):
            out['mbstd'] = _mbstd(x[rows], w[rows])
        torch.save(out, os.path.join(outdir, f'rank{rank}.pt'))
    finally:
        distributed.shutdown()


@pytest.fixture(scope='module')
def ranks(results):
    return results[0]


@pytest.fixture(scope='module')
def one_process(results):
    return results[1]


@pytest.mark.parametrize('phase', PHASES)
@pytest.mark.parametrize('case', sorted(CASES))
def test_ranks_phase_gradients_equal_one_process(ranks, one_process, case,
                                                 phase):
    """Each phase's gradients, summed over the rounds and averaged over the
    ranks, against the one-process phase at the global batch."""
    got, want = ranks[0][case]['grads'][phase], \
        one_process[case]['grads'][phase]
    assert [g is None for g in got] == [g is None for g in want]
    scale = max(float(w.abs().max()) for w in want if w is not None)
    for i, (g, w) in enumerate(zip(got, want)):
        if w is not None:
            np.testing.assert_allclose(
                g.numpy(), w.numpy(), rtol=TOL_WEIGHTS['rtol'],
                atol=TOL_WEIGHTS['atol'] * scale, err_msg=f'{phase} #{i}')


@pytest.mark.parametrize('what', ['w_avg', 'pl_mean', 'aug_p', 'ada_signs',
                                  'stats'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_ranks_state_equals_one_process(ranks, one_process, case, what):
    """``w_avg``, path length's running mean, ADA's p (moved at step 0 by
    each lane's global mean sign), the sign counts and the step's stats."""
    for r in range(WORLD):
        got, want = ranks[r][case][what], one_process[case][what]
        if what == 'stats':
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], **TOL_STATS,
                                           err_msg=k)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       **TOL_WEIGHTS)
    if what == 'aug_p':
        assert not torch.equal(ranks[0][case]['aug_p'],
                               torch.full_like(want, 0.6))


@pytest.mark.parametrize('case', sorted(CASES))
def test_replicas_identical_after_the_step(ranks, case):
    """Every tensor of the train state (weights, EMA, buffers, optimizer
    moments, controller) is bit for bit rank 0's on rank 1, and both ranks'
    ``assert_replicated`` checked all of them."""
    a, b = ranks[0][case]['tensors'], ranks[1][case]['tensors']
    assert list(a) == list(b)
    assert ranks[0][case]['checked'] == ranks[1][case]['checked'] == len(a)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert not differ, differ[:5]


def test_assert_replicated_names_a_nudged_tensor(ranks):
    for r in range(WORLD):
        msg = ranks[r]['nudged']
        assert msg is not None and NUDGED in msg and '1 of' in msg, msg


def test_minibatch_std_groups_span_ranks(ranks):
    """Group size 2 over a global batch of 4 on 2 ranks: each group has a
    sample of each rank (groups are strided), so each rank's rows and its
    input gradient need the other rank's samples."""
    x, w = _mbstd_inputs()
    out, grad = _mbstd(x, w)
    n = x.shape[0] // WORLD
    for r in range(WORLD):
        got_out, got_grad = ranks[r]['mbstd']
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(got_out.numpy(), out[rows].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_grad.numpy(), grad[rows].numpy(),
                                   rtol=1e-6, atol=1e-6)
    alone, _ = _mbstd(x[:n], w[:n])                # without the other rank
    assert not torch.allclose(alone[..., -1], out[:n, ..., -1])


# ---------------------------------------------------------------------------
# Without a process group: the one-process step as before
# ---------------------------------------------------------------------------

def test_minibatch_std_w_avg_and_greg_rows_without_process_group():
    """Outside ``mesh.activate`` the modules compute what they computed
    before data parallelism: MinibatchStd's closed form, ``w_avg``'s moving
    mean over the batch, path length's leading rows."""
    assert not torch.distributed.is_initialized() and mesh.active() is None
    x, _ = _mbstd_inputs()
    g, n = 2, x.shape[0]
    y = x.reshape(g, -1, 4, 4, 1, 8)
    y = ((y - y.mean(0)).square().mean(0) + 1e-8).sqrt().mean(dim=(1, 2, 4))
    y = y.reshape(1, -1, 1, 1, 1).repeat(g, 1, 4, 4, 1).reshape(n, 4, 4, 1)
    assert torch.equal(MinibatchStd(2)(x), torch.cat([x, y], dim=-1))

    ens = _model()
    z = torch.randn(6, 16, generator=torch.Generator().manual_seed(1))
    before = ens.mapping.w_avg.clone()
    w = ens.mapping(z, update_w_avg=True)[:, 0, 0]
    beta = ens.mapping.w_avg_beta
    want = beta * before + (1 - beta) * ens.mapping.fc1(
        ens.mapping.fc0(z * torch.rsqrt(z.square().mean(1, keepdim=True)
                                        + 1e-8))).mean(0)
    assert torch.equal(ens.mapping.w_avg, want)
    assert w.shape == (6, 16)
    assert torch.equal(mesh.leading_rows(z, 2), z[:3])


@pytest.mark.parametrize('blocks', [1, 2])
def test_rank_draws_are_one_process_rows(blocks):
    """Two ranks' ``RankDraws`` of a ``[n, ...]`` batch in ``blocks``
    blocks, put back round-major, are one process's draw of ``[2n, ...]``;
    a per-batch draw is whole on every rank."""
    def draws(cls, *args):
        return cls(torch.Generator().manual_seed(3), *args).blocks(blocks)
    one = draws(Draws)
    want = [one.normal([8, 3], 'augment'), one.uniform([2], 'global_'
                                                         'style_mixing_cutoff')]
    for r in range(WORLD):
        d = draws(RankDraws, r, WORLD).scoped('global_')
        got = d.normal([4, 3], 'augment')
        assert torch.equal(got, torch.from_numpy(
            rank_rows(want[0], r, WORLD, blocks)))
        assert torch.equal(d.uniform([2], 'style_mixing_cutoff'), want[1])


# ---------------------------------------------------------------------------
# The CLI: --gpus 2 and --coordinator
# ---------------------------------------------------------------------------

CLI_ARGS = ['--kimg', '1', '--batch', '4', '--kimg-per-tick', '1', '--snap',
            '1', '--net-snap', '1', '--cfg', 'auto', '--aug', 'noaug',
            '--fp32', 'true', '--conv-config-index', '2', '--channel-base',
            '256', '--channel-max', '32', '--run-once', '--device', 'cpu']
SPEC = (('#1_a', (8, 7), (5, 6)), ('#2_b', (8, 10), (6, 4)))


@pytest.fixture(scope='module')
def no_tensorboard(tmp_path_factory):
    """A directory whose ``tensorboard`` package fails to import."""
    path = tmp_path_factory.mktemp('stub')
    (path / 'tensorboard').mkdir()
    (path / 'tensorboard' / '__init__.py').write_text(
        "raise ImportError('left out of this test')\n")
    return str(path)


def _start_coordinator_pair(tmp, data):
    """Two processes, started separately, ranks 0 and 1 of a run at
    ``--coordinator localhost:PORT`` and then of a run that resumes from
    its snapshot.  Returns (the processes, the first run's snapshot, the
    outdir of the second)."""
    coord, resumed = os.path.join(tmp, 'first'), os.path.join(tmp, 'resumed')
    first = os.path.join(coord, '00000-layers-auto',
                         'network-snapshot-000000.pt')
    runs = [[*argv, '--coordinator', f'localhost:{distributed.free_port()}']
            for argv in (['--outdir', coord, '--data', data, *CLI_ARGS],
                         ['--outdir', resumed, '--data', data, *CLI_ARGS,
                          '--resume', first])]
    code = ('import json, sys; from montage_gan_tpu_torch.cli import '
            'train_aio; [train_aio.main(a) for a in json.loads(sys.argv[1])]')
    env = dict(os.environ, WORLD_SIZE=str(WORLD),
               PYTHONPATH=os.pathsep.join(sys.path))
    procs = [subprocess.Popen([sys.executable, '-c', code, json.dumps(runs)],
                              env={**env, 'RANK': str(r)},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    return procs, first, resumed


@pytest.fixture(scope='module')
def runs(tmp_path_factory, no_tensorboard):
    """Everything this module runs in other processes, started at once (a
    core each; TensorBoard left out) while this process takes the
    one-process steps: the two ranks of ``_rank_worker``; ``train_aio
    --gpus 2`` (on a thread of this process, which spawns its ranks); the
    ``--coordinator`` pair.  Returns a dict of what each produced."""
    tmp = str(tmp_path_factory.mktemp('runs'))
    data = make_synthetic_layer_dataset(os.path.join(tmp, 'layers'),
                                        num_samples=8, size=32, spec=SPEC)
    spawned = os.path.join(tmp, 'spawned')
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('OMP_NUM_THREADS', '1')
        mp.syspath_prepend(no_tensorboard)
        coordinator = _start_coordinator_pair(tmp, data)

        def run(name, fn, *args):
            """``fn(*args)`` on a thread: its result, or what it raised
            (re-raised by the test that reads it), and its seconds."""
            def target():
                t0 = time.perf_counter()
                try:
                    result = fn(*args)
                except Exception as e:
                    result = e
                out[name] = (result, time.perf_counter() - t0)
            thread = threading.Thread(target=target)
            thread.start()
            return thread
        threads = [
            run('ranks', distributed.launch, _rank_worker, WORLD,
                (distributed.free_port(), tmp), 'cpu'),
            run('failing', distributed.launch, _failing_rank, WORLD,
                (distributed.free_port(),), 'cpu'),
            run('cli', train_aio.main, ['--outdir', spawned, '--data', data,
                                        '--gpus', '2', *CLI_ARGS])]
        try:
            out['one'] = {case: _summary(*run_step(case)) for case in CASES}
        finally:
            for thread in threads:
                thread.join(timeout=300)
            procs, first, resumed = coordinator
            logs = [p.communicate(timeout=300)[0] for p in procs]
    for name in ('ranks', 'cli'):
        if isinstance(out[name][0], Exception):
            raise out[name][0]
    out['ranks'] = [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                               weights_only=False) for r in range(WORLD)]
    out['coordinator'] = ([p.returncode for p in procs], logs, first,
                          resumed)
    out['spawned'] = spawned
    return out


def _failing_rank(rank, port):
    """Rank 1 fails after the group is up; rank 0 waits for it in a
    collective."""
    distributed.maybe_initialize(f'localhost:{port}', WORLD, rank,
                                 device='cpu')
    if rank == 1:
        raise RuntimeError('rank 1 fails here')
    torch.distributed.barrier()


@pytest.fixture(scope='module')
def ranks(runs):
    return runs['ranks']


@pytest.fixture(scope='module')
def one_process(runs):
    return runs['one']


def _one_run(outdir):
    runs = os.listdir(outdir)
    assert len(runs) == 1, runs
    return os.path.join(outdir, runs[0])


def _state(path):
    return torch.load(path, map_location='cpu', weights_only=True)


def test_train_aio_gpus_2_and_coordinator_pair(runs):
    """``--gpus 2`` for one tick: one run directory, written by rank 0
    alone.  Two ``--coordinator`` processes, started separately, ran the
    same and then ``--resume`` from their snapshot (step 1 on both ranks);
    their first snapshot is the spawned pair's bit for bit."""
    assert runs['cli'][0] is None
    codes, logs, first, resumed = runs['coordinator']
    for code, log in zip(codes, logs):
        assert code == 0, log[-3000:]

    run_dir = _one_run(runs['spawned'])
    files = set(os.listdir(run_dir))
    assert {'training_options.json', 'log.txt', 'stats.jsonl', 'reals.png',
            'fakes000000.png', 'network-snapshot-000000.pt',
            'ema-snapshot-000000.pt'} <= files
    with open(os.path.join(run_dir, 'log.txt')) as f:
        log = f.read()
    assert log.count('tick 0 ') == 1 and '2 rank(s)' in log
    assert 'replicated over 2 ranks' in log
    with open(os.path.join(run_dir, 'stats.jsonl')) as f:
        records = [json.loads(line) for line in f]
    # one record, with the moments of both ranks' data wait
    assert len(records) == 1
    assert records[0]['Timing/data_fetch']['num'] == WORLD
    saved = _state(os.path.join(run_dir, 'network-snapshot-000000.pt'))
    assert saved['step'] == 1

    assert _one_run(os.path.dirname(os.path.dirname(first))) == \
        os.path.dirname(first)
    again = _state(first)
    for part in ('model', 'ema'):
        for k, v in saved[part].items():
            assert torch.equal(again[part][k], v), (part, k)
    assert f'Restored {first}' in logs[0] and 'Restored' not in logs[1]
    after = _state(os.path.join(_one_run(resumed),
                                'network-snapshot-000000.pt'))
    assert after['step'] == 2
    assert not torch.equal(after['model']['mapping.fc0.weight'],
                           saved['model']['mapping.fc0.weight'])


def test_a_failing_rank_ends_the_run(runs):
    """A rank that raises ends the run: the other, which waits in a
    collective, fails or is ended, and the launch raises (with the first
    error of either rank); nothing hangs."""
    error, seconds = runs['failing']
    assert isinstance(error, torch.multiprocessing.ProcessRaisedException)
    assert 'terminated with the following error' in str(error), error
    assert seconds < 60


def test_more_ranks_than_cards_raise(tmp_path):
    """``--gpus N`` on the card with fewer than N cards raises before
    anything starts; so does ``launch``."""
    if torch.cuda.device_count() >= 2:
        pytest.skip('two cards are visible')
    with pytest.raises(RuntimeError, match='CUDA'):
        distributed.launch(_failing_rank, 2, args=(0,), device='cuda')
    data = make_synthetic_layer_dataset(str(tmp_path / 'layers'),
                                        num_samples=2, size=32, spec=SPEC)
    outdir = str(tmp_path / 'runs')
    with pytest.raises(RuntimeError, match='CUDA'):
        train_aio.main(['--outdir', outdir, '--data', data, '--gpus', '2',
                        '--batch', '4', '--cfg', 'auto'])
    assert os.listdir(outdir) == []
