"""The metrics on two gloo ranks against one process (torch only; no JAX).

Two ranks are spawned once for the module (``parallel.distributed.launch``)
and share, as ``metrics/metric_utils.py`` lays them out (rank r takes the
batches k ≡ r mod 2, gathered back in batch order), the dataset loop (7
samples in batches of 3: the last one ragged), the generator loop (20
images in batches of 8: the last cut) and PPL's distances (10 in batches of
4) of a micro ensemble, each through a 64-feature random pyramid.  Every
feature, distance and float64 sum is held to one process's bit for bit; the
FID and PPL that rank 0 computes reach both ranks; rank 0 alone writes the
dataset cache and the metric record.  Each rank is given a cache directory
of its own (as the training loop gives each rank its run directory, which
a rank started with ``--coordinator`` picks for itself), and a second FID
reads rank 0's cache on rank 0 alone.  ``calc_metrics --gpus 2`` is held to
``--gpus 1`` on a snapshot of the same ensemble, exactly.  The spawned
processes run one thread each, as this process does (a convolution's sums
may split otherwise).
"""

import json
import os
import threading

import pytest
import torch

from montage_gan_tpu_torch.cli import calc_metrics
from montage_gan_tpu_torch.data.dataset import DatasetAIO
from montage_gan_tpu_torch.data.synthetic import make_synthetic_layer_dataset
from montage_gan_tpu_torch.metrics import (frechet_inception_distance,
                                           metric_main, metric_utils)
from montage_gan_tpu_torch.metrics import perceptual_path_length as ppl
from montage_gan_tpu_torch.metrics.features import RandomFeatures
from montage_gan_tpu_torch.models.ensemble import MontageConfig, MontageEnsemble
from montage_gan_tpu_torch.parallel import distributed
from montage_gan_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

WORLD = 2
# test_torch_ddp.py's micro config with the global phases
MICRO_GLOBAL = dict(layer_names=('a', 'b'), layer_targets=((8, 8), (8, 4)),
                    base_resolution=8, img_channels=4, conv_config_index=2,
                    z_dim=16, w_dim=16, mapping_num_layers=2, channel_base=64,
                    channel_max=16, num_fp16_res=0, conv_clamp=256,
                    mbstd_group_size=2, train_global=True,
                    renderer_type='tanh', stn_stages=1)
SPEC = (('#1_a', (8, 7), (5, 6)), ('#2_b', (8, 10), (6, 4)))


def _extractor():
    ex = RandomFeatures(device='cpu')
    ex.proj = ex.proj[:, :64].contiguous()
    ex.feature_dim = 64
    return ex


def _model():
    return MontageEnsemble(MontageConfig(**MICRO_GLOBAL)).init_weights(2)


def compute_all(data, cache_dir):
    """What a rank (or the one process) computes: the loops' statistics,
    PPL's distances, a FID of 12 images, the same FID again (the dataset's
    statistics from ``cache_dir``, which the first one wrote) and a PPL
    through ``calc_metric``."""
    torch.set_num_threads(1)
    ex, model = _extractor(), _model().eval()
    sample_fn, map_fn, synth_fn = metric_utils.ensemble_fns(model)
    ds = DatasetAIO(data)
    stats = dict(capture_all=True, capture_mean_cov=True)
    out = {}
    for name, st in (
            ('dataset', metric_utils.compute_feature_stats_for_dataset(
                ds, ex, batch_size=3, device='cpu', **stats)),
            ('generator', metric_utils.compute_feature_stats_for_generator(
                sample_fn, 16, ex, 20, batch_size=8, seed=3, device='cpu',
                **stats))):
        out[name] = dict(all=st.get_all_torch(), mean=st.raw_mean,
                         cov=st.raw_cov, n=st.num_items)
    out['ppl'] = torch.from_numpy(ppl.compute_ppl_distances(
        None, 16, ex, num_samples=10, space='w', batch_size=4, seed=1,
        map_fn=map_fn, synth_fn=synth_fn, device='cpu'))
    kw = dict(dataset=ds, sample_fn=sample_fn, map_fn=map_fn,
              synth_fn=synth_fn, z_dim=16, extractor=ex, batch_size=4,
              device='cpu', cache_dir=cache_dir, ppl_samples=10)
    for name in ('fid', 'fid_cached'):
        out[name] = frechet_inception_distance.compute_fid(
            metric_main.MetricOptions(**kw), max_real=None, num_gen=12)
    result = metric_main.calc_metric('ppl2_wend', **kw)
    out['ppl2_wend'], out['num_gpus'] = dict(result.results), result.num_gpus
    return out


def _rank_worker(rank, port, data, tmp):
    distributed.maybe_initialize(f'localhost:{port}', WORLD, rank,
                                 device='cpu')
    try:
        out = compute_all(data, os.path.join(tmp, f'cache-rank{rank}'))
        metric_main.report_metric(metric_main.calc_metric(
            'ppl2_wend', z_dim=16, device='cpu', extractor=_extractor(),
            ppl_samples=4, batch_size=2,
            **dict(zip(('sample_fn', 'map_fn', 'synth_fn'),
                       metric_utils.ensemble_fns(_model().eval())))),
            run_dir=os.path.join(tmp, f'report{rank}'))
        torch.save(out, os.path.join(tmp, f'rank{rank}.pt'))
    finally:
        distributed.shutdown()


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The two ranks and ``calc_metrics --gpus 2`` (on threads of this
    process, each spawning its pair), while this process computes the
    one-process results."""
    tmp = str(tmp_path_factory.mktemp('metrics_ddp'))
    data = make_synthetic_layer_dataset(os.path.join(tmp, 'layers'),
                                        num_samples=7, size=32, spec=SPEC)
    for r in range(WORLD):
        os.makedirs(os.path.join(tmp, f'report{r}'))
    snaps = {}
    for n in (1, 2):
        d = os.path.join(tmp, f'gpus{n}')
        os.makedirs(d)
        snaps[n] = os.path.join(d, 'ema-snapshot-000000.pt')
        ckpt.save_checkpoint(snaps[n], MontageConfig(**MICRO_GLOBAL),
                             _model())

    def argv(n):
        return ['--network', snaps[n], '--data', data, '--metrics',
                'ppl2_wend', '--ppl-samples', '12', '--batch', '4',
                '--extractor', 'random', '--gpus', str(n), '--device', 'cpu',
                '--cache-dir', os.path.join(tmp, f'cache{n}')]
    errors = {}

    def run(name, fn, *args):
        def target():
            try:
                fn(*args)
            except Exception as e:          # re-raised below
                errors[name] = e
        thread = threading.Thread(target=target)
        thread.start()
        return thread
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('OMP_NUM_THREADS', '1')
        threads = [run('ranks', distributed.launch, _rank_worker, WORLD,
                       (distributed.free_port(), data, tmp), 'cpu'),
                   run('cli', calc_metrics.main, argv(2))]
        try:
            one = compute_all(data, os.path.join(tmp, 'cache-one'))
            calc_metrics.main(argv(1))
        finally:
            for thread in threads:
                thread.join(timeout=300)
    for e in errors.values():
        raise e
    ranks = [torch.load(os.path.join(tmp, f'rank{r}.pt'), weights_only=False)
             for r in range(WORLD)]
    return dict(tmp=tmp, one=one, ranks=ranks, snaps=snaps)


@pytest.mark.parametrize('loop', ['dataset', 'generator'])
@pytest.mark.parametrize('rank', range(WORLD))
def test_feature_loops_equal_one_process(runs, loop, rank):
    got, want = runs['ranks'][rank][loop], runs['one'][loop]
    assert got['n'] == want['n'] == {'dataset': 7, 'generator': 20}[loop]
    for k in ('all', 'mean', 'cov'):
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                              want[k]), k


@pytest.mark.parametrize('rank', range(WORLD))
def test_ppl_distances_equal_one_process(runs, rank):
    got, want = runs['ranks'][rank]['ppl'], runs['one']['ppl']
    assert got.shape == (10,) and torch.equal(got, want)


@pytest.mark.parametrize('metric', ['fid', 'fid_cached', 'ppl2_wend'])
def test_every_rank_returns_the_one_process_result(runs, metric):
    want = runs['one'][metric]
    assert all(r[metric] == want for r in runs['ranks'])
    assert [r['num_gpus'] for r in runs['ranks']] == [WORLD] * WORLD
    assert runs['one']['num_gpus'] == 1


def test_rank_0_alone_writes(runs):
    tmp = runs['tmp']
    assert len(os.listdir(os.path.join(tmp, 'cache-rank0'))) == 1
    assert not os.path.exists(os.path.join(tmp, 'cache-rank1'))
    assert os.listdir(os.path.join(tmp, 'report0')) == [
        'metric-ppl2_wend.jsonl']
    assert os.listdir(os.path.join(tmp, 'report1')) == []
    # the cached statistics are the one process's
    ranks, one = (os.path.join(tmp, d, os.listdir(os.path.join(tmp, d))[0])
                  for d in ('cache-rank0', 'cache-one'))
    assert os.path.basename(ranks) == os.path.basename(one)
    ranks, one = (metric_utils.FeatureStats.load(p) for p in (ranks, one))
    assert ranks.num_items == one.num_items == 7
    assert torch.equal(ranks.raw_cov, one.raw_cov)
    assert torch.equal(ranks.raw_mean, one.raw_mean)


def test_calc_metrics_gpus_2_equals_one_process(runs):
    records = {}
    for n, snap in runs['snaps'].items():
        with open(os.path.join(os.path.dirname(snap),
                               'metric-ppl2_wend.jsonl')) as f:
            lines = f.readlines()
        assert len(lines) == 1
        records[n] = json.loads(lines[0])
    assert records[2]['num_gpus'] == 2 and records[1]['num_gpus'] == 1
    assert records[2]['results'] == records[1]['results']
