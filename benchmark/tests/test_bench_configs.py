"""Each configuration file holds what the port's CLIs resolve for its
published config: ``cli/train_aio.py`` for ``aio`` and ``cli/train.py`` for
``paper256``, from their ``CFG_SPECS``.  The harness builds the port's
``MontageConfig`` and ``TrainHyper`` from the file, never from a CLI; the
cell's traffic sets the batch and the starting p."""

import dataclasses

from benchmark import data, spec

# fields of MontageConfig that train_aio reads from the dataset's statistics
# (the file holds the reference dataset's crops, DEFAULT_LAYER_TARGETS)
FROM_DATA = ('layer_names', 'layer_targets')


def _file(name):
    return spec.load_json(spec.BENCH_DIR / 'configs' / f'{name}.json')


def _traffic(name):
    return spec.load_json(spec.BENCH_DIR / 'traffic' / f'{name}.json')


def _same(a, b, skip=()):
    for f in dataclasses.fields(a):
        if f.name not in skip:
            assert getattr(a, f.name) == getattr(b, f.name), f.name


def test_aio_file_is_what_train_aio_resolves(tmp_path):
    from montage_gan_tpu_torch.cli import train_aio
    from montage_gan_tpu_torch.models.ensemble import MontageConfig
    data.write_dataset(str(tmp_path / 'd'), 'layers', 2, 0)
    opts = train_aio.parse_options(['--data', str(tmp_path / 'd'),
                                    '--outdir', str(tmp_path / 'o'),
                                    '--cfg', 'aio'])
    kw = train_aio.setup_training_loop_kwargs(opts, ranks=1)
    config, traffic = _file('aio'), _traffic('layers-b32')
    cfg, hyper = spec.build_port(config, traffic)
    _same(cfg, kw.cfg, skip=FROM_DATA)
    assert cfg.layer_targets == MontageConfig().layer_targets
    assert cfg.layer_names == MontageConfig().layer_names
    _same(hyper, kw.hyper, skip=('augment_p_init',))
    spec_aio = train_aio.CFG_SPECS['aio']
    assert traffic['batch'] == spec_aio['mb'] == hyper.batch_size
    assert config['model']['mbstd_group_size'] == spec_aio['mbstd']
    assert config['hyper']['ema_kimg'] == spec_aio['ema']
    assert config['hyper']['r1_gamma'] == spec_aio['gamma']
    assert config['model']['channel_base'] == int(spec_aio['fmaps'] * 32768)
    assert config['reduced'] == []


def test_paper256_file_is_what_train_resolves(tmp_path):
    from montage_gan_tpu_torch.cli import train
    from montage_gan_tpu_torch.utils.config import EasyDict
    data.write_dataset(str(tmp_path / 'd'), 'images', 2, 0)
    opts = EasyDict(vars(train.make_parser().parse_args(
        ['--data', str(tmp_path / 'd'), '--outdir', str(tmp_path / 'o'),
         '--cfg', 'paper256', '--augpipe', 'bgc'])))
    run = train.setup(opts, 1)
    config, traffic = _file('paper256'), _traffic('images-b64')
    cfg, hyper = spec.build_port(config, traffic)
    _same(cfg, run.cfg)
    _same(hyper, run.hyper, skip=('augment_p_init',))
    spec_p = train.CFG_SPECS['paper256']
    assert traffic['batch'] == spec_p['mb'] == hyper.batch_size
    assert config['model']['mbstd_group_size'] == spec_p['mbstd']
    assert config['hyper']['ema_kimg'] == spec_p['ema']
    assert config['reduced'] == []


def test_benchmark_json_names_each_file():
    bench = spec.load_json(spec.ROOT / 'BENCHMARK.json')
    for c in bench['configs']:
        assert (spec.ROOT / c['file']).is_file()
        assert _file(c['name'])['name'] == c['name']
        assert c['reduced'] == _file(c['name'])['reduced']
    for w in bench['workloads']:
        assert (spec.BENCH_DIR / 'traffic' / f"{w['traffic']}.json").is_file()
        assert (spec.BENCH_DIR / 'limits' / f"{w['name']}.json").is_file()
    for m in bench['per_layer']:
        assert (spec.BENCH_DIR / 'metrics' / f"{m['name']}.py").is_file()
