"""A cell, a configuration, a traffic mix and a per-layer metric are found
by name: adding one takes new files and entries, and no edit to a file the
benchmark already has."""

import json
import shutil

from benchmark import harness, spec


def test_new_cell_config_traffic_and_metric_by_name(tmp_path):
    root = tmp_path / 'checkout'
    shutil.copytree(spec.BENCH_DIR, root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    bench = spec.load_json(spec.ROOT / 'BENCHMARK.json')
    before = {p: p.read_bytes() for p in (root / 'benchmark').rglob('*')
              if p.is_file()}
    # new files only
    cfg = spec.load_json(spec.BENCH_DIR / 'configs' / 'paper256.json')
    cfg['name'] = 'paper256_noaug'
    (root / 'benchmark' / 'configs' / 'paper256_noaug.json').write_text(
        json.dumps(cfg))
    (root / 'benchmark' / 'traffic' / 'images-b8.json').write_text(
        json.dumps({'kind': 'images', 'batch': 8, 'samples': 16,
                    'augment_p': 0.0, 'warmup_steps': [0, 1, 4],
                    'window_start': 16, 'profile_steps': [16]}))
    (root / 'benchmark' / 'metrics' / 'steps_in_window.py').write_text(
        'def read(r):\n    return float(len(r.window_steps))\n')
    # new entries in BENCHMARK.json
    bench['configs'].append({'name': 'paper256_noaug', 'source': 'x',
                             'file': 'benchmark/configs/paper256_noaug.json',
                             'reduced': [], 'why': 'x'})
    bench['workloads'].append({'name': 'paper256_noaug-b8',
                               'config': 'paper256_noaug',
                               'traffic': 'images-b8', 'chips': 1,
                               'why': 'x'})
    bench['per_layer'].append({'name': 'steps_in_window', 'unit': 'steps',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'training step',
                               'moves': 'train_images_per_s',
                               'workloads': ['paper256_noaug-b8']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))

    cell = spec.load_cell('paper256_noaug-b8', root)
    assert cell.config['name'] == 'paper256_noaug'
    assert cell.traffic['batch'] == 8
    assert [m['name'] for m in cell.per_layer][-1] == 'steps_in_window'
    assert 'train_images_per_s' in [m['name'] for m in cell.end_to_end]
    read = harness.load_reader('steps_in_window', root)
    assert read(harness.Readings(cell, 8, [16, 17, 18], 1.0, [0.0] * 3,
                                 lambda c: 1.0)) == 3.0
    after = {p: p.read_bytes() for p in before}
    assert after == before                   # nothing that was there changed
