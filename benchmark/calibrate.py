"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds ...] [--tf32-seeds ...] [--fault-seeds ...] \
        [--out FILE] [--dump DIR]

For each seed, in one process on the card, the plain reference follows the
cell's warm-up steps once (the first alone where the cell compares only
first-step numbers), and is compared with:

- ``port``: the port through the same steps, as a run's set-up drives it
  (the lower readings: what sound runs read);
- ``control``: the reference itself a step below the configuration's
  precision, put in the port's place: its float32 in TF32 (the
  configuration states float32 with TF32 off) and its bfloat16 blocks'
  convolutions through float8;
- ``tf32``: the same with TF32 alone (the float32 parts' step down);
- ``half_batch``: the reference put in the port's place with half of each
  batch left out, the losses the mean over the rest (a planted fault);
- ``no_update``: the port with no optimizer step and no EMA
  (``faults.no_update``; a fault seed runs it).

Each comparison prints one JSON line of the numbers ``check.numbers``
finds."""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import check, data, faults, harness, spec  # noqa: E402
from benchmark.weights import seeded_state  # noqa: E402


def port_record(cell, seed, dev, data_dir, steps, hook=None):
    """The port through the first ``steps`` warm-up steps, as ``run_cell``
    drives it, ``hook`` planted first."""
    ref_cfg, _ = spec.build_reference(cell.config, cell.traffic)
    ref_ens = seeded_state(ref_cfg, seed, dev)
    port = harness.PortRun(cell, seed, dev, data_dir, ref_ens)
    initial = {k: v.detach().cpu() for k, v in ref_ens.named_parameters()}
    del ref_ens
    if hook is not None:
        hook(port)
    try:
        return harness.warmup_and_record(
            port, list(cell.traffic['warmup_steps'])[:steps], initial,
            port.feed, port.step)
    finally:
        port.close()
        del port, initial
        gc.collect()
        if dev.type == 'cuda':
            torch.cuda.empty_cache()


def readings(cell, seed, dev, kinds, dump=None):
    """``{kind: check.numbers(...)}`` for the kinds asked, on one seed;
    with ``dump`` a directory, every record is also written there as
    JSON."""
    steps = check.steps_needed(check.limits(cell),
                               len(cell.traffic['warmup_steps']))
    data_dir = tempfile.mkdtemp(prefix='bench-data-')
    try:
        data.write_dataset(data_dir, cell.traffic['kind'],
                           int(cell.traffic['samples']), seed,
                           len(cell.config['model']['layer_names']))
        records = {}
        if 'port' in kinds:
            records['port'] = port_record(cell, seed, dev, data_dir, steps)
        if 'no_update' in kinds:
            records['no_update'] = port_record(cell, seed, dev, data_dir,
                                               steps, faults.no_update)
        records['reference'] = ref = harness.reference_record(
            cell, seed, dev, data_dir, steps=steps)
        if 'control' in kinds:
            records['control'] = harness.reference_record(
                cell, seed, dev, data_dir, control=True, steps=steps)
        if 'tf32' in kinds:
            records['tf32'] = harness.reference_record(
                cell, seed, dev, data_dir, tf32=True, steps=steps)
        if 'half_batch' in kinds:
            records['half_batch'] = harness.reference_record(
                cell, seed, dev, data_dir, steps=steps,
                rows=int(cell.traffic['batch']) // 2)
        if dump:
            os.makedirs(dump, exist_ok=True)
            with open(os.path.join(dump, f'{cell.name}-{seed}.json'),
                      'w') as f:
                json.dump(records, f)
        return {k: check.numbers(r, ref) for k, r in records.items()
                if k != 'reference'}
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', default='')
    p.add_argument('--control-seeds', default='')
    p.add_argument('--tf32-seeds', default='')
    p.add_argument('--fault-seeds', default='')
    p.add_argument('--out', default=None)
    p.add_argument('--dump', default=None,
                   help='a directory for every record, as JSON')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 2
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    cell = spec.load_cell(args.workload)

    def seeds(text):
        return [int(s) for s in text.split(',') if s]
    kinds_of = {}
    for kinds, text in ((('port',), args.seeds),
                        (('control',), args.control_seeds),
                        (('tf32',), args.tf32_seeds),
                        (('half_batch', 'no_update'), args.fault_seeds)):
        for s in seeds(text):
            kinds_of.setdefault(s, set()).update(kinds)
    sink = open(args.out, 'a') if args.out else None
    for seed, kinds in kinds_of.items():
        t = time.perf_counter()
        for kind, found in readings(cell, seed, dev, kinds, args.dump).items():
            line = json.dumps({'cell': cell.name, 'seed': seed, 'kind': kind,
                               **found})
            print(line, flush=True)
            if sink:
                sink.write(line + '\n')
                sink.flush()
        print(f'seed {seed}: {time.perf_counter() - t:.1f} s',
              file=sys.stderr, flush=True)
    if sink:
        sink.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
