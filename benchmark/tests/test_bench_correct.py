"""``correct`` comes out false when the timed path is broken.

Each test drives a whole run of a cell on the CPU (the look for a card is
skipped: ``run_cell`` is called with the CPU) at micro widths, where the
port takes its plain routes and agrees with the reference exactly, with the
port's trainer broken after set-up (``benchmark/faults.py``): a step that
runs every phase and hands its gradients on but moves no parameter and no
EMA, and a step that leaves half of the batch out (its losses the mean
over the rest).  A sound run of the same size comes out correct; the
first fault fails the number that reads the parameters' change."""

import dataclasses
import json
import time

import pytest
import torch

from benchmark import harness, spec
from benchmark.faults import half_batch, no_update

SEED = 2**31 + 11


def micro(name, layers=None):
    """The cell at micro widths: channels 256/res capped at 16, batch 4,
    8 samples, one profiled step."""
    cell = spec.load_cell(name)
    config = json.loads(json.dumps(cell.config))
    config['model'].update(channel_base=256, channel_max=16)
    if layers is not None:
        for key in ('layer_names', 'layer_targets'):
            config['model'][key] = config['model'][key][:layers]
    traffic = dict(cell.traffic, batch=4, samples=8, profile_steps=[17])
    return dataclasses.replace(cell, config=config, traffic=traffic)


def run(cell, hook=None):
    torch.manual_seed(0)
    return harness.run_cell(cell, SEED, 0.5, False, torch.device('cpu'),
                            time.perf_counter(), port_hook=hook)


@pytest.mark.parametrize('hook', [None, no_update, half_batch],
                         ids=['sound', 'unchanged', 'half_batch'])
def test_paper256_faults_come_out_not_correct(hook):
    out = run(micro('paper256-b64'), hook)
    assert out['correct'] is (hook is None), out['compared']
    if hook is no_update:
        c = out['compared']['change_median']
        assert c['value'] > c['limit'], out['compared']
    assert list(out) == ['correct', 'attempted', 'failed', 'metrics',
                         'device', 'compared']


@pytest.mark.parametrize('hook', [None, no_update, half_batch],
                         ids=['sound', 'unchanged', 'half_batch'])
def test_aio_faults_come_out_not_correct(hook):
    """The AIO step at two layers (its renderer, STN and global D are the
    base resolution's whatever the layer count)."""
    out = run(micro('aio-b32', layers=2), hook)
    assert out['correct'] is (hook is None), out['compared']
    if hook is no_update:
        c = out['compared']['change0_median']
        assert c['value'] > c['limit'], out['compared']
