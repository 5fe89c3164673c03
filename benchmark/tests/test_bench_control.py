"""The control comes out not correct: the plain reference a step below the
configuration's precision (float32 in TF32, the bfloat16 blocks'
convolutions through float8), put in the port's place, fails one of the
cell's limits.  On the CPU at micro widths (where TF32 does not exist and
the float8 rounding alone acts), and on a card at each cell's own size,
where each case takes minutes (``aio-b32``: the reference's three AIO steps
at batch 32, twice)."""

import pytest
import torch

from benchmark import calibrate, check, spec
from test_bench_correct import SEED, micro

SEEDS = {'aio-b32': 2**31 + 101, 'paper256-b64': 2**31 + 201}


def fails_a_limit(cell, found):
    limits = check.limits(cell)
    return any(found[k] > lim for k, lim in limits.items())


def test_control_fails_a_limit_at_micro_widths():
    cell = micro('paper256-b64')
    found = calibrate.readings(cell, SEED, torch.device('cpu'), {'control'})
    assert fails_a_limit(cell, found['control']), found['control']


@pytest.mark.card
@pytest.mark.parametrize('name', sorted(SEEDS))
def test_control_fails_a_limit_at_cell_size(card, name):
    cell = spec.load_cell(name)
    found = calibrate.readings(cell, SEEDS[name], card, {'control'})
    assert fails_a_limit(cell, found['control']), found['control']
