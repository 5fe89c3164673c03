"""The comparison that decides ``correct``.

Each item's gap is ``|port - reference| / max(|reference|, median
|reference| of its kind)``: the median guards items that are all but zero,
as some gradients are.  The numbers, each over the cell's warm-up steps:

- ``loss0_median``: the first step's losses (``stats`` without the sign
  shares and the augment probabilities), the median loss's gap.
- ``grad_median``: the first step's gradients as each phase hands them to
  its optimizer (``PhaseGrads``), per parameter a norm: each phase's
  median parameter's gap, the median over the phases.
- ``change0_median``: each parameter's change over the first step, as a
  norm, of the live networks (every phase's optimizer steps) and of the EMA
  apart: the larger of the two groups' median parameter's gap.  Parameters
  whose reference gradient (the root of the optimizers' second moments
  after the first step) is under a thousandth of the median parameter's
  are left out: they move by round-off alone under Adam.
- ``change_median``: the same over the whole warm-up.

The worst-item numbers are ill-conditioned at random weights (PERF.md), so
the cells compare these steady ones; ``limits/<cell>.json`` lists the
numbers a cell compares, with the readings each limit was set from."""

from __future__ import annotations

import json
import math
import statistics
import sys
from typing import Dict, List, Tuple

import torch

from .spec import BENCH_DIR

SKIP_STATS = ('/signs/', 'Progress/')
QUIET_GRADIENT = 1e-3


def losses_of(stats: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = sorted(k for k in stats if not any(s in k for s in SKIP_STATS))
    if not keys:
        return {}
    values = torch.stack([stats[k].detach().float().reshape(())
                          for k in keys]).tolist()
    return dict(zip(keys, values))


def _optimizers(state) -> List[Tuple[str, object]]:
    out = [('renderer', state.opt_renderer)]
    out += [(f'local_g{i}', o) for i, o in enumerate(state.opt_local_g)]
    out += [(f'local_d{i}', o) for i, o in enumerate(state.opt_local_d)]
    out += [('global_g', state.opt_global_g), ('global_d', state.opt_global_d)]
    return [(n, o) for n, o in out if o is not None]


@torch.no_grad()
def optimizer_grad_norms(state) -> Dict[str, float]:
    """``'<optimizer>:<parameter>'`` → the root of the summed second moment."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    keys, norms = [], []
    for label, opt in _optimizers(state):
        for group in opt.param_groups:
            for p in group['params']:
                st = opt.state.get(p, {})
                second = st.get('exp_avg_sq', st.get('nu'))
                if second is None:
                    continue
                keys.append(f'{label}:{names[id(p)]}')
                norms.append(second.double().sum().sqrt())
    return dict(zip(keys, torch.stack(norms).tolist())) if norms else {}


@torch.no_grad()
def change_norms(state, initial: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each live and EMA parameter's distance from ``initial``."""
    keys, norms = [], []
    for prefix, module in (('', state.model), ('ema.', state.ema)):
        for name, p in module.named_parameters():
            if name in initial:
                keys.append(prefix + name)
                start = initial[name].to(p.device, non_blocking=True)
                norms.append((p.double() - start.double()).norm())
    return dict(zip(keys, torch.stack(norms).tolist())) if norms else {}


class PhaseGrads:
    """A trainer's ``phase_hook``: each phase's gradients' norms, as
    ``'<phase>:<index>'`` → norm, in the order the phases run."""

    def __init__(self, into: Dict[str, float]):
        self.into = into

    @torch.no_grad()
    def __call__(self, name: str, grads) -> None:
        keys, norms = [], []
        dev = next((g.device for g in grads if g is not None), 'cpu')
        for i, g in enumerate(grads):
            # no gradient: the optimizer takes zeros (train_step._apply_grads)
            keys.append(f'{name}:{i}')
            norms.append(g.double().norm() if g is not None else
                         torch.zeros((), dtype=torch.float64, device=dev))
        if norms:
            self.into.update(zip(keys, torch.stack(norms).tolist()))


def item_gaps(port: Dict[str, float], ref: Dict[str, float],
              keys) -> Dict[str, float]:
    """Each item's ``|port - ref| / max(|ref|, median |ref|)``; an item the
    port lacks, or not finite, is infinite."""
    keys = list(keys)
    if not keys:
        return {}
    med = statistics.median(abs(ref[k]) for k in keys)
    out = {}
    for k in keys:
        p = port.get(k)
        scale = max(abs(ref[k]), med)
        if p is None or not math.isfinite(p):
            out[k] = math.inf
        elif scale > 0:
            out[k] = abs(p - ref[k]) / scale
        else:
            out[k] = 0.0 if p == ref[k] else math.inf
    return out


def _median(g: Dict[str, float]) -> float:
    return statistics.median(g.values()) if g else 0.0


def loss0_median(port: Dict, ref: Dict) -> float:
    p, r = port['losses'][0] if port['losses'] else {}, ref['losses'][0]
    if set(p) != set(r):
        return math.inf
    return _median(item_gaps(p, r, r))


def grad_median(port: Dict, ref: Dict) -> float:
    by_phase: Dict[str, Dict[str, float]] = {}
    for k, v in item_gaps(port['phases'], ref['phases'],
                          ref['phases']).items():
        by_phase.setdefault(k.split(':')[0], {})[k] = v
    return _median({p: _median(g) for p, g in by_phase.items()})


def _change_median(port: Dict, ref: Dict, key: str) -> float:
    """``key``'s changes: the larger of the live parameters' and the EMA's
    median gap, the leaves with a quiet reference gradient left out."""
    by_param: Dict[str, float] = {}
    for k, v in ref['moments'].items():
        name = k.split(':', 1)[1]
        by_param[name] = max(by_param.get(name, 0.0), v)
    med = _median(by_param)
    groups: Dict[bool, List[str]] = {False: [], True: []}
    for k in ref[key]:
        ema = k.startswith('ema.')
        if by_param.get(k[4:] if ema else k, 0.0) >= QUIET_GRADIENT * med:
            groups[ema].append(k)
    return max(_median(item_gaps(port.get(key, {}), ref[key], keys))
               for keys in groups.values())


def change0_median(port: Dict, ref: Dict) -> float:
    return _change_median(port, ref, 'changes0')


def change_median(port: Dict, ref: Dict) -> float:
    return _change_median(port, ref, 'changes')


NUMBERS = {f.__name__: f for f in (loss0_median, grad_median, change0_median,
                                   change_median)}
# the numbers that read only the first warm-up step
FIRST_STEP = ('loss0_median', 'grad_median', 'change0_median')


def steps_needed(limit: Dict[str, float], warmup: int) -> int:
    """How many warm-up steps the reference follows: the first alone
    where every compared number reads only it."""
    return 1 if all(k in FIRST_STEP for k in limit) else warmup


def numbers(port: Dict, ref: Dict, names=None) -> Dict[str, float]:
    """The numbers ``names`` (those the records allow by default: the
    whole warm-up's only where the reference followed it all)."""
    if names is None:
        names = [n for n in NUMBERS if n in FIRST_STEP
                 or len(ref['losses']) == len(port['losses'])]
    return {n: NUMBERS[n](port, ref) for n in names}


def limits(cell) -> Dict[str, float]:
    with open(BENCH_DIR / 'limits' / f'{cell.name}.json') as f:
        return {k: float(v) for k, v in json.load(f)['limits'].items()}


def compare(port: Dict, ref: Dict, limit: Dict[str, float]) -> Dict:
    """``{name: {'value', 'limit'}}`` of the numbers ``limit`` lists."""
    found = numbers(port, ref, list(limit))
    return {name: {'value': min(found[name], sys.float_info.max),
                   'limit': lim}
            for name, lim in limit.items()}
