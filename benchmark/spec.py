"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``configs/<config>.json``, ``traffic/<traffic>.json``."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with its configuration and traffic."""
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: tuple     # the entries of end_to_end this cell reports
    per_layer: tuple      # the entries of per_layer this cell reports


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises ``KeyError`` for
    a name it does not list."""
    bench = load_json(root / 'BENCHMARK.json')
    entries = {w['name']: w for w in bench['workloads']}
    if name not in entries:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json '
                       f'(it has {sorted(entries)})')
    w = entries[name]
    configs = {c['name']: c for c in bench['configs']}
    config = load_json(root / configs[w['config']]['file'])
    traffic = load_json(root / 'benchmark' / 'traffic'
                        / f"{w['traffic']}.json")
    return Cell(
        name=name, chips=int(w['chips']), config=config, traffic=traffic,
        end_to_end=tuple(m for m in bench['end_to_end'] if _reports(m, name)),
        per_layer=tuple(m for m in bench['per_layer'] if _reports(m, name)))


def model_kwargs(config: Dict[str, Any]) -> Dict[str, Any]:
    """``MontageConfig`` keyword arguments of a configuration file (the
    port's and the reference's class take the same)."""
    m = dict(config['model'])
    m['layer_names'] = tuple(m['layer_names'])
    m['layer_targets'] = tuple(tuple(t) for t in m['layer_targets'])
    return m


def hyper_kwargs(config: Dict[str, Any], traffic: Dict[str, Any]
                 ) -> Dict[str, Any]:
    """``TrainHyper`` keyword arguments, without ``augment``: the
    configuration's published values, the traffic's batch and starting p."""
    h = dict(config['hyper'])
    h['batch_size'] = int(traffic['batch'])
    h['augment_p_init'] = float(traffic['augment_p'])
    return h


def build_port(config: Dict[str, Any], traffic: Dict[str, Any]):
    """The port's ``(MontageConfig, TrainHyper)`` of a cell."""
    from montage_gan_tpu_torch.models.ensemble import MontageConfig
    from montage_gan_tpu_torch.training.augment import make_augment_config
    from montage_gan_tpu_torch.training.train_step import TrainHyper
    return (MontageConfig(**model_kwargs(config)),
            TrainHyper(augment=make_augment_config(config['augpipe']),
                       **hyper_kwargs(config, traffic)))


def build_reference(config: Dict[str, Any], traffic: Dict[str, Any]):
    """The plain reference's ``(MontageConfig, TrainHyper)`` of a cell."""
    from .reference.augment import make_augment_config
    from .reference.ensemble import MontageConfig
    from .reference.train_step import TrainHyper
    return (MontageConfig(**model_kwargs(config)),
            TrainHyper(augment=make_augment_config(config['augpipe']),
                       **hyper_kwargs(config, traffic)))
