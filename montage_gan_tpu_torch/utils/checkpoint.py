"""Checkpoints of the port, and the reader of the JAX package's EMA
snapshots.

The port's own checkpoint is one ``torch.save`` file of
``{'config': dataclasses.asdict(cfg), 'state_dict': ...}``; the training
loop's EMA snapshots (``save_ema_snapshot``) take that format, so
``cli/generate.py`` samples from them.  A train-state snapshot
(``save_train_state``) is one ``torch.save`` file of everything a step
reads: the ensemble's state dict, the EMA's, every optimizer's
``state_dict()``, ``pl_mean``, the ADA controller and ``step``.  Every file
is written to a ``.tmp`` path and then renamed, so a snapshot on disk is
whole.  In a data-parallel run rank 0 writes (the ranks' states are
identical, ``training/loop_aio.py``) and every rank reads the same file
onto its own card.

A JAX EMA snapshot is a pair ``<name>.msgpack`` + ``<name>.json``
(``montage_gan_tpu/utils/checkpoint.py:57-87``): the JSON holds the
``MontageConfig``; the msgpack holds flax's serialization of the variable
tree, whose arrays are msgpack ext type 1, a packed
``(shape, dtype name, C-order bytes)`` (type 3 the same for a numpy
scalar).  It is decoded with the ``msgpack`` package, imported only here.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.ensemble import MontageConfig, MontageEnsemble
from .weights import state_dict_from_jax

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _save(path: str, payload: Dict[str, Any]) -> None:
    tmp = path + '.tmp'
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, cfg: MontageConfig,
                    model: MontageEnsemble) -> None:
    _save(path, {'config': dataclasses.asdict(cfg),
                 'state_dict': model.state_dict()})


def save_ema_snapshot(path: str, cfg: MontageConfig, ema: MontageEnsemble,
                      renderer: Optional[torch.nn.Module] = None) -> None:
    """The sampling snapshot of a training run, in ``save_checkpoint``'s
    format: the EMA's mapping, local Gs and STN, and the live renderer
    (the JAX package's ``save_ema_snapshot``, ``utils/checkpoint.py:
    62-71``)."""
    state_dict = dict(ema.state_dict())
    if renderer is not None:
        state_dict.update({f'renderer.{k}': v
                           for k, v in renderer.state_dict().items()})
    _save(path, {'config': dataclasses.asdict(cfg),
                 'state_dict': state_dict})


_OPTIMIZERS = ('opt_local_g', 'opt_local_d', 'opt_global_g', 'opt_global_d',
               'opt_renderer')
_CONTROLLER = ('pl_mean', 'aug_p', 'ada_sign_sum', 'ada_sign_count')


def train_state_tensors(state):
    """``(name, tensor)`` of everything a train state holds, in one order
    for every process: the ensemble's and the EMA's state dicts, every
    optimizer's state tensors and the controller (what
    ``parallel.mesh.replicate`` broadcasts and ``assert_replicated``
    checks)."""
    for prefix, module in (('model', state.model), ('ema', state.ema)):
        for k, v in module.state_dict().items():
            yield f'{prefix}.{k}', v
    for name in _OPTIMIZERS:
        opt = getattr(state, name)
        opts = opt if isinstance(opt, list) else [] if opt is None else [opt]
        for i, o in enumerate(opts):
            for j, p in enumerate(p for g in o.param_groups
                                  for p in g['params']):
                for k, v in sorted(o.state.get(p, {}).items()):
                    if isinstance(v, torch.Tensor):
                        yield f'{name}.{i}.{j}.{k}', v
    for name in _CONTROLLER:
        yield name, getattr(state, name)


def save_train_state(run_dir: str, kimg: int, state) -> str:
    """Write ``network-snapshot-{kimg:06d}.pt`` in ``run_dir`` from a
    ``training.train_step.MontageTrainState``; returns its path."""
    path = os.path.join(run_dir, f'network-snapshot-{kimg:06d}.pt')
    payload = {'config': dataclasses.asdict(state.model.cfg),
               'model': state.model.state_dict(),
               'ema': state.ema.state_dict(), 'step': int(state.step)}
    for name in _OPTIMIZERS:
        opt = getattr(state, name)
        payload[name] = ([o.state_dict() for o in opt]
                         if isinstance(opt, list) else
                         None if opt is None else opt.state_dict())
    for name in _CONTROLLER:
        payload[name] = getattr(state, name)
    _save(path, payload)
    return path


def restore_train_state(path: str, trainer):
    """The ``MontageTrainState`` a ``save_train_state`` file holds, on
    ``trainer``'s device, around ``trainer``'s ensemble (whose config must
    be the snapshot's).  The next step from it is the step the saving run
    would have taken."""
    if path.endswith('.msgpack'):
        raise ValueError(f'{path}: a JAX train state; its optax moments do '
                         'not carry over to the port (ROADMAP §3, "JAX train '
                         'states on --resume"). Resume from a port snapshot '
                         '(.pt)')
    # Read on the host: each load_state_dict below moves what it takes to
    # the trainer's device, as a fresh run has it (Adam keeps its step
    # count on the host; one on the card would sync at every update).
    ckpt = torch.load(path, map_location='cpu', weights_only=True,
                      mmap=True)
    cfg = MontageConfig.from_dict(ckpt['config'])
    if cfg != trainer.ens.cfg:
        raise ValueError(f'{path}: the snapshot\'s config {cfg} is not the '
                         f'trainer\'s {trainer.ens.cfg}')
    state = trainer.state_from_variables(ckpt['model'])
    state.ema.load_state_dict(ckpt['ema'])
    for name in _OPTIMIZERS:
        opt, saved = getattr(state, name), ckpt[name]
        opts = opt if isinstance(opt, list) else [] if opt is None else [opt]
        saved = saved if isinstance(saved, list) else (
            [] if saved is None else [saved])
        if len(opts) != len(saved):
            raise ValueError(f'{path}: {len(saved)} {name} states, the '
                             f'trainer has {len(opts)}')
        for o, sd in zip(opts, saved):
            o.load_state_dict(sd)
    for name in _CONTROLLER:
        getattr(state, name).copy_(ckpt[name])
    state.step = int(ckpt['step'])
    return state


def _decode_ndarray(data: bytes) -> np.ndarray:
    import msgpack
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(
        shape, order='C')


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """A flax-serialized variable tree → nested dicts of numpy arrays."""
    import msgpack

    def ext_hook(code, data):
        if code == _EXT_NDARRAY:
            return _decode_ndarray(data)
        if code == _EXT_NPSCALAR:
            return _decode_ndarray(data)[()]
        raise ValueError(f'{path}: unsupported msgpack ext type {code}')

    with open(path, 'rb') as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)

    def check(node):
        if isinstance(node, dict):
            if '__msgpack_chunked_array__' in node:
                raise ValueError(f'{path}: chunked arrays are not supported')
            for v in node.values():
                check(v)

    check(tree)
    return tree


def load_jax_snapshot(path: str) -> Tuple[MontageConfig, Dict[str, Any]]:
    """(config, variable tree) of a JAX EMA snapshot pair."""
    base = path[:-len('.msgpack')] if path.endswith('.msgpack') else path
    with open(base + '.json') as f:
        cfg = MontageConfig.from_dict(json.load(f))
    return cfg, read_flax_msgpack(base + '.msgpack')


def load_network(path: str, device='cuda') -> Tuple[MontageConfig,
                                                    MontageEnsemble]:
    """A port checkpoint, or a JAX EMA snapshot (``.msgpack`` with its
    ``.json``), as (config, model in eval mode on ``device``).  A snapshot
    saved without its renderer gives a model without one."""
    base = path[:-len('.msgpack')] if path.endswith('.msgpack') else path
    if path.endswith('.msgpack') or os.path.exists(base + '.json'):
        cfg, tree = load_jax_snapshot(path)
        state_dict = state_dict_from_jax(cfg, tree)
    else:
        ckpt = torch.load(path, map_location='cpu', weights_only=True)
        cfg = MontageConfig.from_dict(ckpt['config'])
        state_dict = ckpt['state_dict']
    model = MontageEnsemble(cfg)
    if not any(k.startswith('renderer.') for k in state_dict):
        model.renderer = None
    model.load_state_dict(state_dict)
    return cfg, model.to(device).eval().requires_grad_(False)
