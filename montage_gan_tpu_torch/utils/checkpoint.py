"""Checkpoints of the port, and the reader of the JAX package's EMA
snapshots.

The port's own checkpoint is one ``torch.save`` file of
``{'config': dataclasses.asdict(cfg), 'state_dict': ...}``.

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
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.ensemble import MontageConfig, MontageEnsemble
from .weights import state_dict_from_jax

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def save_checkpoint(path: str, cfg: MontageConfig,
                    model: MontageEnsemble) -> None:
    tmp = path + '.tmp'
    torch.save({'config': dataclasses.asdict(cfg),
                'state_dict': model.state_dict()}, tmp)
    os.replace(tmp, path)


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


def load_network(path: str, device='cpu') -> Tuple[MontageConfig,
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
