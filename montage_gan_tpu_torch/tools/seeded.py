"""Seeded stand-ins that the card's checks share (``chip_smoke.py``,
``tools/ddp_check.py``, the CPU tests): a config's ensemble with seeded
weights, random-weight detector files in a drop-in directory, and a
reference SG2-ADA ``.pkl`` of a seeded generator."""

from __future__ import annotations

import os
import pickle
import sys
import types
from collections import OrderedDict
from typing import Any, Dict, Optional

import torch

from ..metrics import inception_net, vgg16_net
from ..models.ensemble import MontageEnsemble


def write_random_detectors(dirpath: str, seed: int = 0) -> dict:
    """Seeded random InceptionV3 and VGG16-LPIPS parameters as the drop-in
    ``.npz`` files (``inception.npz``, ``vgg16.npz``) in ``dirpath``, where
    ``MGT_WEIGHTS_DIR`` makes ``build_extractor('auto')`` and
    ``('auto_lpips')`` find them: the detectors' architectures and costs,
    not their features.  Returns the paths."""
    os.makedirs(dirpath, exist_ok=True)
    paths = dict(inception=os.path.join(dirpath, 'inception.npz'),
                 vgg16=os.path.join(dirpath, 'vgg16.npz'))
    inception_net.save_params(inception_net.init_random(seed),
                              paths['inception'])
    vgg16_net.save_params(vgg16_net.init_random(seed), paths['vgg16'])
    return paths


def use_detectors(dirpath: str) -> None:
    """Make this process (and the ranks it starts) find the detectors of
    ``dirpath``."""
    os.environ['MGT_WEIGHTS_DIR'] = dirpath
    for env in ('MGT_INCEPTION_WEIGHTS', 'MGT_VGG16_WEIGHTS'):
        os.environ.pop(env, None)


def seeded_model(cfg, seed: int = 0):
    """``MontageEnsemble(cfg)`` with seeded weights and a small seeded shift
    in the STN's zero-initialised head, so that the head places the layers,
    on the CPU."""
    model = MontageEnsemble(cfg).init_weights(seed)
    with torch.no_grad():
        bias = model.stn.fc_loc[2].bias
        bias.copy_(torch.randn(bias.shape, generator=torch.Generator()
                               .manual_seed(seed + 2)) * 0.05)
    return model


class Generator(torch.nn.Module):
    """A monolithic generator in the reference ``Generator``'s layout:
    ``synthesis``, then ``mapping``."""

    def __init__(self, mapping: torch.nn.Module, synthesis: torch.nn.Module):
        super().__init__()
        self.synthesis, self.mapping = synthesis, mapping

    def forward(self, z, c=None, truncation_psi=1.0, noise_mode='const'):
        ws = self.mapping(z, c, truncation_psi=truncation_psi)
        return self.synthesis(ws, noise_mode=noise_mode)


def seeded_generator(kw: Dict[str, Any], seed: int = 0,
                     scale: float = 0.1) -> Generator:
    """The port's mapping and synthesis for a reference ``Generator``'s
    construction kwargs, with seeded weights and seeded values (``scale``)
    for the zero-initialised terms: biases, noise strengths and
    ``w_avg``; on the CPU."""
    from ..utils.pkl_import import generator_modules
    mapping, synthesis = generator_modules(kw)
    g = torch.Generator().manual_seed(seed)
    net = Generator(mapping, synthesis)
    with torch.no_grad():
        synthesis.reset_parameters(g)
        mapping.reset_parameters(g)
        for name, t in net.named_parameters():
            if name.endswith(('bias', 'noise_strength')):
                t.add_(torch.randn(t.shape, generator=g) * scale)
        mapping.w_avg.add_(torch.randn(mapping.w_avg.shape, generator=g)
                           * scale)
    return net.eval().requires_grad_(False)


class _Persistent:
    """Pickles as the reference's persistence decorator pickles a module:
    ``_reconstruct_persistent_obj(meta)`` with the module's state in
    ``meta['state']``."""

    def __init__(self, meta: dict, reconstruct):
        self.meta, self.reconstruct = meta, reconstruct

    def __reduce__(self):
        return self.reconstruct, (self.meta,)


def write_persistence_pkl(path: str, networks: Dict[str, Any],
                          init_kwargs: Optional[Dict[str, dict]] = None,
                          **extra) -> str:
    """An SG2-ADA snapshot pickle at ``path``: each ``networks[key]``
    module as a persistence-pickled object (a
    ``torch_utils.persistence._reconstruct_persistent_obj`` global whose
    meta carries ``_parameters``, ``_buffers``, ``_modules`` and the
    root's ``_init_kwargs`` from ``init_kwargs[key]``; the embedded source
    is empty), and ``extra`` as plain values.  No reference code is needed:
    the global's module is stood in while pickling."""
    def reconstruct(meta):
        raise RuntimeError('a persistence stand-in is not executed')
    reconstruct.__module__ = 'torch_utils.persistence'
    reconstruct.__name__ = reconstruct.__qualname__ = \
        '_reconstruct_persistent_obj'

    def wrap(module, kwargs=None):
        state = {'_parameters': OrderedDict(module._parameters),
                 '_buffers': OrderedDict(module._buffers),
                 '_modules': OrderedDict((k, wrap(m)) for k, m in
                                         module._modules.items()),
                 '_init_kwargs': dict(kwargs or {})}
        return _Persistent(dict(type='class', version=6, module_src='',
                                class_name=f'training.networks.'
                                f'{type(module).__name__}',
                                state=state), reconstruct)

    names = ('torch_utils', 'torch_utils.persistence')
    saved = {n: sys.modules.get(n) for n in names}
    stand_in = types.ModuleType('torch_utils.persistence')
    stand_in._reconstruct_persistent_obj = reconstruct
    sys.modules['torch_utils'] = types.ModuleType('torch_utils')
    sys.modules['torch_utils.persistence'] = stand_in
    try:
        data = {k: wrap(m, (init_kwargs or {}).get(k))
                for k, m in networks.items()}
        data.update(extra)
        with open(path, 'wb') as f:
            pickle.dump(data, f)
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
    return path
