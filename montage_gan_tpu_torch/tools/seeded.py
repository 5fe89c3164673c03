"""Seeded stand-ins that the card's checks share (``chip_smoke.py``,
``tools/ddp_check.py``): a config's ensemble with seeded weights, and
random-weight detector files in a drop-in directory."""

from __future__ import annotations

import os

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
