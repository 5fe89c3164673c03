"""The port's modules as reference-consumable checkpoints.

Port of ``montage_gan_tpu/utils/torch_export.py``, the inverse of
``utils/torch_import.py``:

  * ``export_aio_snapshot`` — the AIO ``network-snapshot-*.pth`` dict of
    state dicts the reference trainer saves and resumes from (format and
    keys: custom/training_loop_aio.py:808-835; it loads each entry with a
    strict ``load_state_dict``, :314-342, so every buffer is written:
    resample_filter, noise_const, Hz_geom/Hz_fbank);
  * ``generator_state_dict`` — a monolithic SG2 ``Generator`` state dict
    (``synthesis.`` then ``mapping.``);
  * ``export_network_pkl`` — an SG2-ADA-style ``.pkl`` of persistence-
    pickled reference modules carrying the port's weights; it needs a
    reference checkout on ``sys.path`` (``custom.networks_aio``).

The port's modules carry the reference's names, layouts and module order,
so each state dict is the module's own, as float32 tensors on the CPU, in
the order of the reference's ``state_dict()`` traversal (a module's
parameters, then its buffers, then its children: ``w_avg`` before the fcs,
``const`` and ``resample_filter`` before a block's layers).  A renderer's
shared mid block appears under each of its names, as ``state_dict()``
writes a shared module.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np
import torch


def module_state_dict(module: torch.nn.Module,
                      prefix: str = '') -> 'OrderedDict':
    """``module.state_dict()`` as float32 CPU copies, keys under
    ``prefix``."""
    return OrderedDict((f'{prefix}{k}', v.detach().to('cpu', torch.float32)
                        .clone())
                       for k, v in module.state_dict().items())


mapping_state_dict = module_state_dict
synthesis_state_dict = module_state_dict
discriminator_state_dict = module_state_dict
stn_state_dict = module_state_dict
renderer_state_dict = module_state_dict


def augment_pipe_state_dict(p: float) -> 'OrderedDict':
    """The reference ``AugmentPipe``'s buffers: ``p`` and the sym6/sym2
    filters ``Hz_geom``, ``Hz_fbank``."""
    from ..training.augment import _HZ_FBANK, _HZ_GEOM
    out: 'OrderedDict' = OrderedDict()
    out['p'] = torch.tensor(float(p), dtype=torch.float32)
    out['Hz_geom'] = torch.as_tensor(np.asarray(_HZ_GEOM, np.float32)).clone()
    out['Hz_fbank'] = torch.as_tensor(np.asarray(_HZ_FBANK,
                                                 np.float32)).clone()
    return out


def export_aio_snapshot(state, path: str,
                        training_set_kwargs: Optional[dict] = None,
                        include_renderer: bool = True) -> dict:
    """Write a reference-format AIO ``network-snapshot-*.pth`` from a
    ``training.train_step.MontageTrainState`` (its live ensemble with the
    Ds, its EMA and ``aug_p``); returns the dict saved."""
    model, ema = state.model, state.ema
    cfg = model.cfg
    aug_p = state.aug_p.detach().cpu().numpy()
    data: Dict[str, Any] = dict(
        training_set_kwargs=dict(training_set_kwargs or {}))
    data['mapping_network'] = mapping_state_dict(model.mapping)
    data['local_G_list'] = [synthesis_state_dict(g) for g in model.local_g]
    data['local_D_list'] = [discriminator_state_dict(d)
                            for d in model.local_d]
    if model.renderer is not None and include_renderer:
        data['renderer'] = renderer_state_dict(model.renderer)
    data['mapping_network_ema'] = mapping_state_dict(ema.mapping)
    data['local_G_ema'] = [synthesis_state_dict(g) for g in ema.local_g]
    data['augment_pipe_list'] = [augment_pipe_state_dict(float(aug_p[i]))
                                 for i in range(cfg.num_layers)]
    if model.stn is not None:
        data['pos_estimator'] = stn_state_dict(model.stn)
        if ema.stn is not None:
            data['pos_estimator_ema'] = stn_state_dict(ema.stn)
        data['global_augment_pipe'] = augment_pipe_state_dict(
            float(aug_p[cfg.num_layers]))
        if model.global_d is not None:
            data['global_D'] = discriminator_state_dict(model.global_d)
    torch.save(data, path)
    return data


def generator_state_dict(mapping: torch.nn.Module,
                         synthesis: torch.nn.Module) -> 'OrderedDict':
    """Monolithic SG2 Generator state dict (``synthesis.`` then
    ``mapping.``, reference training/networks.py Generator)."""
    out = synthesis_state_dict(synthesis, 'synthesis.')
    out.update(mapping_state_dict(mapping, 'mapping.'))
    return out


def export_network_pkl(path: str, *, g_kwargs: dict,
                       mapping: torch.nn.Module, synthesis: torch.nn.Module,
                       d_kwargs: Optional[dict] = None,
                       discriminator: Optional[torch.nn.Module] = None,
                       ema_mapping: Optional[torch.nn.Module] = None,
                       ema_synthesis: Optional[torch.nn.Module] = None,
                       training_set_kwargs: Optional[dict] = None) -> None:
    """Write an SG2-ADA-style pickle {'G', 'D', 'G_ema', ...} of reference
    modules carrying the port's weights (legacy.py:21-61,
    generate.py:86-87).  Needs the reference repository importable
    (``custom.networks_aio``); the written pickle is self-contained
    afterwards (the persistence decorator embeds the class source).

    ``g_kwargs``: the reference Generator's constructor arguments;
    ``d_kwargs`` likewise for its Discriminator (when None, one of the
    generator's geometry with its own random weights: ``generate.py``
    reads only G_ema)."""
    import pickle
    try:
        from custom.networks_aio import Discriminator as RefD
        from custom.networks_aio import Generator as RefG
    except ImportError as e:
        raise ImportError(
            'export_network_pkl needs the reference repo on sys.path '
            '(a montage_gan checkout) to construct the persistence-pickled '
            'modules') from e

    def build_g(m, s):
        g = RefG(**g_kwargs)
        g.load_state_dict(generator_state_dict(m, s))
        return g.eval().requires_grad_(False)

    g = build_g(mapping, synthesis)
    g_ema = build_g(ema_mapping if ema_mapping is not None else mapping,
                    ema_synthesis if ema_synthesis is not None else synthesis)
    if d_kwargs is None:
        sk = dict(g_kwargs.get('synthesis_kwargs', {}))
        sk.pop('num_fp16_res', None)
        sk.pop('conv_clamp', None)
        d_kwargs = dict(c_dim=g_kwargs.get('c_dim', 0),
                        img_resolution=g_kwargs['img_resolution'],
                        img_channels=g_kwargs['img_channels'],
                        init_res=g_kwargs.get('init_res', [4, 4]), **sk)
    d = RefD(**d_kwargs)
    if discriminator is not None:
        d.load_state_dict(discriminator_state_dict(discriminator))
    d = d.eval().requires_grad_(False)
    data = dict(G=g, D=d, G_ema=g_ema,
                training_set_kwargs=training_set_kwargs, augment_pipe=None)
    with open(path, 'wb') as f:
        pickle.dump(data, f)
