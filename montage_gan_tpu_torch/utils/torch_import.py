"""Reference PyTorch checkpoints into the port's modules.

Port of ``montage_gan_tpu/utils/torch_import.py``.  The JAX package maps the
reference's state dicts onto flax layouts; the port's modules carry the
reference's names and layouts, so an import is a strict ``load_state_dict``:

  * stage-0 renderer ``.pth.tar`` files (the ``renderer`` entry, or a bare
    state dict; reference format: diff_rendering/main_united.py:134-138),
  * AIO ``network-snapshot-*.pth`` dicts of state dicts (reference format:
    custom/training_loop_aio.py:808-835) into a ``MontageEnsemble``,
  * SG2-ADA mapping, synthesis, STN and discriminator state dicts.

Files are read by ``torch.load`` through the allowlist unpickler of
``utils/pkl_import.py``: tensors, containers and numbers load, any other
global becomes an inert placeholder, and nothing pickled is executed.
"""

from __future__ import annotations

import types
from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional

import torch

from .pkl_import import _SafeUnpickler

# what torch.load needs of a pickle module: its Unpickler and load
_SAFE_PICKLE = types.ModuleType('montage_gan_tpu_torch_safe_pickle')
_SAFE_PICKLE.Unpickler = _SafeUnpickler
_SAFE_PICKLE.load = lambda f, **kw: _SafeUnpickler(f, **kw).load()


def load_torch_file(path: str) -> Any:
    """A ``torch.save`` file, read on the CPU through the allowlist
    unpickler."""
    return torch.load(path, map_location='cpu', weights_only=False,
                      pickle_module=_SAFE_PICKLE)


def load_module(module: torch.nn.Module, state_dict: Mapping[str, Any],
                name: str = 'state dict') -> torch.nn.Module:
    """``module`` with ``state_dict`` loaded strictly (float32 tensors);
    a missing, unexpected or misshapen entry raises naming ``name``."""
    try:
        module.load_state_dict(OrderedDict(
            (k, torch.as_tensor(v, dtype=torch.float32))
            for k, v in state_dict.items()))
    except RuntimeError as e:
        raise KeyError(f'{name}: {e}') from None
    return module


# ---------------------------------------------------------------------------
# Renderers
# ---------------------------------------------------------------------------

def renderer_state(data: Any) -> 'OrderedDict':
    """The renderer's state dict of a loaded renderer checkpoint: its
    ``renderer`` entry, or the file itself where it is a bare state dict."""
    sd = data['renderer'] if isinstance(data, dict) and 'renderer' in data \
        else data
    if not isinstance(sd, Mapping) or not all(
            isinstance(v, torch.Tensor) for v in sd.values()):
        raise ValueError('not a renderer checkpoint: expected a state dict '
                         'or a dict with a "renderer" state dict')
    return OrderedDict(sd)


def renderer_geometry(state_dict: Mapping[str, Any],
                      renderer_type: str) -> Dict[str, int]:
    """``build_renderer`` keyword arguments read from a renderer's weights:
    the tanh and sigmoid renderers' first conv reads ``img_layers ·
    img_channels`` channels and the last writes ``img_channels``; the
    sub-pixel one takes 9 RGBA layers."""
    if renderer_type == 'subpixel':
        return dict(img_channels=4, img_layers=9)
    if renderer_type not in ('tanh', 'sigmoid'):
        raise ValueError(f'unknown renderer type {renderer_type!r}')
    channels = int(state_dict['cnn.5.weight'].shape[0])
    stacked = int(state_dict['cnn.0.weight'].shape[1])
    return dict(img_channels=channels, img_layers=stacked // channels)


def load_reference_renderer(path: str, renderer_type: str = 'tanh',
                            img_resolution: int = 256) -> torch.nn.Module:
    """A reference renderer checkpoint (``.pth``/``.pth.tar``, the
    ``renderer`` entry or a bare state dict) as the port's renderer of
    ``renderer_type``, on the CPU; its geometry comes from the weights."""
    from ..models.renderer import build_renderer
    sd = renderer_state(load_torch_file(path))
    renderer = build_renderer(renderer_type, img_resolution=img_resolution,
                              **renderer_geometry(sd, renderer_type))
    return load_module(renderer, sd, path)


# ---------------------------------------------------------------------------
# The mapping
# ---------------------------------------------------------------------------

def _last_fc(state_dict: Mapping[str, Any]) -> str:
    fcs = sorted({k.split('.')[0] for k in state_dict if k.startswith('fc')},
                 key=lambda s: int(s[2:]))
    return fcs[-1]


def widen_mapping_to_global(state_dict: Mapping[str, Any],
                            num_layers: int) -> 'OrderedDict':
    """A MappingNetwork state dict → a GlobalMappingNetwork one, the final
    layer's output parameters repeated per image layer (reference rule:
    custom/training_loop_aio.py:321-334): the last fc's weight
    ``[w, in]`` tiles to ``[w·num_layers, in]``, its bias and ``w_avg``
    along their one axis."""
    last = _last_fc(state_dict)
    out: 'OrderedDict' = OrderedDict()
    for k, v in state_dict.items():
        v = torch.as_tensor(v).clone()
        if k == f'{last}.weight':
            v = v.repeat(num_layers, 1)
        elif k in (f'{last}.bias', 'w_avg'):
            v = v.repeat(num_layers)
        out[k] = v
    return out


def slice_global_mapping(state_dict: Mapping[str, Any], num_splits: int,
                         idx: int) -> 'OrderedDict':
    """A GlobalMappingNetwork state dict → the plain MappingNetwork one of
    split ``idx``: the last fc's rows, bias segment and ``w_avg`` segment
    ``[idx·w_dim, (idx + 1)·w_dim)`` (the inverse of
    ``widen_mapping_to_global``; ``montage_gan_tpu/cli/export_torch.py:
    34-57``)."""
    last = _last_fc(state_dict)
    out: 'OrderedDict' = OrderedDict()
    for k, v in state_dict.items():
        v = torch.as_tensor(v)
        if k in (f'{last}.weight', f'{last}.bias', 'w_avg'):
            w_dim = v.shape[0] // num_splits
            v = v[idx * w_dim:(idx + 1) * w_dim]
        out[k] = v.clone()
    return out


# ---------------------------------------------------------------------------
# Whole checkpoints
# ---------------------------------------------------------------------------

def _prefixed(prefix: str, state_dict: Mapping[str, Any]):
    return ((f'{prefix}{k}', v) for k, v in state_dict.items())


def ensemble_state_from_aio(data: Mapping[str, Any], cfg, ema: bool = True,
                            with_d: bool = False) -> 'OrderedDict':
    """A reference AIO ``network-snapshot-*.pth`` (a dict of state dicts) →
    the state dict of ``MontageEnsemble(cfg, with_d)``: the EMA's mapping,
    local Gs and STN (``ema``; else the live ones), the renderer where the
    config has one, and with ``with_d`` the local and global Ds.  A plain
    (non-global) mapping is widened where the config wants a global one."""
    suffix = '_ema' if ema else ''
    out: 'OrderedDict' = OrderedDict()
    mapping = data[f'mapping_network{suffix}']
    if cfg.use_global_mapping and mapping[f'{_last_fc(mapping)}.bias'].shape[0] \
            == cfg.w_dim and cfg.num_layers > 1:
        mapping = widen_mapping_to_global(mapping, cfg.num_layers)
    out.update(_prefixed('mapping.', mapping))
    local_g = data['local_G_ema' if ema else 'local_G_list']
    if len(local_g) != cfg.num_layers:
        raise KeyError(f'{len(local_g)} local Gs, the config has '
                       f'{cfg.num_layers} layers')
    for i, sd in enumerate(local_g):
        out.update(_prefixed(f'local_g.{i}.', sd))
    if with_d:
        for i, sd in enumerate(data['local_D_list']):
            out.update(_prefixed(f'local_d.{i}.', sd))
    if cfg.train_global:
        stn = data.get(f'pos_estimator{suffix}', data.get('pos_estimator'))
        out.update(_prefixed('stn.', stn))
        if with_d:
            out.update(_prefixed('global_d.', data['global_D']))
    if cfg.renderer_type != 'none' and 'renderer' in data:
        out.update(_prefixed('renderer.', data['renderer']))
    return out


def load_aio_snapshot(path: str, cfg, ema: bool = True,
                      with_d: bool = False,
                      data: Optional[Mapping[str, Any]] = None):
    """A reference AIO ``.pth`` as a ``MontageEnsemble(cfg, with_d)`` on
    the CPU, loaded strictly (``ensemble_state_from_aio``); without a
    ``renderer`` entry the ensemble has none."""
    from ..models.ensemble import MontageEnsemble
    data = load_torch_file(path) if data is None else data
    model = MontageEnsemble(cfg, with_d=with_d)
    if 'renderer' not in data:
        model.renderer = None
    return load_module(model, ensemble_state_from_aio(data, cfg, ema, with_d),
                       path)
