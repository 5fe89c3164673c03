"""The weight bridge: the JAX package's variables → the port's state dict.

The JAX package stores NHWC/HWIO weights in flax variable trees; the port's
modules carry the reference checkpoint's names and PyTorch layouts (the
same conversion ``montage_gan_tpu/utils/torch_export.py`` makes):

  * conv kernel   ``[kh, kw, I, O]`` → ``[O, I, kh, kw]``
  * linear weight ``[I, O]``         → ``[O, I]``
  * synthesis const ``[H, W, C]``    → ``[C, H, W]``
  * the STN's first FC: the HWC-major flatten of its input → C-major
  * every resample_filter buffer is ``setup_filter([1, 3, 3, 1])``.

``state_dict_from_jax`` takes the variables as nested dicts of numpy arrays
(``mapping``, ``local_g[i]`` with ``params`` and ``noise``, ``stn`` and
``renderer``, as a JAX EMA snapshot holds them, and ``local_d[i]`` and
``global_d`` as a train state holds them), and returns the state dict of
``models.ensemble.MontageEnsemble``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch

from ..ops.filters import setup_filter


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32, copy=True))


def _conv_w(v) -> torch.Tensor:
    return _t(np.asarray(v).transpose(3, 2, 0, 1))


def _linear_w(v) -> torch.Tensor:
    return _t(np.asarray(v).transpose(1, 0))


def _fc_names(params) -> list:
    return sorted((k for k in params if k.startswith('fc')),
                  key=lambda s: int(s[2:]))


def _as_list(tree) -> list:
    """A flax tuple restored from msgpack is a dict keyed '0', '1', …"""
    if isinstance(tree, dict):
        return [tree[str(i)] for i in range(len(tree))]
    return list(tree)


def mapping_state_dict(variables: Dict[str, Any]) -> 'OrderedDict':
    params = variables['params']
    if 'embed' in params:
        raise NotImplementedError('conditional mapping is not ported yet')
    out: 'OrderedDict' = OrderedDict()
    w_avg = variables.get('moving_stats', {}).get('w_avg')
    if w_avg is None:  # a fresh network's w_avg is zeros
        w_avg = np.zeros_like(np.asarray(params[_fc_names(params)[-1]]['bias']))
    out['w_avg'] = _t(w_avg)
    for k in _fc_names(params):
        out[f'{k}.weight'] = _linear_w(params[k]['weight'])
        out[f'{k}.bias'] = _t(params[k]['bias'])
    return out


def synthesis_state_dict(variables: Dict[str, Any]) -> 'OrderedDict':
    params = variables['params']
    noise = variables.get('noise', {})
    rf = setup_filter([1, 3, 3, 1])
    out: 'OrderedDict' = OrderedDict()

    def put_layer(block: str, layer: str):
        p = params[block][layer]
        key = f'{block}.{layer}'
        out[f'{key}.weight'] = _conv_w(p['weight'])
        if 'noise_strength' in p:  # SynthesisLayer (conv0/conv1)
            out[f'{key}.noise_strength'] = _t(p['noise_strength'])
            out[f'{key}.bias'] = _t(p['bias'])
            out[f'{key}.resample_filter'] = rf.clone()
            out[f'{key}.noise_const'] = _t(noise[block][layer]['noise_const'])
        else:  # ToRGBLayer
            out[f'{key}.bias'] = _t(p['bias'])
        out[f'{key}.affine.weight'] = _linear_w(p['affine']['weight'])
        out[f'{key}.affine.bias'] = _t(p['affine']['bias'])

    for i, block in enumerate(sorted(params, key=lambda b: int(b[1:]))):
        if i == 0:
            out[f'{block}.const'] = _t(
                np.asarray(params[block]['const']).transpose(2, 0, 1))
        out[f'{block}.resample_filter'] = rf.clone()
        if 'conv0' in params[block]:
            put_layer(block, 'conv0')
        put_layer(block, 'conv1')
        put_layer(block, 'torgb')
    return out


def stn_state_dict(variables: Dict[str, Any]) -> 'OrderedDict':
    params = variables['params']
    out: 'OrderedDict' = OrderedDict()
    convs = sorted((k for k in params if k.startswith('Conv_')),
                   key=lambda s: int(s.split('_')[1]))
    for i, k in enumerate(convs):
        # localization = [conv, maxpool, relu] × stages
        out[f'localization.{3 * i}.weight'] = _conv_w(params[k]['kernel'])
        out[f'localization.{3 * i}.bias'] = _t(params[k]['bias'])
    c_last = np.asarray(params[convs[-1]]['kernel']).shape[-1]
    w0 = np.asarray(params['Dense_0']['kernel'])  # [H*W*C, nf2], HWC-major
    side = int(round((w0.shape[0] // c_last) ** 0.5))
    assert side * side * c_last == w0.shape[0]
    w0 = w0.transpose(1, 0).reshape(-1, side, side, c_last)
    out['fc_loc.0.weight'] = _t(w0.transpose(0, 3, 1, 2).reshape(w0.shape[0], -1))
    out['fc_loc.0.bias'] = _t(params['Dense_0']['bias'])
    out['fc_loc.2.weight'] = _linear_w(params['Dense_1']['kernel'])
    out['fc_loc.2.bias'] = _t(params['Dense_1']['bias'])
    return out


def discriminator_state_dict(variables: Dict[str, Any],
                             init_res=(4, 4)) -> 'OrderedDict':
    """A JAX ``Discriminator``'s variables → the state dict of the port's
    ``models.discriminator.Discriminator``: blocks top-down, then the
    epilogue ``b4``, whose fc input turns from the HWC-major flatten to the
    C-major one."""
    params = variables['params']
    if 'mapping' in params:
        raise NotImplementedError('the conditional D is not ported yet')
    h0, w0 = init_res
    rf = setup_filter([1, 3, 3, 1])
    out: 'OrderedDict' = OrderedDict()

    def put_conv(key: str, p, bias: bool = True):
        out[f'{key}.weight'] = _conv_w(p['weight'])
        if bias:
            out[f'{key}.bias'] = _t(p['bias'])
        out[f'{key}.resample_filter'] = rf.clone()

    blocks = sorted((b for b in params if b != 'b4'), key=lambda b: -int(b[1:]))
    for block in blocks:
        p = params[block]
        out[f'{block}.resample_filter'] = rf.clone()
        if 'fromrgb' in p:
            put_conv(f'{block}.fromrgb', p['fromrgb'])
        put_conv(f'{block}.conv0', p['conv0'])
        put_conv(f'{block}.conv1', p['conv1'])
        put_conv(f'{block}.skip', p['skip'], bias=False)
    p = params['b4']
    put_conv('b4.conv', p['conv'])
    w = np.asarray(p['fc']['weight'])            # [h0*w0*cin, out], HWC-major
    cin = w.shape[0] // (h0 * w0)
    w = w.reshape(h0, w0, cin, -1).transpose(2, 0, 1, 3)
    out['b4.fc.weight'] = _t(w.reshape(cin * h0 * w0, -1).transpose(1, 0))
    out['b4.fc.bias'] = _t(p['fc']['bias'])
    out['b4.out.weight'] = _linear_w(p['out']['weight'])
    out['b4.out.bias'] = _t(p['out']['bias'])
    return out


def renderer_state_dict(variables: Dict[str, Any],
                        renderer_type: str = 'tanh') -> 'OrderedDict':
    """A JAX renderer's variables → the state dict of the port's renderer,
    whose shared mid block appears under each of its names."""
    params = variables['params']
    if renderer_type in ('tanh', 'sigmoid'):
        names = {'block': ['block.0', 'cnn.2.0', 'cnn.3.0', 'cnn.4.0'],
                 'conv_in': ['cnn.0'], 'conv_out': ['cnn.5']}
    elif renderer_type == 'subpixel':
        names = {'block': ['block.0', 'cnn.5.0', 'cnn.6.0'],
                 'conv_down1': ['cnn.1'], 'conv_down2': ['cnn.3'],
                 'conv_out': ['cnn.7']}
    else:
        raise ValueError(f'unknown renderer type {renderer_type!r}')
    flat = {}
    for ours, aliases in names.items():
        for name in aliases:
            flat[name] = (_conv_w(params[ours]['kernel']),
                          _t(params[ours]['bias']))
    out: 'OrderedDict' = OrderedDict()
    # the module order: block.0, then cnn.* by position
    for name in sorted(flat, key=lambda n: (n != 'block.0', n)):
        out[f'{name}.weight'], out[f'{name}.bias'] = flat[name]
    return out


def state_dict_from_jax(cfg, tree: Dict[str, Any]) -> 'OrderedDict':
    """JAX variables (``mapping``, ``local_g``, and where present
    ``local_d``, ``stn``, ``global_d``, ``renderer``) → the state dict of
    ``MontageEnsemble(cfg, with_d='local_d' in tree)``, without the
    renderer where the tree has none (a JAX EMA snapshot may leave it
    out)."""
    out: 'OrderedDict' = OrderedDict()
    for k, v in mapping_state_dict(tree['mapping']).items():
        out[f'mapping.{k}'] = v
    local_g = _as_list(tree['local_g'])
    assert len(local_g) == cfg.num_layers
    for i, g in enumerate(local_g):
        for k, v in synthesis_state_dict(g).items():
            out[f'local_g.{i}.{k}'] = v
    if 'local_d' in tree:
        local_d = _as_list(tree['local_d'])
        assert len(local_d) == cfg.num_layers
        for i, d in enumerate(local_d):
            init_res = cfg.layer_geometry(i)[0]
            for k, v in discriminator_state_dict(d, init_res).items():
                out[f'local_d.{i}.{k}'] = v
    if cfg.train_global:
        for k, v in stn_state_dict(tree['stn']).items():
            out[f'stn.{k}'] = v
        if 'global_d' in tree:
            for k, v in discriminator_state_dict(
                    tree['global_d'], cfg.base_init_res).items():
                out[f'global_d.{k}'] = v
    if cfg.renderer_type != 'none' and 'renderer' in tree:
        for k, v in renderer_state_dict(tree['renderer'],
                                        cfg.renderer_type).items():
            out[f'renderer.{k}'] = v
    return out
