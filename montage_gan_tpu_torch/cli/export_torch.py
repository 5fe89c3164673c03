"""export-torch — write reference-consumable checkpoints from a snapshot.

Port of ``montage_gan_tpu/cli/export_torch.py``, the inverse of
``convert-pickle``.  ``--network`` is a port snapshot (``.pt``) or a JAX EMA
snapshot (``.msgpack`` with its ``.json``), as ``utils/checkpoint.
load_network`` reads them; it is written as

  * ``--format pth``: a reference AIO ``network-snapshot-*.pth`` dict of
    state dicts (custom/training_loop_aio.py:808-835), the EMA weights
    under both the live and the ``*_ema`` keys (the reference's resume
    loader applies each entry it finds, :314-342, 360-367);
  * ``--format pkl [--layer NAME]``: an SG2-ADA persistence pickle of one
    monolithic reference Generator (legacy.py:21-61); for a montage
    snapshot ``--layer`` picks the local synthesis net and slices its lane
    out of the global mapping (``utils/torch_import.slice_global_mapping``).
    It needs a reference checkout (``--reference-path``).

    python -m montage_gan_tpu_torch.cli.export_torch --network snap.pt \\
        --dest snap.pth [--format pth|pkl] [--layer NAME]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from ..utils import torch_export
from ..utils.checkpoint import load_network


def aio_payload(cfg, model) -> dict:
    """The ``--format pth`` dict of an EMA ensemble
    (``montage_gan_tpu/cli/export_torch.py:79-100``)."""
    data = {'training_set_kwargs': {}}
    data['mapping_network'] = torch_export.mapping_state_dict(model.mapping)
    data['mapping_network_ema'] = torch_export.mapping_state_dict(
        model.mapping)
    data['local_G_list'] = [torch_export.synthesis_state_dict(g)
                            for g in model.local_g]
    data['local_G_ema'] = [torch_export.synthesis_state_dict(g)
                           for g in model.local_g]
    if model.renderer is not None:
        data['renderer'] = torch_export.renderer_state_dict(model.renderer)
    if model.stn is not None:
        sd = torch_export.stn_state_dict(model.stn)
        data['pos_estimator'] = sd
        data['pos_estimator_ema'] = sd
    return data


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(description='Export a snapshot as a '
                                            'reference-consumable checkpoint.')
    p.add_argument('--network', required=True, metavar='PATH',
                   help='port snapshot (.pt) or JAX EMA snapshot (.msgpack)')
    p.add_argument('--dest', required=True, metavar='PATH',
                   help='output .pth / .pkl file')
    p.add_argument('--format', dest='fmt', choices=['pth', 'pkl'],
                   default='pth')
    p.add_argument('--layer', default=None, metavar='NAME',
                   help='pkl only: the layer of a montage snapshot to export '
                        '(defaults to the sole layer of a 1-layer snapshot)')
    p.add_argument('--reference-path', default=None, metavar='DIR',
                   help='pkl only: a reference montage_gan checkout to import '
                        'the persistence modules from')
    args = p.parse_args(argv)
    cfg, model = load_network(args.network, device='cpu')

    if args.fmt == 'pth':
        import torch
        data = aio_payload(cfg, model)
        torch.save(data, args.dest)
        print(f'wrote AIO snapshot {args.dest} ({len(data)} entries, '
              f'{cfg.num_layers} layers, {os.path.getsize(args.dest)} bytes)')
        return args.dest

    if args.reference_path:
        sys.path.insert(0, args.reference_path)
    names = list(cfg.layer_names)
    if args.layer is None:
        if cfg.num_layers != 1:
            p.error(f'--layer required for montage snapshots (choices: '
                    f'{names})')
        idx = 0
    elif args.layer in names:
        idx = names.index(args.layer)
    else:
        p.error(f'unknown layer {args.layer!r} (choices: {names})')
    from ..models.mapping import MappingNetwork
    from ..utils.torch_import import slice_global_mapping
    init_res, res = cfg.layer_geometry(idx)
    mapping = MappingNetwork(z_dim=cfg.z_dim, c_dim=cfg.c_dim, w_dim=cfg.w_dim,
                             num_ws=model.local_g[idx].num_ws,
                             num_layers=cfg.mapping_num_layers)
    mapping_sd = model.mapping.state_dict()
    if cfg.num_layers > 1 or getattr(model.mapping, 'num_splits', 1) > 1:
        mapping_sd = slice_global_mapping(mapping_sd, cfg.num_layers, idx)
    mapping.load_state_dict(mapping_sd)
    g_kwargs = dict(
        z_dim=cfg.z_dim, c_dim=cfg.c_dim, w_dim=cfg.w_dim,
        img_resolution=res, img_channels=cfg.img_channels,
        init_res=list(init_res),
        mapping_kwargs=dict(num_layers=cfg.mapping_num_layers),
        synthesis_kwargs=dict(conv_config_index=cfg.conv_config_index,
                              channel_base=cfg.channel_base,
                              channel_max=cfg.channel_max,
                              num_fp16_res=cfg.num_fp16_res,
                              conv_clamp=cfg.conv_clamp))
    torch_export.export_network_pkl(args.dest, g_kwargs=g_kwargs,
                                    mapping=mapping,
                                    synthesis=model.local_g[idx])
    print(f'wrote SG2 pickle {args.dest} (layer {names[idx]!r}, res {res}, '
          f'init_res {tuple(init_res)})')
    return args.dest


if __name__ == '__main__':
    main()
