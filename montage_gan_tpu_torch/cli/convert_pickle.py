"""Convert a reference SG2-ADA ``.pkl`` snapshot into a port snapshot.

Port of ``montage_gan_tpu/cli/convert_pickle.py``: the pickle is read by
the allowlist unpickler (``utils/pkl_import.py``; no embedded source runs)
and its generator written as the port's EMA snapshot (``.pt``,
``utils/checkpoint.save_checkpoint``) of a 1-layer ensemble, which
``generate``, ``style_mixing``, ``projector`` and ``calc_metrics`` take.

    python -m montage_gan_tpu_torch.cli.convert_pickle --source net.pkl \\
        --dest net.pt [--key G_ema]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

from ..models.ensemble import MontageConfig, MontageEnsemble
from ..utils.checkpoint import save_checkpoint
from ..utils.pkl_import import generator_from_pkl


def ensemble_from_pkl(path: str, key: str = 'G_ema'
                      ) -> Tuple[MontageConfig, MontageEnsemble]:
    """The pickle's generator as a 1-layer ensemble on the CPU: the config
    of ``montage_gan_tpu/cli/convert_pickle.py:34-46`` (no global mapping,
    no STN, no renderer), its mapping and synthesis loaded from the
    pickle."""
    mapping, synthesis, kw = generator_from_pkl(path, key)
    res = kw['img_resolution']
    syn_kw = dict(kw.get('synthesis_kwargs') or {})
    map_kw = dict(kw.get('mapping_kwargs') or {})
    cfg = MontageConfig(
        layer_names=('image',), layer_targets=((res, res),),
        base_resolution=res, img_channels=kw['img_channels'],
        conv_config_index=syn_kw.get('conv_config_index', 2),
        z_dim=kw['z_dim'], w_dim=kw['w_dim'], c_dim=kw.get('c_dim', 0) or 0,
        mapping_num_layers=map_kw.get('num_layers', 8),
        channel_base=syn_kw.get('channel_base', 32768),
        channel_max=syn_kw.get('channel_max', 512),
        num_fp16_res=syn_kw.get('num_fp16_res', 0),
        conv_clamp=syn_kw.get('conv_clamp'),
        use_global_mapping=False, train_global=False, renderer_type='none')
    model = MontageEnsemble(cfg)
    model.mapping.load_state_dict(mapping.state_dict())
    model.local_g[0].load_state_dict(synthesis.state_dict())
    return cfg, model.eval().requires_grad_(False)


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(description='Convert a reference .pkl into '
                                            'a port EMA snapshot (.pt).')
    p.add_argument('--source', required=True, metavar='PKL',
                   help='reference SG2-ADA .pkl snapshot')
    p.add_argument('--dest', required=True, metavar='PATH',
                   help='output snapshot (.pt)')
    p.add_argument('--key', default='G_ema',
                   help='which network to convert (G | G_ema)')
    args = p.parse_args(argv)
    cfg, model = ensemble_from_pkl(args.source, args.key)
    save_checkpoint(args.dest, cfg, model)
    print(f'wrote {args.dest} (res {cfg.base_resolution}, z_dim '
          f'{cfg.z_dim}, c_dim {cfg.c_dim})')
    return args.dest


if __name__ == '__main__':
    main()
