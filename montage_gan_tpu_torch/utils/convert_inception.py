"""Convert FID InceptionV3 weights (a torch state dict) to the ``.npz``
that both packages read.

Port of ``montage_gan_tpu/utils/convert_inception.py``.  The reference
downloads NVIDIA's Inception-2015-12-05 detector at run time (reference:
metrics/metric_utils.py:46-57); offline, obtain the same weights once
(pytorch-fid's ``pt_inception-2015-12-05-6726825d.pth`` or a torchvision
``inception_v3`` checkpoint, both in the torchvision layout) and convert:

    python -m montage_gan_tpu_torch.utils.convert_inception in.pth out.npz
    export MGT_INCEPTION_WEIGHTS=out.npz

The batchnorm is folded into the conv weights (inference only); see
``metrics/inception_net.py`` for the architecture.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def load_torch_state_dict(path: str) -> dict:
    """A ``.pth``/``.pt`` file (a state dict, a module, or a TorchScript
    archive such as NVIDIA's detectors) as ``{name: np.ndarray}``, read on
    the CPU."""
    try:
        obj = torch.load(path, map_location='cpu', weights_only=False)
    except RuntimeError:
        obj = torch.jit.load(path, map_location='cpu')
    if hasattr(obj, 'state_dict'):
        obj = obj.state_dict()
    if isinstance(obj, dict) and 'state_dict' in obj:
        obj = obj['state_dict']
    return {k: v.detach().numpy() if hasattr(v, 'detach') else np.asarray(v)
            for k, v in obj.items()}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        raise SystemExit(2)
    src, dst = argv
    from ..metrics import inception_net
    params = inception_net.convert_torch_state_dict(load_torch_state_dict(src))
    inception_net.save_params(params, dst)
    n = sum(int(np.prod(v.shape)) for v in params.values())
    print(f'wrote {dst}: {len(params)} arrays, {n / 1e6:.1f}M params')


if __name__ == '__main__':
    main()
