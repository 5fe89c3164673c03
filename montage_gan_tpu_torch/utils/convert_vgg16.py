"""Convert VGG16 (and an optional LPIPS linear head) weights to the
``.npz`` that both packages read.

Port of ``montage_gan_tpu/utils/convert_vgg16.py``.  The reference
downloads NVIDIA's ``vgg16.pt`` LPIPS detector at run time (reference:
metrics/perceptual_path_length.py:44-47, projector.py:61-63); offline,
obtain torchvision's ``vgg16`` checkpoint (and, for calibrated LPIPS, the
official LPIPS ``vgg.pth`` linear head) once and convert:

    python -m montage_gan_tpu_torch.utils.convert_vgg16 vgg16.pth out.npz [vgg_lin.pth]
    export MGT_VGG16_WEIGHTS=out.npz

A TorchScript ``vgg16.pt`` also works as the source.
"""

from __future__ import annotations

import sys

import numpy as np

from .convert_inception import load_torch_state_dict


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) not in (2, 3):
        print(__doc__)
        raise SystemExit(2)
    src, dst = argv[0], argv[1]
    from ..metrics import vgg16_net
    sd = load_torch_state_dict(src)
    lpips_sd = load_torch_state_dict(argv[2]) if len(argv) == 3 else None
    params = vgg16_net.convert_torch_state_dict(sd, lpips_sd)
    vgg16_net.save_params(params, dst)
    n = sum(int(np.prod(v.shape)) for v in params.values())
    print(f'wrote {dst}: {len(params)} arrays, {n / 1e6:.1f}M params')


if __name__ == '__main__':
    main()
