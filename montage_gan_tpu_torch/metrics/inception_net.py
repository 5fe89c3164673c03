"""InceptionV3 (the FID variant, pool3, 2048-d) as a PyTorch feature network.

Port of ``montage_gan_tpu/metrics/inception_net.py:116-311``, the
architecture of the Inception-2015-12-05 detector that the reference's FID
downloads (reference: metrics/frechet_inception_distance.py:23):

  * BasicConv2d = conv (no bias) + batchnorm (eps 1e-3) + ReLU, the
    batchnorm folded into the conv's weight and bias when the weights are
    converted (inference only);
  * the average pools inside the blocks divide by the valid window count
    (``count_include_pad=False``);
  * Mixed_7c's pool branch is a 3×3 max pool at stride 1, padding 1;
  * the input is resized to 299×299 as ``jax.image.resize(...,
    'bilinear')`` does (half-pixel centres; a triangle filter widened by
    the scale where an axis shrinks) and mapped from [0, 255] to [-1, 1].

Weights are the JAX package's ``.npz`` layout (``load_params``,
``save_params``): ``<conv name>`` an HWIO weight with the batchnorm folded
in and ``<conv name>/b`` its bias, written by ``utils/convert_inception.py``
from a torchvision-layout state dict, so one file serves both packages.
The convolutions run in float32 with TF32 off (the JAX package's
``Precision.HIGHEST``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3

# Conv spec: name -> ((kh, kw), (sh, sw), (ph, pw)).  Names follow the
# torchvision ``inception_v3`` state_dict so conversion is mechanical.
_C = lambda k, s=(1, 1), p=(0, 0): (k, s, p)

STEM: List[Tuple[str, tuple]] = [
    ('Conv2d_1a_3x3', _C((3, 3), (2, 2))),
    ('Conv2d_2a_3x3', _C((3, 3))),
    ('Conv2d_2b_3x3', _C((3, 3), p=(1, 1))),
    ('maxpool', None),
    ('Conv2d_3b_1x1', _C((1, 1))),
    ('Conv2d_4a_3x3', _C((3, 3))),
    ('maxpool', None),
]

_A_SPEC = {
    'branch1x1': _C((1, 1)),
    'branch5x5_1': _C((1, 1)),
    'branch5x5_2': _C((5, 5), p=(2, 2)),
    'branch3x3dbl_1': _C((1, 1)),
    'branch3x3dbl_2': _C((3, 3), p=(1, 1)),
    'branch3x3dbl_3': _C((3, 3), p=(1, 1)),
    'branch_pool': _C((1, 1)),
}
_B_SPEC = {
    'branch3x3': _C((3, 3), (2, 2)),
    'branch3x3dbl_1': _C((1, 1)),
    'branch3x3dbl_2': _C((3, 3), p=(1, 1)),
    'branch3x3dbl_3': _C((3, 3), (2, 2)),
}
_C_SPEC = {
    'branch1x1': _C((1, 1)),
    'branch7x7_1': _C((1, 1)),
    'branch7x7_2': _C((1, 7), p=(0, 3)),
    'branch7x7_3': _C((7, 1), p=(3, 0)),
    'branch7x7dbl_1': _C((1, 1)),
    'branch7x7dbl_2': _C((7, 1), p=(3, 0)),
    'branch7x7dbl_3': _C((1, 7), p=(0, 3)),
    'branch7x7dbl_4': _C((7, 1), p=(3, 0)),
    'branch7x7dbl_5': _C((1, 7), p=(0, 3)),
    'branch_pool': _C((1, 1)),
}
_D_SPEC = {
    'branch3x3_1': _C((1, 1)),
    'branch3x3_2': _C((3, 3), (2, 2)),
    'branch7x7x3_1': _C((1, 1)),
    'branch7x7x3_2': _C((1, 7), p=(0, 3)),
    'branch7x7x3_3': _C((7, 1), p=(3, 0)),
    'branch7x7x3_4': _C((3, 3), (2, 2)),
}
_E_SPEC = {
    'branch1x1': _C((1, 1)),
    'branch3x3_1': _C((1, 1)),
    'branch3x3_2a': _C((1, 3), p=(0, 1)),
    'branch3x3_2b': _C((3, 1), p=(1, 0)),
    'branch3x3dbl_1': _C((1, 1)),
    'branch3x3dbl_2': _C((3, 3), p=(1, 1)),
    'branch3x3dbl_3a': _C((1, 3), p=(0, 1)),
    'branch3x3dbl_3b': _C((3, 1), p=(1, 0)),
    'branch_pool': _C((1, 1)),
}

# (block name, block kind).  Widths are implied by the weights.
BLOCKS: List[Tuple[str, str]] = [
    ('Mixed_5b', 'A'), ('Mixed_5c', 'A'), ('Mixed_5d', 'A'),
    ('Mixed_6a', 'B'),
    ('Mixed_6b', 'C'), ('Mixed_6c', 'C'), ('Mixed_6d', 'C'), ('Mixed_6e', 'C'),
    ('Mixed_7a', 'D'),
    ('Mixed_7b', 'E'), ('Mixed_7c', 'E'),
]
_SPECS = {'A': _A_SPEC, 'B': _B_SPEC, 'C': _C_SPEC, 'D': _D_SPEC, 'E': _E_SPEC}

# Channel plan (torchvision inception_v3), used only for random init/tests.
_CHANNELS = {
    'Conv2d_1a_3x3': (3, 32), 'Conv2d_2a_3x3': (32, 32),
    'Conv2d_2b_3x3': (32, 64), 'Conv2d_3b_1x1': (64, 80),
    'Conv2d_4a_3x3': (80, 192),
}


def _block_channels(name: str, kind: str, cin: int) -> Dict[str, Tuple[int, int]]:
    """in/out channels per conv of one block (torchvision widths)."""
    if kind == 'A':
        pf = {'Mixed_5b': 32, 'Mixed_5c': 64, 'Mixed_5d': 64}[name]
        return {'branch1x1': (cin, 64), 'branch5x5_1': (cin, 48),
                'branch5x5_2': (48, 64), 'branch3x3dbl_1': (cin, 64),
                'branch3x3dbl_2': (64, 96), 'branch3x3dbl_3': (96, 96),
                'branch_pool': (cin, pf)}
    if kind == 'B':
        return {'branch3x3': (cin, 384), 'branch3x3dbl_1': (cin, 64),
                'branch3x3dbl_2': (64, 96), 'branch3x3dbl_3': (96, 96)}
    if kind == 'C':
        c7 = {'Mixed_6b': 128, 'Mixed_6c': 160, 'Mixed_6d': 160,
              'Mixed_6e': 192}[name]
        return {'branch1x1': (cin, 192), 'branch7x7_1': (cin, c7),
                'branch7x7_2': (c7, c7), 'branch7x7_3': (c7, 192),
                'branch7x7dbl_1': (cin, c7), 'branch7x7dbl_2': (c7, c7),
                'branch7x7dbl_3': (c7, c7), 'branch7x7dbl_4': (c7, c7),
                'branch7x7dbl_5': (c7, 192), 'branch_pool': (cin, 192)}
    if kind == 'D':
        return {'branch3x3_1': (cin, 192), 'branch3x3_2': (192, 320),
                'branch7x7x3_1': (cin, 192), 'branch7x7x3_2': (192, 192),
                'branch7x7x3_3': (192, 192), 'branch7x7x3_4': (192, 192)}
    if kind == 'E':
        return {'branch1x1': (cin, 320), 'branch3x3_1': (cin, 384),
                'branch3x3_2a': (384, 384), 'branch3x3_2b': (384, 384),
                'branch3x3dbl_1': (cin, 448), 'branch3x3dbl_2': (448, 384),
                'branch3x3dbl_3a': (384, 384), 'branch3x3dbl_3b': (384, 384),
                'branch_pool': (cin, 192)}
    raise ValueError(kind)


_BLOCK_CIN = {'Mixed_5b': 192, 'Mixed_5c': 256, 'Mixed_5d': 288,
              'Mixed_6a': 288, 'Mixed_6b': 768, 'Mixed_6c': 768,
              'Mixed_6d': 768, 'Mixed_6e': 768, 'Mixed_7a': 768,
              'Mixed_7b': 1280, 'Mixed_7c': 2048}


def fold_bn(conv_w: np.ndarray, gamma: np.ndarray, beta: np.ndarray,
            mean: np.ndarray, var: np.ndarray, eps: float = BN_EPS):
    """Fold batchnorm into a bias-free conv.  conv_w is torch-layout
    [O, I, kh, kw]; returns (HWIO weight, bias)."""
    scale = gamma / np.sqrt(var + eps)
    w = conv_w * scale[:, None, None, None]
    b = beta - mean * scale
    return np.transpose(w, (2, 3, 1, 0)).astype(np.float32), b.astype(np.float32)


def convert_torch_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """torchvision-layout inception_v3 state_dict (numpy values) → flat
    params {conv_name: w_hwio, conv_name + '/b': bias} with BN folded."""
    params: Dict[str, np.ndarray] = {}

    def grab(prefix: str, out_name: str):
        w, b = fold_bn(sd[f'{prefix}.conv.weight'],
                       sd[f'{prefix}.bn.weight'], sd[f'{prefix}.bn.bias'],
                       sd[f'{prefix}.bn.running_mean'],
                       sd[f'{prefix}.bn.running_var'])
        params[out_name] = w
        params[out_name + '/b'] = b

    for name, spec in STEM:
        if spec is None:
            continue
        grab(name, name)
    for bname, kind in BLOCKS:
        for cname in _SPECS[kind]:
            grab(f'{bname}.{cname}', f'{bname}.{cname}')
    return params


def init_random(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random parameters with the real shapes (for tests)."""
    rng = np.random.RandomState(seed)
    params: Dict[str, np.ndarray] = {}

    def mk(name, cin, cout, k):
        params[name] = (rng.randn(k[0], k[1], cin, cout)
                        / np.sqrt(k[0] * k[1] * cin)).astype(np.float32)
        params[name + '/b'] = (rng.randn(cout) * 0.1).astype(np.float32)

    for name, spec in STEM:
        if spec is None:
            continue
        cin, cout = _CHANNELS[name]
        mk(name, cin, cout, spec[0])
    for bname, kind in BLOCKS:
        chans = _block_channels(bname, kind, _BLOCK_CIN[bname])
        for cname, spec in _SPECS[kind].items():
            cin, cout = chans[cname]
            mk(f'{bname}.{cname}', cin, cout, spec[0])
    return params


def load_params(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def save_params(params: Dict[str, np.ndarray], path: str):
    np.savez(path, **params)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``[N, C, H, W]`` resized to ``size`` as ``jax.image.resize(...,
    'bilinear')`` (which antialiases) does: bilinear with half-pixel centres
    along an axis that grows, the triangle filter widened by the scale along
    one that shrinks.  PyTorch's ``antialias=True`` is that filter; on an
    axis that grows it rounds otherwise than the plain bilinear path, so the
    choice follows the direction, and an image that grows along one axis and
    shrinks along the other is resized one axis at a time."""
    h, w = x.shape[-2:]
    oh, ow = size
    if (h, w) == (oh, ow):
        return x

    def resize(t, hw, shrink):
        return F.interpolate(t, size=hw, mode='bilinear', align_corners=False,
                             antialias=shrink)
    if h == oh or w == ow or (oh < h) == (ow < w):
        return resize(x, (oh, ow), oh < h or ow < w)
    return resize(resize(x, (oh, w), oh < h), (oh, ow), ow < w)


class InceptionV3(nn.Module):
    """The pool3 network over NHWC images in [0, 255], from the ``.npz``
    parameter dict (HWIO weights, ``/b`` biases)."""

    def __init__(self, params: Dict[str, np.ndarray]):
        super().__init__()
        self._names = [name for name, spec in STEM if spec is not None]
        self._names += [f'{b}.{c}' for b, kind in BLOCKS for c in _SPECS[kind]]
        for name in self._names:
            w = np.asarray(params[name], np.float32).transpose(3, 2, 0, 1)
            self.register_buffer(_key(name), torch.from_numpy(w.copy()))
            self.register_buffer(_key(name) + '__b', torch.from_numpy(
                np.asarray(params[name + '/b'], np.float32).copy()))

    def _conv(self, name: str, x: torch.Tensor, spec) -> torch.Tensor:
        _, stride, pad = spec
        y = F.conv2d(x, getattr(self, _key(name)), stride=stride,
                     padding=pad)
        return F.relu(y + getattr(self, _key(name) + '__b')[:, None, None])

    def _block(self, name: str, kind: str, x: torch.Tensor) -> torch.Tensor:
        spec = _SPECS[kind]

        def c(cname, h):
            return self._conv(f'{name}.{cname}', h, spec[cname])

        if kind == 'A':
            return torch.cat([
                c('branch1x1', x), c('branch5x5_2', c('branch5x5_1', x)),
                c('branch3x3dbl_3', c('branch3x3dbl_2',
                                      c('branch3x3dbl_1', x))),
                c('branch_pool', _avgpool_nip(x))], 1)
        if kind == 'B':
            return torch.cat([
                c('branch3x3', x),
                c('branch3x3dbl_3', c('branch3x3dbl_2',
                                      c('branch3x3dbl_1', x))),
                F.max_pool2d(x, 3, 2)], 1)
        if kind == 'C':
            b2 = x
            for i in range(1, 6):
                b2 = c(f'branch7x7dbl_{i}', b2)
            return torch.cat([
                c('branch1x1', x),
                c('branch7x7_3', c('branch7x7_2', c('branch7x7_1', x))),
                b2, c('branch_pool', _avgpool_nip(x))], 1)
        if kind == 'D':
            b1 = x
            for i in range(1, 5):
                b1 = c(f'branch7x7x3_{i}', b1)
            return torch.cat([c('branch3x3_2', c('branch3x3_1', x)), b1,
                              F.max_pool2d(x, 3, 2)], 1)
        if kind == 'E':
            t = c('branch3x3_1', x)
            b1 = torch.cat([c('branch3x3_2a', t), c('branch3x3_2b', t)], 1)
            t = c('branch3x3dbl_2', c('branch3x3dbl_1', x))
            b2 = torch.cat([c('branch3x3dbl_3a', t), c('branch3x3dbl_3b', t)],
                           1)
            # FIDInceptionE_2 (Mixed_7c): a max pool in the pool branch
            pooled = (F.max_pool2d(x, 3, 1, 1) if name == 'Mixed_7c'
                      else _avgpool_nip(x))
            return torch.cat([c('branch1x1', x), b1, b2,
                              c('branch_pool', pooled)], 1)
        raise ValueError(kind)

    def forward(self, images: torch.Tensor,
                resize_input: bool = True) -> torch.Tensor:
        """images: ``[N, H, W, 3]`` float in [0, 255] → ``[N, 2048]``."""
        x = images.to(torch.float32).permute(0, 3, 1, 2)
        if resize_input:
            x = resize_bilinear(x, (299, 299))
        x = x / 127.5 - 1.0
        for name, spec in STEM:
            x = F.max_pool2d(x, 3, 2) if spec is None else \
                self._conv(name, x, spec)
        for bname, kind in BLOCKS:
            x = self._block(bname, kind, x)
        return x.mean(dim=(2, 3))


def _key(name: str) -> str:
    """A conv's buffer name (a module attribute holds no '.')."""
    return name.replace('.', '__')


def _avgpool_nip(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 pad-1 average pool with count_include_pad=False."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
