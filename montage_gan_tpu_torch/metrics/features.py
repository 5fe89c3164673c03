"""Feature extractors of the distribution and perceptual metrics.

Port of ``montage_gan_tpu/metrics/features.py``.  The reference downloads
NVIDIA's Inception-2015-12-05 and VGG16-LPIPS detectors at run time
(reference: metrics/metric_utils.py:46-57); offline they are supplied as
converted ``.npz`` files, found as the JAX package finds them
(``resolve_weights``: the env var, else the drop-in directory), so one
drop-in directory serves both packages:

  * ``InceptionV3Features``: pool3 features (``inception_net.py``); with the
    standard weights, standard FID.
  * ``VGG16Features``: LPIPS features (``vgg16_net.py``), whose squared L2
    distance is the LPIPS distance.
  * ``RandomFeatures``: a seeded random strided-conv pyramid, the fallback
    when no weights are present; FID and KID computed with it are relative
    numbers.  Its weights come from a seeded ``torch.Generator``: the JAX
    package draws them with ``jax.random``, which the port cannot
    reproduce, so its name (``random2048_torch``) differs from the JAX
    package's and caches and reports never mix the two
    (``utils/weights.py::random_features_from_jax`` carries the JAX
    weights across for the tests).

Every extractor is an ``nn.Module`` on an explicit device (``'cuda'`` unless
the caller passes ``device='cpu'``; without a card it raises) that takes
``[N, H, W, 3]`` float in [0, 255] and returns ``[N, D]``.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import set_fp32_precision


def weights_dropin_dir() -> str:
    """The offline weights drop-in directory (``MGT_WEIGHTS_DIR``, default
    ``~/.cache/montage_gan_tpu/weights``): converted detector ``.npz`` files
    placed there are found when the per-detector env vars are unset."""
    return os.environ.get(
        'MGT_WEIGHTS_DIR',
        os.path.join(os.path.expanduser('~'), '.cache', 'montage_gan_tpu',
                     'weights'))


def resolve_weights(env: str, dropin_name: str) -> Optional[str]:
    """Env var first, then the drop-in directory; None if neither exists."""
    path = os.environ.get(env)
    if path:
        return path
    cand = os.path.join(weights_dropin_dir(), dropin_name)
    return cand if os.path.exists(cand) else None


def metric_device(device='cuda') -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises
    (the metrics never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" (--device cpu) '
                           'to compute metrics on the CPU')
    return dev


def same_padding(size: int, kernel: int = 3, stride: int = 2):
    """(before, after) padding of XLA's ``'SAME'`` along an axis of
    ``size``: the output holds ``ceil(size / stride)`` samples and an odd
    total pads one more after (for an even size at stride 2: (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class RandomFeatures(nn.Module):
    """Seeded random conv pyramid: ``num_stages`` 3×3 stride-2 'SAME' convs
    with leaky ReLU 0.2, a global average pool and a projection to 2048
    (the JAX package's ``RandomFeatures``, LeCun-normal weights)."""

    name = 'random2048_torch'
    feature_dim = 2048

    def __init__(self, seed: int = 0, num_stages: int = 4, width: int = 128,
                 channels: int = 3, device='cuda',
                 weights: Optional[List[np.ndarray]] = None):
        super().__init__()
        self.seed = seed
        if weights is None:
            weights = []
            cin = channels
            for i in range(num_stages):
                cout = min(width * (2 ** i), 512)
                weights.append(self._normal(i, (3, 3, cin, cout))
                               / np.sqrt(9 * cin))
                cin = cout
            weights.append(self._normal(99, (cin, self.feature_dim))
                           / np.sqrt(cin))
        for i, w in enumerate(weights[:-1]):      # HWIO → OIHW
            self.register_buffer(f'w{i}', torch.from_numpy(np.ascontiguousarray(
                np.asarray(w, np.float32).transpose(3, 2, 0, 1))))
        self.register_buffer('proj', torch.from_numpy(
            np.array(weights[-1], np.float32)))
        self.num_stages = len(weights) - 1
        self.feature_dim = self.proj.shape[1]
        set_fp32_precision()
        self.to(metric_device(device)).eval()

    def _normal(self, stream: int, shape) -> np.ndarray:
        seed = np.random.SeedSequence([self.seed, stream]).generate_state(1)
        g = torch.Generator().manual_seed(int(seed[0]))
        return torch.randn(shape, generator=g).numpy()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: ``[N, H, W, C]`` in [0, 255] float → ``[N, 2048]``."""
        x = (images.to(torch.float32) / 127.5 - 1.0).permute(0, 3, 1, 2)
        for i in range(self.num_stages):
            (t, b), (l, r) = (same_padding(n) for n in x.shape[-2:])
            x = F.conv2d(F.pad(x, (l, r, t, b)), getattr(self, f'w{i}'),
                         stride=2)
            x = F.leaky_relu(x, 0.2)
        return x.mean(dim=(2, 3)) @ self.proj


class _Npz(nn.Module):
    """A detector whose ``.npz`` weights come from ``path``, else from the
    env var ``env``, else from the drop-in directory's ``dropin``."""

    env = dropin = hint = ''

    def __init__(self, weights_path: Optional[str] = None, device='cuda'):
        super().__init__()
        self.weights_path = weights_path or resolve_weights(self.env,
                                                            self.dropin)
        if not self.weights_path or not os.path.exists(self.weights_path):
            raise FileNotFoundError(self.hint)
        dev = metric_device(device)
        self.net = self._build(np.load(self.weights_path))
        set_fp32_precision()
        self.to(dev).eval()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.net(images)


class InceptionV3Features(_Npz):
    """InceptionV3 pool3 features (FID) from converted weights
    (``python -m montage_gan_tpu_torch.utils.convert_inception in.pth
    out.npz``, then ``MGT_INCEPTION_WEIGHTS=out.npz`` or ``inception.npz``
    in the drop-in directory)."""

    name = 'inception_v3'
    feature_dim = 2048
    env, dropin = 'MGT_INCEPTION_WEIGHTS', 'inception.npz'
    hint = ('InceptionV3 weights not available. Convert the standard '
            'detector (utils/convert_inception.py) and point '
            'MGT_INCEPTION_WEIGHTS at the .npz, or use '
            'feature_extractor="random" for relative metrics.')

    @staticmethod
    def _build(npz):
        from ..utils.weights import inception_v3_from_jax
        with npz:
            return inception_v3_from_jax({k: npz[k] for k in npz.files})


class VGG16Features(_Npz):
    """VGG16-LPIPS features from converted weights
    (``python -m montage_gan_tpu_torch.utils.convert_vgg16``, then
    ``MGT_VGG16_WEIGHTS`` or ``vgg16.npz`` in the drop-in directory); the
    feature length depends on the input's size
    (``vgg16_net.feature_dim``)."""

    name = 'vgg16_lpips'
    feature_dim = None
    env, dropin = 'MGT_VGG16_WEIGHTS', 'vgg16.npz'
    hint = ('VGG16 weights not available. Convert once with '
            'utils/convert_vgg16.py and point MGT_VGG16_WEIGHTS at the '
            '.npz, or use the random-feature distance (relative only).')

    @staticmethod
    def _build(npz):
        from ..utils.weights import vgg16_from_jax
        with npz:
            return vgg16_from_jax({k: npz[k] for k in npz.files})


def build_extractor(kind: str = 'auto', device='cuda', **kwargs):
    """``'auto'`` (InceptionV3 where its weights are found, else random),
    ``'auto_lpips'`` (VGG16-LPIPS, else random), ``'random'``,
    ``'inception'``, ``'vgg16'`` or ``'lpips'``, on ``device``."""
    if kind == 'auto':
        try:
            return InceptionV3Features(device=device, **kwargs)
        except FileNotFoundError:
            return RandomFeatures(device=device)
    if kind == 'auto_lpips':
        try:
            return VGG16Features(device=device, **kwargs)
        except FileNotFoundError:
            return RandomFeatures(device=device)
    if kind == 'random':
        return RandomFeatures(device=device, **kwargs)
    if kind == 'inception':
        return InceptionV3Features(device=device, **kwargs)
    if kind in ('vgg16', 'lpips'):
        return VGG16Features(device=device, **kwargs)
    raise ValueError(kind)
