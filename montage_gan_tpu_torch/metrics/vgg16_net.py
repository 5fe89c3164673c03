"""VGG16-LPIPS as a PyTorch feature network (inference only).

Port of ``montage_gan_tpu/metrics/vgg16_net.py:38-206``: the contract of
the reference's ``vgg16.pt`` detector called with ``return_lpips=True``
(reference: metrics/perceptual_path_length.py:44-47, projector.py:61-63), a
feature vector whose squared L2 distance between two images is their
LPIPS(VGG) distance:

  * the VGG16 'D' conv stack (13 3×3 convs, 2×2 VALID max pools), tapped
    after relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3;
  * each tap unit-normalised along channels (``t / (‖t‖ + 1e-10)``),
    scaled by ``sqrt(lin_l / (H_l · W_l))`` with ``lin_l`` the learned
    per-channel LPIPS weights, and flattened in NHWC order;
  * the input, NHWC RGB in [0, 255], mapped to [-1, 1] and through the
    LPIPS scaling layer (``_SHIFT``, ``_SCALE``).

Weights are the JAX package's ``.npz`` (``conv*_w`` HWIO, ``conv*_b``,
``lin0``-``lin4``), written by ``utils/convert_vgg16.py``.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG16 'D' configuration: (name, out_channels); 'pool' entries are 2x2/2
# max pools.  Taps are the relu outputs listed in TAPS.
CONFIG = [
    ('conv1_1', 64), ('conv1_2', 64), ('pool1', None),
    ('conv2_1', 128), ('conv2_2', 128), ('pool2', None),
    ('conv3_1', 256), ('conv3_2', 256), ('conv3_3', 256), ('pool3', None),
    ('conv4_1', 512), ('conv4_2', 512), ('conv4_3', 512), ('pool4', None),
    ('conv5_1', 512), ('conv5_2', 512), ('conv5_3', 512), ('pool5', None),
]
TAPS = ['conv1_2', 'conv2_2', 'conv3_3', 'conv4_3', 'conv5_3']
TAP_CHANNELS = [64, 128, 256, 512, 512]

# LPIPS ScalingLayer constants (images in [-1, 1]).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class VGG16LPIPS(nn.Module):
    """The LPIPS feature network from the ``.npz`` parameter dict."""

    def __init__(self, params: Dict[str, np.ndarray]):
        super().__init__()
        for name, _ in CONFIG:
            if name.startswith('pool'):
                continue
            w = np.asarray(params[f'{name}_w'], np.float32)
            self.register_buffer(f'{name}_w', torch.from_numpy(
                w.transpose(3, 2, 0, 1).copy()))
            self.register_buffer(f'{name}_b', torch.from_numpy(
                np.asarray(params[f'{name}_b'], np.float32).copy()))
        for i in range(len(TAPS)):
            self.register_buffer(f'lin{i}', torch.from_numpy(
                np.asarray(params[f'lin{i}'], np.float32).copy()))
        self.register_buffer('shift', torch.from_numpy(_SHIFT.copy()))
        self.register_buffer('scale', torch.from_numpy(_SCALE.copy()))

    def forward(self, images: torch.Tensor,
                return_lpips: bool = True) -> torch.Tensor:
        """images: ``[N, H, W, 3]`` float in [0, 255] → LPIPS features
        ``[N, D]``; with ``return_lpips=False`` the raw relu5_3 map
        (NHWC)."""
        x = images.to(torch.float32) / 127.5 - 1.0
        x = ((x - self.shift) / self.scale).permute(0, 3, 1, 2)
        taps = []
        for name, _ in CONFIG:
            if name.startswith('pool'):
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.conv2d(x, getattr(self, f'{name}_w'), padding=1)
            x = F.relu(x + getattr(self, f'{name}_b')[:, None, None])
            if name in TAPS:
                taps.append(x)
        if not return_lpips:
            return taps[-1].permute(0, 2, 3, 1)
        feats = []
        for i, t in enumerate(taps):
            norm = t.square().sum(dim=1, keepdim=True).sqrt()
            t_hat = t / (norm + 1e-10)
            h, w = t.shape[2], t.shape[3]
            scaled = t_hat * (getattr(self, f'lin{i}') / (h * w)).sqrt()[
                :, None, None]
            feats.append(scaled.permute(0, 2, 3, 1).reshape(t.shape[0], -1))
        return torch.cat(feats, dim=-1)


def feature_dim(height: int, width: int) -> int:
    """LPIPS feature length for a given input size (dim depends on H, W)."""
    d, h, w = 0, height, width
    for i, c in enumerate(TAP_CHANNELS):
        # taps happen before the i+1'th pool; spatial size halves per pool
        hh, ww = h >> i, w >> i
        d += c * hh * ww
    return d


# ----------------------------------------------------------------------
# Weight conversion / IO
# ----------------------------------------------------------------------

def convert_torch_state_dict(sd: Dict[str, np.ndarray],
                             lpips_sd: Dict[str, np.ndarray] | None = None
                             ) -> Dict[str, np.ndarray]:
    """torchvision ``vgg16().features`` state_dict → this module's params.

    Accepts either torchvision naming (``features.{idx}.weight``) or plain
    sequential indices; conv weights are transposed OIHW → HWIO.  LPIPS
    linear heads (``lin{l}.model.1.weight`` [1, C, 1, 1], from the official
    LPIPS ``vgg.pth``) may live in the same dict or in ``lpips_sd``; absent
    heads fall back to uniform ``1/C``.
    """
    # map sequential torchvision indices to conv names
    idx_to_name = {}
    idx = 0
    for name, _ in CONFIG:
        if name.startswith('pool'):
            idx += 1  # MaxPool2d occupies one slot
            continue
        idx_to_name[idx] = name
        idx += 2  # Conv2d + ReLU

    params: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        kk = k
        for prefix in ('features.', 'layers.', 'model.'):
            if kk.startswith(prefix):
                kk = kk[len(prefix):]
        parts = kk.split('.')
        if parts[0].isdigit() and int(parts[0]) in idx_to_name:
            name = idx_to_name[int(parts[0])]
            if parts[-1] == 'weight':
                params[f'{name}_w'] = np.transpose(
                    np.asarray(v, np.float32), (2, 3, 1, 0))
            elif parts[-1] == 'bias':
                params[f'{name}_b'] = np.asarray(v, np.float32)
        elif kk.startswith('conv') and (kk.endswith('_w') or
                                        kk.endswith('_b')):
            arr = np.asarray(v, np.float32)
            out_ch = dict(CONFIG).get(kk[:-2])
            if kk.endswith('_w') and not (arr.shape[:2] == (3, 3) and
                                          arr.shape[-1] == out_ch):
                arr = np.transpose(arr, (2, 3, 1, 0))  # OIHW → HWIO
            params[kk] = arr

    for src in (sd, lpips_sd or {}):
        for k, v in src.items():
            if '.model.1.weight' in k or (k.startswith('lin') and
                                          k.endswith('.weight')):
                # accept 'lin0.model.1.weight' and the ModuleList alias
                # 'lins.0.model.1.weight'; ignore unrecognized shapes
                m = re.match(r'lins?\.?(\d+)\.', k)
                if m is None:
                    continue
                lin = np.asarray(v, np.float32).reshape(-1)
                # LPIPS linear heads are non-negative by construction;
                # clamp so sqrt() below can never produce NaN features
                params[f'lin{int(m.group(1))}'] = np.maximum(lin, 0.0)

    for name, _ in CONFIG:
        if name.startswith('pool'):
            continue
        if f'{name}_w' not in params or f'{name}_b' not in params:
            raise KeyError(f'missing VGG16 conv params for {name}')
    for i, c in enumerate(TAP_CHANNELS):
        params.setdefault(f'lin{i}',
                          np.full((c,), 1.0 / c, np.float32))
        if params[f'lin{i}'].shape != (c,):
            raise ValueError(f'lin{i} has shape {params[f"lin{i}"].shape}, '
                             f'expected ({c},)')
    return params


def init_random(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random parameters with the real shapes (for tests)."""
    rng = np.random.RandomState(seed)
    params: Dict[str, np.ndarray] = {}
    cin = 3
    for name, cout in CONFIG:
        if name.startswith('pool'):
            continue
        params[f'{name}_w'] = (rng.randn(3, 3, cin, cout)
                               / np.sqrt(9 * cin)).astype(np.float32)
        params[f'{name}_b'] = (rng.randn(cout) * 0.1).astype(np.float32)
        cin = cout
    for i, c in enumerate(TAP_CHANNELS):
        params[f'lin{i}'] = np.full((c,), 1.0 / c, np.float32)
    return params


def save_params(params: Dict[str, np.ndarray], path: str) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def load_params(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
