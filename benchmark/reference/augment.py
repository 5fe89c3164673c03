"""The ADA augmentation pipeline ("Training GANs with Limited Data").

Port of ``montage_gan_tpu/training/augment.py``: the same stages, draws and
gates, in NHWC, with the MontageGAN RGBA change (the colour matrix acts on
RGB; alpha passes through).  Its draws come from a ``Draws`` (so they are
not JAX's); ``debug_percentile`` replaces every parameter draw by a fixed
quantile, which makes the pipe deterministic apart from the noise stage's
field.

  * blit + geom: the composed inverse homography, a static reflect pad,
    ``ops.affine_warp`` (kernels K3'/K4' on the card) on the ×2 virtual
    plane, then the ``_down2_matrix`` axis products back to the input size;
  * colour: one 4×4 matrix per sample, float32;
  * imgfilter: the 4-band filter as per-sample banded matrices
    (``_toeplitz_rows``) over a reflect pad;
  * noise, then cutout.

Every stage is plain PyTorch apart from the warp, and is differentiable to
second order (R1 differentiates D through this pipe).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .affine_warp import affine_warp
from .filters import setup_filter
from .draws import Draws

# Wavelet low-pass decomposition coefficients (public constants; identical
# values in pywt).
WAVELETS = {
    'haar': [0.7071067811865476, 0.7071067811865476],
    'sym2': [-0.12940952255092145, 0.22414386804185735,
             0.836516303737469, 0.48296291314469025],
    'sym6': [0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
             -0.048311742585633, 0.4910559419267466, 0.787641141030194,
             0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
             0.04472490177066578, 0.0017677118642428036, -0.007800708325034148],
}


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Probability multipliers and parameter ranges (field for field the JAX
    package's, ``training/augment.py:129-169``)."""
    xflip: float = 0.0
    rotate90: float = 0.0
    xint: float = 0.0
    xint_max: float = 0.125
    scale: float = 0.0
    rotate: float = 0.0
    aniso: float = 0.0
    xfrac: float = 0.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    brightness: float = 0.0
    contrast: float = 0.0
    lumaflip: float = 0.0
    hue: float = 0.0
    saturation: float = 0.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    imgfilter: float = 0.0
    imgfilter_bands: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    imgfilter_std: float = 1.0
    noise: float = 0.0
    cutout: float = 0.0
    noise_std: float = 0.1
    cutout_size: float = 0.5
    geom_margin: Optional[int] = None  # static reflect margin; None = auto

    @property
    def any_blit(self):
        return self.xflip > 0 or self.rotate90 > 0 or self.xint > 0

    @property
    def any_geom(self):
        return (self.scale > 0 or self.rotate > 0 or self.aniso > 0
                or self.xfrac > 0)


# The reference's augpipe presets.
_BLIT = dict(xflip=1, rotate90=1, xint=1)
_GEOM = dict(scale=1, rotate=1, aniso=1, xfrac=1)
_COLOR = dict(brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1)
AUGPIPE_SPECS = {
    'blit': _BLIT,
    'geom': _GEOM,
    'color': _COLOR,
    'filter': dict(imgfilter=1),
    'noise': dict(noise=1),
    'cutout': dict(cutout=1),
    'bg': {**_BLIT, **_GEOM},
    'bgc': {**_BLIT, **_GEOM, **_COLOR},
    'bgcf': {**_BLIT, **_GEOM, **_COLOR, 'imgfilter': 1},
    'bgcfn': {**_BLIT, **_GEOM, **_COLOR, 'imgfilter': 1, 'noise': 1},
    'bgcfnc': {**_BLIT, **_GEOM, **_COLOR, 'imgfilter': 1, 'noise': 1,
               'cutout': 1},
}


def make_augment_config(spec: str, **overrides) -> AugmentConfig:
    return AugmentConfig(**{**AUGPIPE_SPECS[spec], **overrides})


def _make_fbank() -> np.ndarray:
    """The 4-band filter bank from sym2."""
    hz_lo = np.asarray(WAVELETS['sym2'])
    hz_hi = hz_lo * ((-1) ** np.arange(hz_lo.size))
    hz_lo2 = np.convolve(hz_lo, hz_lo[::-1]) / 2
    hz_hi2 = np.convolve(hz_hi, hz_hi[::-1]) / 2
    fbank = np.eye(4, 1)
    for i in range(1, fbank.shape[0]):
        fbank = np.dstack([fbank, np.zeros_like(fbank)]).reshape(
            fbank.shape[0], -1)[:, :-1]
        fbank = np.stack([np.convolve(row, hz_lo2) for row in fbank])
        fbank[i, (fbank.shape[1] - hz_hi2.size) // 2:
                 (fbank.shape[1] + hz_hi2.size) // 2] += hz_hi2
    return fbank.astype(np.float32)


_HZ_FBANK = _make_fbank()
_HZ_GEOM = setup_filter(WAVELETS['sym6'])          # 12 taps, separable


@functools.lru_cache(maxsize=None)
def _down2_matrix(n_in: int) -> np.ndarray:
    """``[n_out, n_in]`` matrix of the geometric branch's trailing
    ``downsample2d(f=_HZ_GEOM, down=2, padding=-2·hz_pad, flip_filter=True)``
    along one axis: ``out[q] = Σ_j f[j]·x[2q + j − p0]``, with upfirdn2d's
    pads ``p0 = pad + (taps − 1)//2``, ``p1 = pad + (taps − 2)//2`` (the
    general form; they are equal only for an even tap count)."""
    f = _HZ_GEOM.numpy()
    taps = int(f.shape[0])
    pad = -2 * (taps // 4)
    p0 = pad + (taps - 2 + 1) // 2
    p1 = pad + (taps - 2) // 2
    n_out = (n_in + p0 + p1 - taps) // 2 + 1
    d = np.zeros((n_out, n_in), np.float32)
    for q in range(n_out):
        for j in range(taps):
            s = 2 * q + j - p0
            if 0 <= s < n_in:
                d[q, s] += f[j]
    return d


@functools.lru_cache(maxsize=None)
def _constant(name: str, n: int, device: str) -> torch.Tensor:
    """The geometric branch's constant tensors on ``device`` (built once):
    the 12-tap filter, or the down2 matrix for ``n`` rows."""
    if name == 'geom_filter':
        return _HZ_GEOM.to(device)
    return torch.from_numpy(_down2_matrix(n)).to(device)


def _toeplitz_rows(f: torch.Tensor, n_out: int) -> torch.Tensor:
    """``[B, taps]`` → ``[B, n_out, n_out + taps − 1]`` banded matrices with
    ``M[b, i, i + t] = f[b, t]``: ``M @ x_padded`` is the valid correlation
    of the padded ``x`` with ``f``."""
    b, taps = f.shape
    width = n_out + taps - 1
    c = torch.cat([f, f.new_zeros(b, n_out)], dim=1)
    return c.repeat(1, n_out)[:, :n_out * width].reshape(b, n_out, width)


def _reflect_index(n: int, pad0: int, pad1: int, device) -> torch.Tensor:
    """Source rows of a reflect pad (numpy's 'reflect': the edge is not
    repeated; pads longer than the axis reflect again)."""
    i = torch.arange(-pad0, n + pad1, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    r = torch.remainder(i, period)
    return torch.where(r < n, r, period - r)


def reflect_pad(x: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """Reflect-pad NHWC ``x`` by ``py`` rows and ``px`` columns per side."""
    _, h, w, _ = x.shape
    x = x.index_select(1, _reflect_index(h, py, py, x.device))
    return x.index_select(2, _reflect_index(w, px, px, x.device))


# ---------------------------------------------------------------------------
# Batched homogeneous matrices
# ---------------------------------------------------------------------------

def _rows(*rows) -> torch.Tensor:
    """Rows of (batched) scalars → ``[..., R, C]`` float32 matrices."""
    elems = [e for row in rows for e in row]
    ref = next(e for e in elems if isinstance(e, torch.Tensor))
    elems = [e if isinstance(e, torch.Tensor)
             else torch.full_like(ref, float(e)) for e in elems]
    elems = torch.broadcast_tensors(*elems)
    m = torch.stack(elems, dim=-1)
    return m.reshape(*elems[0].shape, len(rows), len(rows[0]))


def translate2d(tx, ty):
    return _rows([1, 0, tx], [0, 1, ty], [0, 0, 1])


def scale2d(sx, sy):
    return _rows([sx, 0, 0], [0, sy, 0], [0, 0, 1])


def rotate2d(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return _rows([c, -s, 0], [s, c, 0], [0, 0, 1])


def translate3d(tx, ty, tz):
    return _rows([1, 0, 0, tx], [0, 1, 0, ty], [0, 0, 1, tz], [0, 0, 0, 1])


def scale3d(sx, sy, sz):
    return _rows([sx, 0, 0, 0], [0, sy, 0, 0], [0, 0, sz, 0], [0, 0, 0, 1])


def rotate3d(v, theta):
    vx, vy, vz = (float(a) for a in v[:3])
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1 - c
    return _rows(
        [vx * vx * cc + c, vx * vy * cc - vz * s, vx * vz * cc + vy * s, 0],
        [vy * vx * cc + vz * s, vy * vy * cc + c, vy * vz * cc - vx * s, 0],
        [vz * vx * cc - vy * s, vz * vy * cc + vx * s, vz * vz * cc + c, 0],
        [0, 0, 0, 1])


def _const(batch: int, value: float, device) -> torch.Tensor:
    return torch.full((batch,), float(value), device=device)


def _erfinv(x: float) -> float:
    return float(torch.special.erfinv(torch.tensor(x, dtype=torch.float64)))


def _gate(draws: Draws, prob, value: torch.Tensor,
          identity: torch.Tensor) -> torch.Tensor:
    """Per sample: ``value`` with probability ``prob``, else ``identity``."""
    take = draws.uniform([value.shape[0]], 'augment') < prob
    return torch.where(take.reshape([-1] + [1] * (value.ndim - 1)), value,
                       identity)


# ---------------------------------------------------------------------------
# The geometric branch
# ---------------------------------------------------------------------------

def _sample_geom_inverse(draws: Draws, p, cfg: AugmentConfig, batch: int,
                         height: int, width: int, dp, device):
    """The composed inverse homography of the pixel-blit and geometric
    stages (JAX ``training/augment.py:334-394``)."""
    g_inv = torch.eye(3, device=device).repeat(batch, 1, 1)

    def uniform(*shape):
        return draws.uniform([batch, *shape], 'augment')

    def normal(*shape):
        return draws.normal([batch, *shape], 'augment')

    if cfg.xflip > 0:
        i = torch.floor(uniform() * 2)
        i = _gate(draws, cfg.xflip * p, i, torch.zeros_like(i))
        if dp is not None:
            i = torch.full_like(i, np.floor(dp * 2))
        g_inv = g_inv @ scale2d(1 / (1 - 2 * i), 1)
    if cfg.rotate90 > 0:
        i = torch.floor(uniform() * 4)
        i = _gate(draws, cfg.rotate90 * p, i, torch.zeros_like(i))
        if dp is not None:
            i = torch.full_like(i, np.floor(dp * 4))
        g_inv = g_inv @ rotate2d(np.pi / 2 * i)
    if cfg.xint > 0:
        t = (uniform(2) * 2 - 1) * cfg.xint_max
        t = _gate(draws, cfg.xint * p, t, torch.zeros_like(t))
        if dp is not None:
            t = torch.full_like(t, (dp * 2 - 1) * cfg.xint_max)
        g_inv = g_inv @ translate2d(-torch.round(t[:, 0] * width),
                                    -torch.round(t[:, 1] * height))
    if cfg.scale > 0:
        s = torch.exp2(normal() * cfg.scale_std)
        s = _gate(draws, cfg.scale * p, s, torch.ones_like(s))
        if dp is not None:
            s = torch.full_like(s, np.exp2(_erfinv(dp * 2 - 1) * cfg.scale_std))
        g_inv = g_inv @ scale2d(1 / s, 1 / s)
    p_rot = 1 - torch.sqrt(torch.clamp(1 - cfg.rotate * torch.as_tensor(
        p, dtype=torch.float32, device=device), 0, 1))
    if cfg.rotate > 0:
        theta = (uniform() * 2 - 1) * np.pi * cfg.rotate_max
        theta = _gate(draws, p_rot, theta, torch.zeros_like(theta))
        if dp is not None:
            theta = torch.full_like(theta, (dp * 2 - 1) * np.pi * cfg.rotate_max)
        g_inv = g_inv @ rotate2d(theta)
    if cfg.aniso > 0:
        s = torch.exp2(normal() * cfg.aniso_std)
        s = _gate(draws, cfg.aniso * p, s, torch.ones_like(s))
        if dp is not None:
            s = torch.full_like(s, np.exp2(_erfinv(dp * 2 - 1) * cfg.aniso_std))
        g_inv = g_inv @ scale2d(1 / s, s)
    if cfg.rotate > 0:
        theta = (uniform() * 2 - 1) * np.pi * cfg.rotate_max
        theta = _gate(draws, p_rot, theta, torch.zeros_like(theta))
        if dp is not None:
            theta = torch.zeros_like(theta)
        g_inv = g_inv @ rotate2d(theta)
    if cfg.xfrac > 0:
        t = normal(2) * cfg.xfrac_std
        t = _gate(draws, cfg.xfrac * p, t, torch.zeros_like(t))
        if dp is not None:
            t = torch.full_like(t, _erfinv(dp * 2 - 1) * cfg.xfrac_std)
        g_inv = g_inv @ translate2d(-t[:, 0] * width, -t[:, 1] * height)
    return g_inv


def _warp_geometry(cfg: AugmentConfig, height: int, width: int):
    """Static plane geometry of the geometric branch: (hz_pad, x margin,
    y margin, padded height, padded width, warp output height and width)."""
    hz_pad = _HZ_GEOM.shape[0] // 4
    mx, my = cfg.geom_margin, cfg.geom_margin
    if mx is None:
        mx = min(width // 4 + hz_pad * 2, width - 1)
        my = min(height // 4 + hz_pad * 2, height - 1)
    out_h, out_w = (height + hz_pad * 2) * 2, (width + hz_pad * 2) * 2
    return hz_pad, mx, my, height + 2 * my, width + 2 * mx, out_h, out_w


def _normalize_geom_matrix(g_inv: torch.Tensor, pad_h: int, pad_w: int,
                           out_h: int, out_w: int) -> torch.Tensor:
    """The unit-square homography → the warp's normalized affine_grid theta
    over the ×2-upsampled padded plane (``[B, 3, 3]``)."""
    dev = g_inv.device

    def const(fn, *args):
        return fn(*(torch.tensor(float(a), device=dev) for a in args))

    g = const(scale2d, 2.0, 2.0) @ g_inv @ const(scale2d, 0.5, 0.5)
    g = const(translate2d, -0.5, -0.5) @ g @ const(translate2d, 0.5, 0.5)
    in_h, in_w = pad_h * 2, pad_w * 2
    # the inverse scale as JAX rounds it: 1 / float32(2 / out)
    inv_out = 1.0 / torch.tensor([2.0 / out_w, 2.0 / out_h], device=dev)
    return (const(scale2d, 2.0 / in_w, 2.0 / in_h) @ g
            @ scale2d(inv_out[0], inv_out[1]))


def sample_warp_theta(draws: Draws, p, cfg: AugmentConfig, batch: int,
                      height: int, width: int, device='cuda'):
    """The theta law of the geometric branch's warp for ``[batch, height,
    width, C]`` inputs at probability ``p``, from the pipe's own sampling
    code: ``(theta [B, 2, 3], pad_h, pad_w, out_h, out_w)``, where pad_* is
    the stored (reflect-padded, 1×) plane the warp reads."""
    g_inv = _sample_geom_inverse(draws, p, cfg, batch, height, width, None,
                                 device)
    _, _, _, pad_h, pad_w, out_h, out_w = _warp_geometry(cfg, height, width)
    g = _normalize_geom_matrix(g_inv, pad_h, pad_w, out_h, out_w)
    return g[:, :2, :], pad_h, pad_w, out_h, out_w


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

def augment_pipe(images: torch.Tensor, p, cfg: AugmentConfig, draws: Draws,
                 debug_percentile: Optional[float] = None) -> torch.Tensor:
    """Apply the ADA pipeline to NHWC float32 images with overall
    probability ``p`` (a float or a scalar tensor on the images' device).
    ``debug_percentile`` replaces every parameter draw with a fixed
    quantile."""
    batch, height, width, num_channels = images.shape
    dev = images.device
    dp = debug_percentile

    # ----------------------- pixel blitting + geometric ------------------
    g_inv = _sample_geom_inverse(draws, p, cfg, batch, height, width, dp, dev)
    if cfg.any_blit or cfg.any_geom:
        _, mx, my, pad_h, pad_w, out_h, out_w = _warp_geometry(
            cfg, height, width)
        x = reflect_pad(images, my, mx)
        g = _normalize_geom_matrix(g_inv, pad_h, pad_w, out_h, out_w)
        x = affine_warp(x, g[:, :2, :], out_h, out_w, up=2,
                        up_filter=_constant('geom_filter', 0, str(dev)))
        dy = _constant('down2', out_h, str(dev))
        dx = _constant('down2', out_w, str(dev))
        x = torch.einsum('qh,nhwc->nqwc', dy, x)
        images = torch.einsum('rw,nqwc->nqrc', dx, x)

    # ------------------------------ colour --------------------------------
    if (cfg.brightness > 0 or cfg.contrast > 0 or cfg.lumaflip > 0
            or cfg.hue > 0 or cfg.saturation > 0):
        images = _color(images, p, cfg, draws, dp)

    # -------------------------- image-space filtering --------------------
    if cfg.imgfilter > 0:
        images = _imgfilter(images, p, cfg, draws, dp)

    # -------------------------- corruptions ------------------------------
    if cfg.noise > 0:
        sigma = draws.normal([batch, 1, 1, 1], 'augment').abs() * cfg.noise_std
        sigma = _gate(draws, cfg.noise * p, sigma, torch.zeros_like(sigma))
        if dp is not None:
            sigma = torch.full_like(sigma, _erfinv(dp) * cfg.noise_std)
        images = images + draws.normal(
            [batch, height, width, num_channels], 'augment') * sigma

    if cfg.cutout > 0:
        size = torch.full((batch, 2), cfg.cutout_size, device=dev)
        keep = draws.uniform([batch, 1], 'augment') < cfg.cutout * p
        size = torch.where(keep, size, torch.zeros_like(size))
        center = draws.uniform([batch, 2], 'augment')
        if dp is not None:
            size = torch.full_like(size, cfg.cutout_size)
            center = torch.full_like(center, dp)
        coord_x = (torch.arange(width, dtype=torch.float32, device=dev)
                   + 0.5) / width
        coord_y = (torch.arange(height, dtype=torch.float32, device=dev)
                   + 0.5) / height
        mask_x = ((coord_x[None, None, :] - center[:, 0, None, None]).abs()
                  >= size[:, 0, None, None] / 2)
        mask_y = ((coord_y[None, :, None] - center[:, 1, None, None]).abs()
                  >= size[:, 1, None, None] / 2)
        mask = (mask_x | mask_y).to(images.dtype)
        images = images * mask[..., None]
    return images


def _color(images, p, cfg: AugmentConfig, draws: Draws, dp):
    """The colour 4×4 chain, float32, on RGB (alpha passes through)."""
    batch, height, width, num_channels = images.shape
    dev = images.device
    eye4 = torch.eye(4, device=dev)
    c_mat = eye4.repeat(batch, 1, 1)

    def normal(*shape):
        return draws.normal([batch, *shape], 'augment')

    def uniform(*shape):
        return draws.uniform([batch, *shape], 'augment')

    if cfg.brightness > 0:
        b = normal() * cfg.brightness_std
        b = _gate(draws, cfg.brightness * p, b, torch.zeros_like(b))
        if dp is not None:
            b = torch.full_like(b, _erfinv(dp * 2 - 1) * cfg.brightness_std)
        c_mat = translate3d(b, b, b) @ c_mat
    if cfg.contrast > 0:
        c = torch.exp2(normal() * cfg.contrast_std)
        c = _gate(draws, cfg.contrast * p, c, torch.ones_like(c))
        if dp is not None:
            c = torch.full_like(c, np.exp2(_erfinv(dp * 2 - 1) * cfg.contrast_std))
        c_mat = scale3d(c, c, c) @ c_mat
    v = np.asarray([1, 1, 1, 0], dtype=np.float32) / np.sqrt(3)
    vv = torch.from_numpy(np.outer(v, v)).float().to(dev)
    if cfg.lumaflip > 0:
        i = torch.floor(uniform(1, 1) * 2)
        i = _gate(draws, cfg.lumaflip * p, i, torch.zeros_like(i))
        if dp is not None:
            i = torch.full_like(i, np.floor(dp * 2))
        c_mat = (eye4[None] - 2 * vv[None] * i) @ c_mat   # Householder
    if cfg.hue > 0 and num_channels > 1:
        theta = (uniform() * 2 - 1) * np.pi * cfg.hue_max
        theta = _gate(draws, cfg.hue * p, theta, torch.zeros_like(theta))
        if dp is not None:
            theta = torch.full_like(theta, (dp * 2 - 1) * np.pi * cfg.hue_max)
        c_mat = rotate3d(v, theta) @ c_mat
    if cfg.saturation > 0 and num_channels > 1:
        s = torch.exp2(normal(1, 1) * cfg.saturation_std)
        s = _gate(draws, cfg.saturation * p, s, torch.ones_like(s))
        if dp is not None:
            s = torch.full_like(s, np.exp2(_erfinv(dp * 2 - 1)
                                           * cfg.saturation_std))
        c_mat = (vv[None] + (eye4[None] - vv[None]) * s) @ c_mat

    flat = images.reshape(batch, height * width, num_channels)
    if num_channels == 4:
        rgb = torch.einsum('nab,npb->npa', c_mat[:, :3, :3], flat[..., :3]) \
            + c_mat[:, None, :3, 3]
        flat = torch.cat([rgb, flat[..., 3:]], dim=-1)
    elif num_channels == 3:
        flat = torch.einsum('nab,npb->npa', c_mat[:, :3, :3], flat) \
            + c_mat[:, None, :3, 3]
    elif num_channels == 1:
        cm = c_mat[:, :3, :].mean(dim=1, keepdim=True)          # [B, 1, 4]
        flat = flat * cm[:, :, :3].sum(dim=2, keepdim=True) + cm[:, :, 3:]
    else:
        raise ValueError('images must have 1, 3, or 4 channels')
    return flat.reshape(batch, height, width, num_channels)


def _imgfilter(images, p, cfg: AugmentConfig, draws: Draws, dp):
    """The 4-band image filter as banded matrix products."""
    batch, height, width, _ = images.shape
    dev = images.device
    num_bands = _HZ_FBANK.shape[0]
    if len(cfg.imgfilter_bands) != num_bands:
        raise ValueError(f'imgfilter_bands needs {num_bands} entries')
    expected_power = torch.tensor([10, 1, 1, 1], dtype=torch.float32,
                                  device=dev) / 13
    g = torch.ones(batch, num_bands, device=dev)
    for i, band_strength in enumerate(cfg.imgfilter_bands):
        t_i = torch.exp2(draws.normal([batch], 'augment') * cfg.imgfilter_std)
        t_i = _gate(draws, cfg.imgfilter * p * band_strength, t_i,
                    torch.ones_like(t_i))
        if dp is not None:
            t_i = (torch.full_like(t_i, np.exp2(_erfinv(dp * 2 - 1)
                                                * cfg.imgfilter_std))
                   if band_strength > 0 else torch.ones_like(t_i))
        t = torch.ones(batch, num_bands, device=dev)
        t[:, i] = t_i
        t = t / torch.sqrt((expected_power[None] * t.square()).sum(
            dim=-1, keepdim=True))
        g = g * t
    hz_prime = g @ torch.from_numpy(_HZ_FBANK).to(dev)          # [B, taps]
    pad = _HZ_FBANK.shape[1] // 2
    x = reflect_pad(images, pad, pad)
    my = _toeplitz_rows(hz_prime, height)
    mx = my if width == height else _toeplitz_rows(hz_prime, width)
    x = torch.einsum('nqh,nhwc->nqwc', my, x)
    return torch.einsum('nrw,nqwc->nqrc', mx, x)

