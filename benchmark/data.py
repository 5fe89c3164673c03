"""The traffic: synthetic training data made from the seed.

A copy of the port's generator (``data/synthetic.py``): each of the 9 named
layers of a sample is an anti-aliased ellipse of a random colour near the
layer's canonical place.  A ``layers`` mix writes every sample as a
directory of 9 RGBA layer PNGs (``DatasetAIO``'s layout); an ``images`` mix
writes every sample as one RGB PNG, the layers composited over a random
background (``ImageFolderDataset``'s layout).  The sizes are the same for
every seed; only the content changes.  The PNGs are written here (filter
0 on every row, zlib level 6) and read back here for the reference, so the
reference takes nothing the port decoded."""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np

SIZE = 256
# (file name, centre (x, y), radii (x, y)) of the layers at 256 px
LAYERS = (
    ('#1_hair_back', (128, 110), (90, 100)),
    ('#2_body', (128, 190), (80, 60)),
    ('#2_ear', (128, 130), (95, 60)),
    ('#3_face', (128, 100), (70, 80)),
    ('#4_eye', (128, 108), (55, 30)),
    ('#4_mouth', (128, 155), (25, 15)),
    ('#4_nose', (128, 133), (8, 15)),
    ('#5_hair_front', (128, 85), (80, 60)),
    ('#6_brow', (128, 85), (50, 12)),
)
WRITE_THREADS = 8


def _ellipse(center, radius, color, jitter) -> np.ndarray:
    """An anti-aliased ellipse of one colour: ``[256, 256, 4]`` uint8."""
    axis = np.arange(SIZE, dtype=np.float32)
    rx = max(radius[0] * jitter[2], 3)
    ry = max(radius[1] * jitter[3], 3)
    d = (((axis - (center[1] + jitter[1])) / ry) ** 2)[:, None] \
        + (((axis - (center[0] + jitter[0])) / rx) ** 2)[None, :]
    img = np.empty((SIZE, SIZE, 4), np.uint8)
    img[..., :3] = (np.asarray(color, np.float32) * 255).astype(np.uint8)
    img[..., 3] = (np.clip((1.0 - d) * 4.0, 0.0, 1.0) * 255).astype(np.uint8)
    return img


def draw_sample(rng: np.random.RandomState, layers: int = len(LAYERS)):
    """One sample's random numbers: per layer its colour and its jitter
    (dx, dy in ±8 px, the radii's scales in [0.7, 1)), and a background."""
    params = []
    for _ in range(layers):
        color = rng.uniform(0.1, 1.0, size=3)
        jitter = (rng.uniform(-8, 8), rng.uniform(-8, 8),
                  rng.uniform(0.7, 1.0), rng.uniform(0.7, 1.0))
        params.append((color, jitter))
    return params, rng.uniform(0.0, 1.0, size=3)


def sample_layers(params) -> np.ndarray:
    """A sample's layers: ``[layers, 256, 256, 4]`` uint8 RGBA, the first
    of ``LAYERS``."""
    out = np.empty((len(params), SIZE, SIZE, 4), np.uint8)
    for i, ((_, center, radius), (color, jitter)) in enumerate(
            zip(LAYERS, params)):
        out[i] = _ellipse(center, radius, color, jitter)
    return out


def composite_rgb(layers: np.ndarray, background) -> np.ndarray:
    """The layers over an opaque background: ``[256, 256, 3]`` uint8."""
    canvas = np.empty((SIZE, SIZE, 3), np.float32)
    canvas[...] = np.asarray(background, np.float32)
    for layer in layers.astype(np.float32) * np.float32(1 / 255.0):
        canvas += (layer[..., :3] - canvas) * layer[..., 3:]
    return np.round(canvas * np.float32(255.0)).astype(np.uint8)


def encode_png(img: np.ndarray) -> bytes:
    """8-bit RGB or RGBA ``[H, W, C]`` as a PNG, filter 0 on every row."""
    h, w, c = img.shape
    color_type = {3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(img).reshape(h, w * c)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))
    header = struct.pack('>IIBBBBB', w, h, 8, color_type, 0, 0, 0)
    return (b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', header)
            + chunk(b'IDAT', zlib.compress(raw.tobytes(), 6))
            + chunk(b'IEND', b''))


def decode_png(data: bytes) -> np.ndarray:
    """A PNG that ``encode_png`` wrote, as ``[H, W, C]`` uint8."""
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise ValueError('not a PNG')
    pos, idat, shape = 8, [], None
    while pos < len(data):
        n = struct.unpack('>I', data[pos:pos + 4])[0]
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b'IHDR':
            w, h, depth, ctype = struct.unpack('>IIBB', body[:10])
            if depth != 8 or ctype not in (2, 6):
                raise ValueError('only 8-bit RGB or RGBA')
            shape = (h, w, 3 if ctype == 2 else 4)
        elif kind == b'IDAT':
            idat.append(body)
        pos += 12 + n
    h, w, c = shape
    rows = np.frombuffer(zlib.decompress(b''.join(idat)),
                         np.uint8).reshape(h, 1 + w * c)
    if rows[:, 0].any():
        raise ValueError('a row filter other than 0')
    return rows[:, 1:].reshape(h, w, c).copy()


def write_dataset(path: str, kind: str, samples: int, seed: int,
                  layers: int = len(LAYERS)) -> List[str]:
    """Write the mix's ``samples`` samples under ``path`` (of ``layers``
    layers each: an ``images`` sample composites them); returns the sample
    paths in the dataset's order (directories for ``layers``, files for
    ``images``).  The random numbers are drawn in order first, the pictures
    made and written on threads."""
    if kind not in ('layers', 'images'):
        raise ValueError(f'unknown traffic kind {kind!r}')
    rng = np.random.RandomState(seed % 2**32)
    draws = [draw_sample(rng, layers) for _ in range(samples)]
    os.makedirs(path, exist_ok=True)
    if kind == 'layers':
        items = [os.path.join(path, f'{n:05d}') for n in range(samples)]
    else:
        items = [os.path.join(path, f'img{n:05d}.png')
                 for n in range(samples)]

    def write(n):
        params, background = draws[n]
        layers_u8 = sample_layers(params)
        if kind == 'images':
            with open(items[n], 'wb') as fh:
                fh.write(encode_png(composite_rgb(layers_u8, background)))
            return
        os.makedirs(items[n], exist_ok=True)
        for (name, _, _), layer in zip(LAYERS, layers_u8):
            with open(os.path.join(items[n], f'{name}.png'), 'wb') as fh:
                fh.write(encode_png(layer))
    with ThreadPoolExecutor(WRITE_THREADS) as pool:
        list(pool.map(write, range(samples)))
    return items


def read_item(item: str, kind: str) -> np.ndarray:
    """A sample as the reference reads it: ``[L, H, W, 4]`` (layers) or
    ``[H, W, 3]`` (images) uint8."""
    if kind == 'layers':
        return np.stack([decode_png(open(os.path.join(item, f), 'rb').read())
                         for f in sorted(os.listdir(item))])
    return decode_png(open(item, 'rb').read())


def layer_stat(cfg_model: dict, samples: int) -> dict:
    """``DatasetAIO``'s statistics of a ``layers`` mix, from the
    configuration (the crops are the configuration's, not measured)."""
    names = [name for name, _, _ in LAYERS][:len(cfg_model['layer_names'])]
    stats = {n: {'target_width': int(t[1]), 'target_height': int(t[0])}
             for n, t in zip(names, cfg_model['layer_targets'])}
    return {'layer_names': names, 'layer_stats': stats,
            'shape': [samples, len(names), SIZE, SIZE, 4],
            'conv_config_index': cfg_model['conv_config_index']}


def sample_order(samples: int, seed: int, count: int) -> Sequence[int]:
    """The first ``count`` indices of the sampler's stream, as the
    reference works them out (its copy of ``InfiniteSampler``)."""
    from .reference.sampler import InfiniteSampler
    it = iter(InfiniteSampler(samples, seed=seed))
    return [next(it) for _ in range(count)]
