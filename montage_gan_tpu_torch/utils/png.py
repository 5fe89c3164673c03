"""PNG files without PIL: the writer of the port's images and the reader of
its training data.

The JAX package decodes layers with PIL (``Image.open(path).convert("RGBA")``)
or libpng; the card's machine has neither.  Here the chunks are parsed in
Python, the image data is inflated with the standard library's ``zlib``, and
the row filters are undone by ``native/png_unfilter.cpp``: PIL writes
adaptive filters, and Average and Paeth depend on the pixel to the left, so
a row cannot be undone by whole-array numpy operations.  The C++ source has
no dependencies; it is built with the host's C++ compiler at first use into
``montage_gan_tpu_torch/build/`` (a hash of the source in the file name) and
bound with ``ctypes``, which releases the GIL during the call, so several
threads decode at once.  A failed build raises; nothing falls back.
``unfilter_plain`` is the numpy version the tests hold the library to.

Supported: 8-bit RGBA (colour type 6), 8-bit RGB (colour type 2, alpha
255) and 8-bit grey (colour type 0: the value in R, G and B, as PIL's
``convert('RGB')`` repeats it), not interlaced.  Any other PNG (grey with
alpha, palette, 16-bit, interlaced, ``tRNS``) raises with its name, colour
type and bit depth (PIL would convert it).  ``decode_png`` gives an image in
its own channels (1, 3 or 4), as ``np.asarray(Image.open(f))`` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / 'native' / 'png_unfilter.cpp'
BUILD_DIR = PACKAGE_DIR / 'build'
CXX_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC')
SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {6: 4, 2: 3, 0: 1}      # colour type → channels stored
_BAD_LENGTH, _BAD_FILTER = 1, 16    # png_unfilter.cpp's return codes

_lock = threading.Lock()
_fn = None


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update(' '.join(CXX_FLAGS).encode())
    return BUILD_DIR / f'libpng_unfilter-{digest.hexdigest()[:12]}.so'


def _compiler() -> str:
    for c in (os.environ.get('CXX'), 'g++', 'c++'):
        if c and shutil.which(c):
            return shutil.which(c)
    raise RuntimeError('no C++ compiler found (set CXX): the PNG reader '
                       f'builds {SOURCE.name} at first use')


def build() -> Path:
    """The unfilter library, compiled if it is not built yet.  Raises with
    the compiler's output if the build fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
    proc = subprocess.run([_compiler(), *CXX_FLAGS, '-o', str(tmp),
                           str(SOURCE)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'building {SOURCE.name} failed (exit '
                           f'{proc.returncode}):\n{proc.stdout}')
    os.replace(tmp, path)
    return path


def _unfilter_fn():
    global _fn
    with _lock:
        if _fn is None:
            fn = ctypes.CDLL(str(build())).mgt_png_unfilter
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int]
            fn.restype = ctypes.c_int
            _fn = fn
    return _fn


def parse(data: bytes, name: str = '<bytes>'):
    """A PNG file's bytes → (height, width, channels, inflated image data).
    Raises on a file the reader does not support."""
    if data[:8] != SIGNATURE:
        raise ValueError(f'{name}: not a PNG file')
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif tag == b'IDAT':
            idat.append(body)
        elif tag == b'tRNS':
            raise ValueError(f'{name}: PNG transparency chunks (tRNS) are '
                             'not supported')
        elif tag == b'IEND':
            break
    if header is None:
        raise ValueError(f'{name}: PNG without an IHDR chunk')
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f'{name}: unsupported PNG (colour type {colour}, bit depth '
            f'{depth}, interlace {interlace}); the reader takes 8-bit RGBA '
            '(colour type 6), RGB (colour type 2) and grey (colour type 0), '
            'not interlaced')
    return height, width, _CHANNELS[colour], zlib.decompress(b''.join(idat))


def _decode(data: bytes, name: str, out: Optional[np.ndarray] = None):
    """(``[H, W, 4]`` RGBA uint8, channels stored) of a PNG's bytes, written
    into ``out`` when given."""
    height, width, channels, raw = parse(data, name)
    if out is None:
        out = np.empty((height, width, 4), np.uint8)
    elif (out.shape != (height, width, 4) or out.dtype != np.uint8
          or not out.flags.c_contiguous):
        raise ValueError(f'{name}: a {height}x{width} image does not fit '
                         f'an output of shape {out.shape} ({out.dtype})')
    rc = _unfilter_fn()(raw, len(raw), out.ctypes.data, height, width,
                        channels)
    if rc == _BAD_LENGTH:
        raise ValueError(f'{name}: image data of {len(raw)} bytes, not '
                         f'{height * (width * channels + 1)}')
    if rc != 0:
        raise ValueError(f'{name}: unknown filter type in row '
                         f'{rc - _BAD_FILTER}')
    return out, channels


def read_png_rgba(path: str, out: Optional[np.ndarray] = None) -> np.ndarray:
    """An 8-bit RGBA, RGB or grey PNG as ``[H, W, 4]`` uint8 (RGB and grey
    get alpha 255), written into ``out`` (C-contiguous uint8 of that shape)
    when given."""
    with open(path, 'rb') as f:
        return _decode(f.read(), path, out)[0]


def decode_png(data: bytes, name: str = '<bytes>') -> np.ndarray:
    """A PNG's bytes as ``[H, W, C]`` uint8 in the channels it stores: 4
    (RGBA), 3 (RGB) or 1 (grey)."""
    rgba, channels = _decode(data, name)
    return rgba if channels == 4 else np.ascontiguousarray(
        rgba[..., :channels])


def unfilter_plain(raw: bytes, height: int, width: int,
                   channels: int) -> np.ndarray:
    """numpy version of ``png_unfilter.cpp`` (for the tests): inflated image
    data → ``[H, W, 4]`` uint8."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, width * channels + 1)
    prev = np.zeros(width * channels, np.int64)
    out = np.empty((height, width * channels), np.uint8)
    for y in range(height):
        filt, line = rows[y, 0], rows[y, 1:].astype(np.int64)
        cur = np.zeros_like(line)
        if filt == 0:
            cur = line
        elif filt == 2:
            cur = (line + prev) % 256
        elif filt in (1, 3, 4):
            for i in range(line.size):
                a = cur[i - channels] if i >= channels else 0
                c = prev[i - channels] if i >= channels else 0
                b = prev[i]
                if filt == 1:
                    pred = a
                elif filt == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (line[i] + pred) % 256
        else:
            raise ValueError(f'unknown filter type {filt} in row {y}')
        out[y] = cur
        prev = cur
    img = out.reshape(height, width, channels)
    if channels == 1:
        img = np.repeat(img, 3, axis=2)
    if channels in (1, 3):
        img = np.concatenate([img, np.full((height, width, 1), 255,
                                           np.uint8)], axis=2)
    return img


def filter_rows(u8: np.ndarray) -> np.ndarray:
    """``[H, W, C]`` uint8 → PNG image data before deflate: each row
    prefixed by its filter type, the filter chosen per row as libpng and PIL
    choose it (the least sum of the filtered bytes read as signed), so a
    file holds None, Sub, Up, Average and Paeth rows as PIL's do."""
    h, w, c = u8.shape
    x = u8.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(x)                  # left
    a[:, c:] = x[:, :-c]
    b = np.zeros_like(x)                  # above
    b[1:] = x[:-1]
    cc = np.zeros_like(x)                 # above left
    cc[1:, c:] = x[:-1, :-c]
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    cands = np.stack([x, x - a, x - b, x - (a + b) // 2, x - paeth]) & 0xff
    cost = np.minimum(cands, 256 - cands).sum(axis=2)       # [5, H]
    best = cost.argmin(axis=0)
    rows = cands[best, np.arange(h)].astype(np.uint8)
    return np.concatenate([best.astype(np.uint8)[:, None], rows], axis=1)


def write_png(path: str, u8: np.ndarray) -> None:
    """Write an ``[H, W, C]`` uint8 array (C = 1 grey, 3 RGB, 4 RGBA) as an
    8-bit PNG with adaptive row filters (``filter_rows``)."""
    with open(path, 'wb') as f:
        f.write(encode_png(u8))


def encode_png(u8: np.ndarray) -> bytes:
    """The bytes of ``write_png``'s file."""
    if u8.ndim == 2:
        u8 = u8[..., None]
    h, w, c = u8.shape
    colour = {1: 0, 3: 2, 4: 6}[c]
    if u8.dtype != np.uint8:
        raise ValueError(f'write_png takes uint8, not {u8.dtype}')
    raw = filter_rows(np.ascontiguousarray(u8)).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack('>I', len(data)) + tag + data
                + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))

    header = struct.pack('>IIBBBBB', w, h, 8, colour, 0, 0, 0)
    return (SIGNATURE + chunk(b'IHDR', header)
            + chunk(b'IDAT', zlib.compress(raw, 6)) + chunk(b'IEND', b''))


def write_png_rgba(path: str, u8: np.ndarray) -> None:
    """Write an ``[H, W, 4]`` uint8 array as an 8-bit RGBA PNG."""
    if u8.ndim != 3 or u8.shape[2] != 4:
        raise ValueError(f'write_png_rgba takes [H, W, 4], not {u8.shape}')
    write_png(path, u8)
