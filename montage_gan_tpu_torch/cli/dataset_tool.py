"""Offline dataset converter.

Port of ``montage_gan_tpu/cli/dataset_tool.py`` (the reference's
dataset_tool.py:57-334), with ``argparse`` in place of click and without
PIL:

    python -m montage_gan_tpu_torch.cli.dataset_tool --source SRC \\
        --dest OUT[.zip] [--source-type auto] [--transform center-crop] \\
        [--width W --height H] [--max-images N]

Sources: an image folder or zip (PNGs, read by ``utils/png.py``: a JPEG
raises with its name), CIFAR-10 (the Python pickles ``data_batch_1..5``),
MNIST (gzip idx files), an LMDB archive (``data/lmdb_reader.py``) and
``layers`` (a directory of layer directories, copied and given its
statistics cache by ``DatasetAIO``).  The transforms ``center-crop`` and
``center-crop-wide`` and the resize to ``--width``/``--height`` use PIL's
LANCZOS bit for bit (``utils/image_utils.py``).  Output: PNGs named
``img{n:08d}.png`` in a folder or a zip, in the source's channels (grey,
RGB or RGBA), and ``dataset.json`` with ``{"labels": [[name, label], ...]
| null}``.  An LMDB value that is not a PNG is skipped, as the JAX tool
skips a value PIL cannot open; the count of skipped values is printed.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import pickle
import shutil
import struct
import zipfile
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from ..utils.image_utils import resize_lanczos, resize_lanczos_rgba
from ..utils.png import decode_png, encode_png

SOURCE_TYPES = ('auto', 'folder', 'zip', 'cifar10', 'mnist', 'lmdb',
                'layers')
IMAGE_EXTENSIONS = ('.png', '.jpg', '.jpeg')

Item = Tuple[np.ndarray, object]


def _labels_of(meta: Optional[bytes]) -> dict:
    if meta is None:
        return {}
    return dict(json.loads(meta).get('labels') or [])


def _iter_folder(src: str) -> Iterator[Item]:
    files = sorted(os.path.join(r, f) for r, _, fs in os.walk(src) for f in fs
                   if f.lower().endswith(IMAGE_EXTENSIONS))
    meta = os.path.join(src, 'dataset.json')
    labels = {}
    if os.path.exists(meta):
        with open(meta, 'rb') as f:
            labels = _labels_of(f.read())
    for fp in files:
        rel = os.path.relpath(fp, src).replace('\\', '/')
        with open(fp, 'rb') as f:
            yield decode_png(f.read(), fp), labels.get(rel)


def _iter_zip(src: str) -> Iterator[Item]:
    with zipfile.ZipFile(src) as z:
        names = z.namelist()
        labels = _labels_of(z.read('dataset.json')
                            if 'dataset.json' in names else None)
        for name in sorted(names):
            if name.lower().endswith(IMAGE_EXTENSIONS):
                yield decode_png(z.read(name), f'{src}:{name}'), \
                    labels.get(name)


def _iter_cifar10(src: str) -> Iterator[Item]:
    for batch in range(1, 6):
        with open(os.path.join(src, f'data_batch_{batch}'), 'rb') as f:
            data = pickle.load(f, encoding='latin1')
        imgs = data['data'].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        for img, lab in zip(imgs, data['labels']):
            yield img, int(lab)


def _iter_mnist(src: str) -> Iterator[Item]:
    with gzip.open(os.path.join(src, 'train-images-idx3-ubyte.gz')) as f:
        _, n, h, w = struct.unpack('>IIII', f.read(16))
        imgs = np.frombuffer(f.read(), np.uint8).reshape(n, h, w, 1)
    with gzip.open(os.path.join(src, 'train-labels-idx1-ubyte.gz')) as f:
        struct.unpack('>II', f.read(8))
        labels = np.frombuffer(f.read(), np.uint8)
    for img, lab in zip(imgs, labels):
        yield img, int(lab)


class _LMDBImages:
    """The values of an LMDB archive's main database, in key order, as RGB
    images (the JAX tool's ``convert('RGB')``: grey repeated, alpha
    dropped); ``skipped`` counts the values that are not PNGs."""

    def __init__(self, src: str):
        self.src = src
        self.skipped = 0

    def __iter__(self) -> Iterator[Item]:
        from ..data.lmdb_reader import LMDBReader
        with LMDBReader(self.src) as reader:
            for key, value in reader.items():
                try:
                    img = decode_png(value, f'{self.src}:{key!r}')
                except ValueError:
                    self.skipped += 1
                    continue
                if img.shape[2] == 1:
                    img = np.repeat(img, 3, axis=2)
                yield np.ascontiguousarray(img[..., :3]), None


def _resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's LANCZOS resize in the image's mode (L, RGB or RGBA)."""
    if img.shape[2] == 4:
        return resize_lanczos_rgba(img, width, height)
    return resize_lanczos(img, width, height)


def transform_image(img: np.ndarray, transform: Optional[str],
                    width: Optional[int], height: Optional[int]
                    ) -> np.ndarray:
    """The JAX tool's ``_transform``: ``center-crop`` crops the centred
    square; ``center-crop-wide`` resizes to ``width`` keeping the aspect
    and crops ``height`` centred rows; then a resize to ``width`` x
    ``height`` where the size differs."""
    if img.ndim == 2:
        img = img[:, :, None]
    if transform == 'center-crop':
        assert width and height
        s = min(img.shape[0], img.shape[1])
        y0 = (img.shape[0] - s) // 2
        x0 = (img.shape[1] - s) // 2
        img = img[y0:y0 + s, x0:x0 + s]
    elif transform == 'center-crop-wide':
        assert width and height
        ch = int(round(width * img.shape[0] / img.shape[1]))
        img = _resize(np.ascontiguousarray(img), width, ch)
        y0 = (img.shape[0] - height) // 2
        img = img[max(y0, 0):max(y0, 0) + height]
    if width and height and (img.shape[0] != height or img.shape[1] != width):
        img = _resize(np.ascontiguousarray(img), width, height)
    return np.ascontiguousarray(img)


def infer_source_type(source: str) -> str:
    if os.path.isdir(source):
        entries = os.listdir(source)
        if entries and all(os.path.isdir(os.path.join(source, e))
                           for e in entries[:8]):
            return 'layers'
        return 'folder'
    if source.endswith('.zip'):
        return 'zip'
    raise ValueError(f'cannot infer source type of {source}')


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='python -m montage_gan_tpu_torch.cli.dataset_tool',
        description='Convert a dataset into the canonical training layout.')
    add = p.add_argument
    add('--source', required=True, metavar='PATH')
    add('--dest', required=True, metavar='PATH',
        help='Output directory or .zip')
    add('--source-type', choices=SOURCE_TYPES, default='auto')
    add('--transform', choices=['center-crop', 'center-crop-wide'],
        default=None)
    add('--width', type=int, default=None)
    add('--height', type=int, default=None)
    add('--max-images', type=int, default=None)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Convert; returns the number of images written (of samples, for
    ``layers``)."""
    opts = make_parser().parse_args(argv)
    source, dest = opts.source, opts.dest
    source_type = opts.source_type
    if source_type == 'auto':
        source_type = infer_source_type(source)

    if source_type == 'layers':
        from ..data.dataset import DatasetAIO
        if os.path.abspath(source) != os.path.abspath(dest):
            shutil.copytree(source, dest, dirs_exist_ok=True)
        ds = DatasetAIO(dest, use_stat_cache=True)
        print(f'layers dataset: {len(ds)} samples, {ds.num_layers} layers, '
              f'targets {ds.layer_targets}')
        return len(ds)

    lmdb = None
    if source_type == 'lmdb':
        iterator = lmdb = _LMDBImages(source)
    else:
        iterator = {'folder': _iter_folder, 'zip': _iter_zip,
                    'cifar10': _iter_cifar10,
                    'mnist': _iter_mnist}[source_type](source)

    to_zip = dest.endswith('.zip')
    zf = zipfile.ZipFile(dest, 'w') if to_zip else None
    if not to_zip:
        os.makedirs(dest, exist_ok=True)
    labels = []
    count = 0
    try:
        for img, label in iterator:
            if opts.max_images is not None and count >= opts.max_images:
                break
            img = transform_image(img, opts.transform, opts.width,
                                  opts.height)
            name = f'img{count:08d}.png'
            data = encode_png(img)
            if to_zip:
                zf.writestr(name, data)
            else:
                with open(os.path.join(dest, name), 'wb') as f:
                    f.write(data)
            if label is not None:
                labels.append([name, label])
            count += 1
        meta = json.dumps({'labels': labels if labels else None})
        if to_zip:
            zf.writestr('dataset.json', meta)
        else:
            with open(os.path.join(dest, 'dataset.json'), 'w') as f:
                f.write(meta)
    finally:
        if zf is not None:
            zf.close()
    if lmdb is not None:
        print(f'skipped {lmdb.skipped} LMDB values that are not PNG images')
    print(f'wrote {count} images to {dest}')
    return count


if __name__ == '__main__':
    main()
