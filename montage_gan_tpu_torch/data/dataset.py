"""The multi-layer RGBA dataset of the all-in-one trainer.

Port of ``dataset_stat`` and ``DatasetAIO`` (``montage_gan_tpu/data/
dataset.py:35-190``; the reference's custom/dataset_aio.py:88-254).  Layout:
one directory per sample holding L layer PNGs, sorted by name.  Per-layer
statistics (nonzero-alpha bounding boxes → target resolutions) are computed
once and cached as ``montage_stats.json`` next to the data, the same file and
JSON as the JAX package's.  Layers are read by ``utils/png.py`` (8-bit RGBA,
RGB or grey PNGs; PIL is not needed).

``ImageFolderDataset`` is the single-GAN ``train``'s flat dataset (port of
``montage_gan_tpu/data/dataset.py:193-289``): PNGs in a folder or a
``.zip``, with labels from ``dataset.json``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.calc_res import (calc_init_res, calc_res, calc_res_combination,
                              find_min_res_combination)
from ..utils.png import decode_png, read_png_rgba

STAT_CACHE_NAME = "montage_stats.json"


def dataset_stat(src: str, conv_config_index: int = 2) -> Dict:
    """Per-layer bounding-box statistics → target resolutions
    (reference contract: custom/dataset_aio.py:88-140)."""
    combos = calc_res_combination(conv_config_index)
    boxes: Dict[str, List[Tuple[int, int, int, int]]] = {}
    img_shape = None
    dirs = sorted(os.listdir(src))
    for d in dirs:
        dpath = os.path.join(src, d)
        if not os.path.isdir(dpath):
            continue
        for f in sorted(os.listdir(dpath)):
            layer_name = os.path.splitext(f)[0]
            img = read_png_rgba(os.path.join(dpath, f))
            if img_shape is None:
                img_shape = (img.shape[0], img.shape[1], img.shape[2])
            ys, xs = np.nonzero(img[..., 3])
            if len(ys) == 0:
                continue
            # (x, y, w, h) like cv2.boundingRect
            boxes.setdefault(layer_name, []).append(
                (int(xs.min()), int(ys.min()),
                 int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)))

    layer_stats = {}
    for name, bs in boxes.items():
        arr = np.asarray(bs, dtype=np.float64)
        max_w, max_h = arr[:, 2].max(), arr[:, 3].max()
        center = arr[:, :2] + arr[:, 2:] / 2
        avg_center = center.mean(axis=0)
        max_center_diff = np.abs(center - avg_center).max(axis=0)
        target = find_min_res_combination((max_w, max_h), combos,
                                          conv_config_index)
        layer_stats[name] = {
            "required_width": int(max_w), "required_height": int(max_h),
            "target_width": int(target[0]), "target_height": int(target[1]),
            "avg_center": avg_center.tolist(),
            "max_center_diff": max_center_diff.tolist(),
        }
    names = sorted(layer_stats.keys())
    n_samples = sum(os.path.isdir(os.path.join(src, d)) for d in dirs)
    return {
        "layer_names": names,
        "layer_stats": layer_stats,
        "shape": [n_samples, len(names), img_shape[0], img_shape[1],
                  img_shape[2]],
        "conv_config_index": conv_config_index,
    }


class DatasetAIO:
    """Directory-of-directories multi-layer RGBA dataset
    (reference contract: custom/dataset_aio.py:143-254).  ``xflip`` doubles
    the index range with mirrored copies."""

    def __init__(self, path: str, xflip: bool = False,
                 conv_config_index: int = 2,
                 stat: Optional[Dict] = None,
                 use_stat_cache: bool = True):
        self.path = path
        self.conv_config_index = conv_config_index
        self.name = os.path.basename(os.path.normpath(path)) or "dataset"

        cache_path = os.path.join(path, STAT_CACHE_NAME)
        if stat is not None:
            self._stat = stat
        elif use_stat_cache and os.path.exists(cache_path):
            with open(cache_path) as f:
                self._stat = json.load(f)
            if self._stat.get("conv_config_index") != conv_config_index:
                self._stat = dataset_stat(path, conv_config_index)
        else:
            self._stat = dataset_stat(path, conv_config_index)
            if use_stat_cache:
                try:
                    with open(cache_path, "w") as f:
                        json.dump(self._stat, f, indent=2)
                except OSError:
                    pass

        self.layer_names: List[str] = list(self._stat["layer_names"])
        self.layer_stats = self._stat["layer_stats"]
        self._raw_shape = list(self._stat["shape"])  # [N, L, H, W, C]
        self._dirs = sorted(d for d in os.listdir(path)
                            if os.path.isdir(os.path.join(path, d)))
        self._paths: Optional[List[List[str]]] = None

        n = len(self._dirs)
        self.raw_idx = np.arange(n, dtype=np.int64)
        self.is_xflip = np.zeros(n, dtype=np.uint8)
        if xflip:
            self.raw_idx = np.tile(self.raw_idx, 2)
            self.is_xflip = np.concatenate([self.is_xflip,
                                            np.ones(n, dtype=np.uint8)])

    # -- geometry --------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return self._raw_shape[1]

    @property
    def num_channels(self) -> int:
        return self._raw_shape[4]

    @property
    def resolution(self) -> int:
        return calc_res(self._raw_shape[2:4])

    @property
    def init_res(self) -> List[int]:
        return calc_init_res(self._raw_shape[2:4],
                             conv_config_index=self.conv_config_index)[0]

    def _layer_size(self, layer_name: str) -> List[int]:
        s = self.layer_stats[layer_name]
        return [s["target_height"], s["target_width"]]

    def target_res_layer(self, layer_name: str) -> List[int]:
        return self._layer_size(layer_name)

    def init_res_layer(self, layer_name: str) -> List[int]:
        return calc_init_res(self._layer_size(layer_name),
                             conv_config_index=self.conv_config_index)[0]

    def resolution_layer(self, layer_name: str) -> int:
        return calc_res(self._layer_size(layer_name))

    def res_log2_layer(self, layer_name: str) -> int:
        return calc_init_res(self._layer_size(layer_name),
                             conv_config_index=self.conv_config_index)[2]

    @property
    def layer_targets(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(tuple(self._layer_size(n)) for n in self.layer_names)

    def item_paths(self) -> List[List[str]]:
        """Per-raw-item sorted layer PNG paths (listed once)."""
        if self._paths is None:
            out = []
            for d in self._dirs:
                dp = os.path.join(self.path, d)
                out.append([os.path.join(dp, f)
                            for f in sorted(os.listdir(dp))])
            self._paths = out
        return self._paths

    @property
    def image_shape(self) -> Tuple[int, int]:
        return self._raw_shape[2], self._raw_shape[3]

    # -- access ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.raw_idx)

    def load_u8(self, index: int, out: Optional[np.ndarray] = None
                ) -> np.ndarray:
        """Item ``index`` as ``[L, H, W, 4]`` uint8 (written into ``out``
        when given); xflip flips W."""
        paths = self.item_paths()[self.raw_idx[index]]
        h, w = self.image_shape
        if out is None:
            out = np.empty((len(paths), h, w, 4), np.uint8)
        if out.shape[0] != len(paths):
            raise ValueError(f'{os.path.dirname(paths[0])}: {len(paths)} '
                             f'layers, not {out.shape[0]}')
        for layer, p in enumerate(paths):
            read_png_rgba(p, out=out[layer])
        if self.is_xflip[index]:
            out[:] = out[:, :, ::-1].copy()
        return out

    def __getitem__(self, index: int) -> np.ndarray:
        """[L, H, W, 4] float32 in [0, 1]; xflip flips W."""
        return self.load_u8(index).astype(np.float32) / np.float32(255.0)


class ImageFolderDataset:
    """A folder (searched recursively) or a ``.zip`` of images, sorted by
    name, with optional labels (``dataset.json``: ``{"labels": [[name,
    label], ...]}``; integer labels become one-hot, vectors are taken as
    they are).  An item is ``(image, label)``: ``[H, W, C]`` uint8, RGBA
    where the file is RGBA and RGB otherwise (a grey file's value repeated,
    as PIL's ``convert('RGB')``), and the float32 label (``[0]`` without
    labels).  ``max_size`` keeps a ``RandomState(random_seed)`` choice of
    the files, in order; ``xflip`` doubles the items with mirrored copies.
    Files are decoded by ``utils/png.py``: a JPEG, or a PNG form it does not
    read, raises with the file's name."""

    EXTENSIONS = ('.png', '.jpg', '.jpeg')

    def __init__(self, path: str, resolution: Optional[int] = None,
                 use_labels: bool = False, xflip: bool = False,
                 max_size: Optional[int] = None, random_seed: int = 0,
                 **_ignored):
        self.path = path
        self.name = os.path.splitext(os.path.basename(path))[0]
        self._zip = None
        if os.path.isdir(path):
            self._files = sorted(
                os.path.join(root, f)
                for root, _, files in os.walk(path) for f in files
                if f.lower().endswith(self.EXTENSIONS))
        elif path.lower().endswith('.zip'):
            import zipfile
            self._zip = zipfile.ZipFile(path)
            self._files = sorted(n for n in self._zip.namelist()
                                 if n.lower().endswith(self.EXTENSIONS))
        else:
            raise IOError(f'unsupported dataset path {path}')
        if not self._files:
            raise IOError(f'no images in {path}')

        self._labels = self._load_labels() if use_labels else None
        probe = self._load_image(0)
        self.resolution = resolution or probe.shape[0]
        self.image_shape = tuple(probe.shape)
        self.num_channels = probe.shape[2]
        self.label_dim = (self._labels.shape[1]
                          if self._labels is not None else 0)

        n = len(self._files)
        self.raw_idx = np.arange(n, dtype=np.int64)
        if max_size is not None and n > max_size:
            rnd = np.random.RandomState(random_seed)
            self.raw_idx = np.sort(rnd.choice(n, size=max_size,
                                              replace=False))
        self.is_xflip = np.zeros(self.raw_idx.size, dtype=np.uint8)
        if xflip:
            self.raw_idx = np.tile(self.raw_idx, 2)
            self.is_xflip = np.concatenate([self.is_xflip,
                                            np.ones_like(self.is_xflip)])

    def __getstate__(self):
        # a ZipFile does not pickle (the ranks of ``train --gpus N``):
        # each process opens the archive again
        state = dict(self.__dict__)
        state['_zip'] = None if self._zip is None else True
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if self._zip is not None:
            import zipfile
            self._zip = zipfile.ZipFile(self.path)

    def _name(self, i: int) -> str:
        """File ``i``'s name in ``dataset.json``: its path relative to the
        folder, or its name in the zip."""
        if self._zip is not None:
            return self._files[i]
        return os.path.relpath(self._files[i], self.path).replace('\\', '/')

    def _load_labels(self) -> Optional[np.ndarray]:
        data = None
        if self._zip is not None:
            if 'dataset.json' in self._zip.namelist():
                data = json.loads(self._zip.read('dataset.json'))
        else:
            p = os.path.join(self.path, 'dataset.json')
            if os.path.exists(p):
                with open(p) as f:
                    data = json.load(f)
        if data is None or data.get('labels') is None:
            return None
        lookup = {k: v for k, v in data['labels']}
        labels = np.asarray([lookup[self._name(i)]
                             for i in range(len(self._files))])
        if labels.ndim == 1:
            onehot = np.zeros((labels.size, labels.max() + 1), np.float32)
            onehot[np.arange(labels.size), labels] = 1
            return onehot
        return labels.astype(np.float32)

    def _load_image(self, i: int) -> np.ndarray:
        """File ``i`` as ``[H, W, 3|4]`` uint8."""
        if self._zip is not None:
            data, name = self._zip.read(self._files[i]), \
                f'{self.path}:{self._files[i]}'
        else:
            name = self._files[i]
            with open(name, 'rb') as f:
                data = f.read()
        img = decode_png(data, name)
        if img.shape[2] == 1:
            img = np.repeat(img, 3, axis=2)
        return img

    def item_paths(self) -> List[str]:
        """The files, sorted (listed when the dataset was made)."""
        return list(self._files)

    @property
    def has_labels(self) -> bool:
        return self._labels is not None

    def get_label(self, index: int) -> np.ndarray:
        if self._labels is None:
            return np.zeros([0], np.float32)
        return self._labels[self.raw_idx[index]]

    def __len__(self) -> int:
        return len(self.raw_idx)

    def load_u8(self, index: int, out: Optional[np.ndarray] = None
                ) -> np.ndarray:
        """Item ``index``'s image, ``[H, W, C]`` uint8 (written into ``out``
        when given); xflip flips W."""
        img = self._load_image(self.raw_idx[index])
        if self.is_xflip[index]:
            img = img[:, ::-1]
        if out is None:
            return np.ascontiguousarray(img)
        if out.shape != img.shape:
            raise ValueError(f'{self._files[self.raw_idx[index]]}: an image '
                             f'of shape {img.shape}, not {out.shape}')
        out[...] = img
        return out

    def __getitem__(self, index: int):
        return self.load_u8(index), self.get_label(index)
