"""The port's data path against the JAX package's, on the CPU: the PNG reader
(its C++ unfilter and its numpy version) against PIL, the layer dataset and
its stats cache, the infinite sampler, the loop's prefetcher, and the
host-side utilities the loop uses (resolution algebra, STN depth, the numpy
composite, image grids).

PNGs come from PIL (the JAX package's ``make_synthetic_layer_dataset``,
which writes adaptive filters) and from an encoder here that forces one row
filter (0-4) on every row.  Everything is compared bit for bit.
"""

import importlib
import json
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from montage_gan_tpu.data import dataset as jdataset
from montage_gan_tpu.data import sampler as jsampler
from montage_gan_tpu.data.synthetic import \
    make_synthetic_layer_dataset as jax_make_dataset
from montage_gan_tpu.models.stn import auto_stn_stages as jax_auto_stn_stages
from montage_gan_tpu.training.loop_aio import BatchPrefetcher as JaxPrefetcher
from montage_gan_tpu.utils import grid as jgrid
from montage_gan_tpu.utils.image_utils import \
    alpha_composite_np as jax_composite
from montage_gan_tpu_torch.data import dataset as tdataset
from montage_gan_tpu_torch.data import sampler as tsampler
from montage_gan_tpu_torch.data.synthetic import \
    make_synthetic_layer_dataset as port_make_dataset
from montage_gan_tpu_torch.models.stn import auto_stn_stages
from montage_gan_tpu_torch.training import loop_aio
from montage_gan_tpu_torch.utils import calc_res as tcalc
from montage_gan_tpu_torch.utils import grid as tgrid
from montage_gan_tpu_torch.utils import png
from montage_gan_tpu_torch.utils.image_utils import alpha_composite_np

import chip_smoke

jcalc = importlib.import_module('montage_gan_tpu.utils.calc_res')
SPEC = (('#1_a', (8, 7), (5, 6)), ('#2_b', (8, 10), (6, 4)),
        ('#3_c', (16, 20), (9, 5)))


@pytest.fixture(scope='module')
def pil_dataset(tmp_path_factory):
    """A layer dataset written by PIL (the JAX package's writer), 32 px."""
    path = str(tmp_path_factory.mktemp('ds') / 'layers')
    jax_make_dataset(path, num_samples=6, size=32, spec=SPEC, seed=3)
    return path


# ---------------------------------------------------------------------------
# The PNG reader
# ---------------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def encode_png(path, img, filt, colour):
    """``img`` [H, W, C] uint8 as a PNG with filter ``filt`` on every row."""
    h, w, c = img.shape
    bpp = c
    rows = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for y in range(h):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        out.append(filt)
        for i in range(w * c):
            a = int(cur[i - bpp]) if i >= bpp else 0
            b = int(prev[i])
            cc = int(prev[i - bpp]) if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, cc))[filt]
            out.append((int(cur[i]) - pred) % 256)

    def chunk(tag, data):
        return (struct.pack('>I', len(data)) + tag + data
                + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))
    with open(path, 'wb') as f:
        f.write(png.SIGNATURE
                + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, colour,
                                             0, 0, 0))
                + chunk(b'IDAT', zlib.compress(bytes(out)))
                + chunk(b'IEND', b''))


def _both_readers(path):
    """(C++ reader, numpy reader) of one file, as uint8 RGBA."""
    with open(path, 'rb') as f:
        h, w, c, raw = png.parse(f.read(), path)
    return png.read_png_rgba(path), png.unfilter_plain(raw, h, w, c)


def test_png_reader_matches_pil_on_pil_files(pil_dataset):
    """Every layer PIL wrote (adaptive filters), through both readers, as
    the JAX dataset loads it (``_load_rgba``: PIL, RGBA, / 255)."""
    filters = set()
    for d in sorted(os.listdir(pil_dataset)):
        for f in sorted(os.listdir(os.path.join(pil_dataset, d))):
            path = os.path.join(pil_dataset, d, f)
            ref = jdataset._load_rgba(path)
            native, plain = _both_readers(path)
            np.testing.assert_array_equal(native, plain)
            np.testing.assert_array_equal(
                native.astype(np.float32) / np.float32(255.0), ref)
            with open(path, 'rb') as fh:
                h, w, c, raw = png.parse(fh.read())
            filters |= set(np.frombuffer(raw, np.uint8)[::w * c + 1])
    assert len(filters) > 1, filters      # PIL chose more than one filter


@pytest.mark.parametrize('colour', [6, 2], ids=['rgba', 'rgb'])
@pytest.mark.parametrize('filt', range(5))
def test_png_reader_each_filter(filt, colour, tmp_path):
    rng = np.random.RandomState(filt)
    channels = 4 if colour == 6 else 3
    img = rng.randint(0, 256, (9, 13, channels)).astype(np.uint8)
    img[3:6] = img[2]                     # runs where Up and Paeth predict
    path = str(tmp_path / f'f{filt}.png')
    encode_png(path, img, filt, colour)
    ref = np.asarray(Image.open(path).convert('RGBA'))
    native, plain = _both_readers(path)
    np.testing.assert_array_equal(native, ref)
    np.testing.assert_array_equal(plain, ref)


UNSUPPORTED = {'grey16': ('I;16', {}, 'colour type 0, bit depth 16'),
               'palette': ('P', {}, 'colour type 3, bit depth 8'),
               'grey-alpha': ('LA', {}, 'colour type 4, bit depth 8'),
               'rgb-trns': ('RGB', {'transparency': (1, 2, 3)}, 'tRNS')}


@pytest.mark.parametrize('kind', sorted(UNSUPPORTED))
def test_png_reader_rejects_other_formats(kind, tmp_path):
    mode, kw, said = UNSUPPORTED[kind]
    arr = np.random.RandomState(0).randint(0, 200, (5, 7, 3)).astype(np.uint8)
    img = Image.fromarray(arr, 'RGB').convert(mode)
    path = str(tmp_path / f'{kind}.png')
    img.save(path, **kw)
    with pytest.raises(ValueError, match=said) as e:
        png.read_png_rgba(path)
    assert path in str(e.value)


def test_png_reader_reads_grey_as_pil(tmp_path):
    """8-bit grey (colour type 0): the value in R, G and B with alpha 255,
    as PIL's ``convert('RGBA')``; ``decode_png`` keeps its one channel."""
    arr = np.random.RandomState(0).randint(0, 256, (9, 7)).astype(np.uint8)
    path = str(tmp_path / 'grey.png')
    Image.fromarray(arr, 'L').save(path)
    native, plain = _both_readers(path)
    ref = np.asarray(Image.open(path).convert('RGBA'))
    np.testing.assert_array_equal(native, ref)
    np.testing.assert_array_equal(plain, ref)
    with open(path, 'rb') as f:
        np.testing.assert_array_equal(png.decode_png(f.read()), arr[..., None])


def test_png_reader_rejects_bad_filter_and_length(tmp_path):
    path = str(tmp_path / 'bad.png')
    img = np.zeros((4, 3, 4), np.uint8)
    encode_png(path, img, 0, 6)
    with open(path, 'rb') as f:
        h, w, c, raw = png.parse(f.read())
    raw = bytearray(raw)
    raw[2 * (w * c + 1)] = 7              # row 2: no such filter
    out = np.empty((h, w, 4), np.uint8)
    fn = png._unfilter_fn()
    assert fn(bytes(raw), len(raw), out.ctypes.data, h, w, c) == \
        png._BAD_FILTER + 2
    assert fn(bytes(raw[:-1]), len(raw) - 1, out.ctypes.data, h, w, c) == \
        png._BAD_LENGTH
    with pytest.raises(ValueError, match='does not fit'):
        png.read_png_rgba(path, out=np.empty((h, w + 1, 4), np.uint8))


# ---------------------------------------------------------------------------
# Dataset, writer, sampler, prefetcher
# ---------------------------------------------------------------------------

def _row_filter_types(path):
    with open(path, 'rb') as f:
        h, w, c, raw = png.parse(f.read(), path)
    return np.frombuffer(raw, np.uint8)[::w * c + 1]


def test_synthetic_writer_matches_jax(pil_dataset, tmp_path):
    """The port's writer gives PIL's pixels, layer for layer, and chooses
    PIL's row filters, row for row."""
    path = str(tmp_path / 'layers')
    port_make_dataset(path, num_samples=6, size=32, spec=SPEC, seed=3)
    assert sorted(os.listdir(path)) == sorted(os.listdir(pil_dataset))
    for d in sorted(os.listdir(path)):
        names = sorted(os.listdir(os.path.join(path, d)))
        assert names == sorted(os.listdir(os.path.join(pil_dataset, d)))
        for f in names:
            ours = np.asarray(Image.open(os.path.join(path, d, f)))
            np.testing.assert_array_equal(
                ours, np.asarray(Image.open(os.path.join(pil_dataset, d, f))))
            np.testing.assert_array_equal(
                _row_filter_types(os.path.join(path, d, f)),
                _row_filter_types(os.path.join(pil_dataset, d, f)))
    counts = chip_smoke.row_filters(path)
    assert counts == chip_smoke.row_filters(pil_dataset)
    assert counts['up'] and counts['paeth'], counts


@pytest.mark.parametrize('conv_config_index', [2, 3])
def test_dataset_aio_matches_jax(pil_dataset, tmp_path, conv_config_index):
    paths = {}
    for name in ('jax', 'port'):
        paths[name] = str(tmp_path / name / 'layers')
        shutil.copytree(pil_dataset, paths[name])
    ref = jdataset.DatasetAIO(paths['jax'], xflip=True,
                              conv_config_index=conv_config_index)
    ds = tdataset.DatasetAIO(paths['port'], xflip=True,
                             conv_config_index=conv_config_index)
    texts = [open(os.path.join(p, tdataset.STAT_CACHE_NAME)).read()
             for p in (paths['jax'], paths['port'])]
    assert texts[0] == texts[1]
    assert json.loads(texts[1])['conv_config_index'] == conv_config_index
    for attr in ('layer_names', 'layer_targets', 'resolution', 'init_res',
                 'num_layers', 'num_channels', 'image_shape', 'name'):
        assert getattr(ds, attr) == getattr(ref, attr), attr
    assert len(ds) == len(ref) == 12
    for i in range(len(ds)):
        a, b = ds[i], ref[i]
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ds[6], ds[0][:, :, ::-1])   # xflip
    # a second construction reads the cache
    again = tdataset.DatasetAIO(paths['port'],
                                conv_config_index=conv_config_index)
    assert again.layer_targets == ds.layer_targets and len(again) == 6


@pytest.mark.parametrize('size,rank,replicas,seed',
                         [(7, 0, 1, 0), (12, 1, 3, 5), (1, 0, 1, 2)])
def test_infinite_sampler_matches_jax(size, rank, replicas, seed):
    it = iter(tsampler.InfiniteSampler(size, rank, replicas, seed=seed))
    ref = iter(jsampler.InfiniteSampler(size, rank, replicas, seed=seed))
    assert [next(it) for _ in range(300)] == [next(ref) for _ in range(300)]


def test_prefetcher_matches_jax(pil_dataset):
    """The first 3 batches, through ``to_device``, equal the JAX
    prefetcher's (PIL decode) bit for bit."""
    ref_ds = jdataset.DatasetAIO(pil_dataset, xflip=True)
    ds = tdataset.DatasetAIO(pil_dataset, xflip=True)
    targets = ds.layer_targets
    ref = JaxPrefetcher(ref_ds, 4, targets, seed=7, use_native=False)
    ours = loop_aio.BatchPrefetcher(ds, 4, targets, seed=7)
    try:
        for _ in range(3):
            stack_ref, crops_ref = ref.next()
            batch = ours.next()
            assert batch[0].dtype == torch.uint8
            stack, crops = loop_aio.to_device(batch, loop_aio.U8_TO_MINUS11)
            np.testing.assert_array_equal(stack.numpy(), stack_ref)
            assert len(crops) == len(crops_ref) == len(targets)
            for c, r in zip(crops, crops_ref):
                np.testing.assert_array_equal(c.numpy(), r)
    finally:
        ref.stop()
        ours.stop()
    assert not ours.thread.is_alive()


def test_prefetcher_surfaces_a_failed_decode(pil_dataset, tmp_path):
    path = str(tmp_path / 'layers')
    shutil.copytree(pil_dataset, path)
    ds = tdataset.DatasetAIO(path)
    victim = ds.item_paths()[0][0]
    with open(victim, 'wb') as f:
        f.write(b'not a png')
    pf = loop_aio.BatchPrefetcher(ds, len(ds), ds.layer_targets)
    try:
        for _ in range(2):                 # and again: no hang
            with pytest.raises(RuntimeError, match='worker failed'):
                pf.next()
    finally:
        pf.stop()


# ---------------------------------------------------------------------------
# Host-side utilities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('cci', [2, 3])
def test_calc_res_combinations_match_jax(cci):
    combos = tcalc.calc_res_combination(cci)
    assert combos == jcalc.calc_res_combination(cci)
    for shape in [(1, 1), (31, 200), (64, 96), (150, 33), (256, 256),
                  (257, 3)]:
        assert tcalc.find_min_res_combination(shape, combos, cci) == \
            jcalc.find_min_res_combination(shape, combos, cci)
    assert tcalc.find_min_res_combination((40, 40), conv_config_index=cci) \
        == jcalc.find_min_res_combination((40, 40), conv_config_index=cci)


def test_auto_stn_stages_and_composite_match_jax():
    for res in (4, 8, 16, 24, 32, 64, 100, 256, 1024):
        for stages in (5, 3):
            assert auto_stn_stages(res, stages) == \
                jax_auto_stn_stages(res, stages)
    rng = np.random.RandomState(1)
    layers = rng.uniform(0, 1, (2, 3, 5, 6, 4)).astype(np.float32)
    layers[0, :, 0, 0, 3] = 0             # alpha 0 everywhere at a pixel
    np.testing.assert_array_equal(alpha_composite_np(layers),
                                  jax_composite(layers))


@pytest.mark.parametrize('channels', [4, 3, 1])
@pytest.mark.parametrize('dtype', ['float', 'uint8'])
def test_save_image_grid_matches_jax(channels, dtype, tmp_path):
    rng = np.random.RandomState(channels)
    images = rng.uniform(-0.2, 1.2, (5, 6, 7, channels)).astype(np.float32)
    if dtype == 'uint8':
        images = (np.clip(images, 0, 1) * 255).astype(np.uint8)
    paths = [str(tmp_path / f'{n}.png') for n in ('jax', 'port')]
    jgrid.save_image_grid(images, paths[0], nrow=3)
    tgrid.save_image_grid(images, paths[1], nrow=3)
    a, b = (Image.open(p) for p in paths)
    assert a.mode == b.mode
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_png_unfilter_build_failure_raises(tmp_path, monkeypatch):
    """A failed build of the unfilter raises; the reader has no fallback."""
    monkeypatch.setattr(png, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(png, 'CXX_FLAGS', png.CXX_FLAGS + ('--no-such-flag',))
    monkeypatch.setattr(png, '_fn', None)
    path = str(tmp_path / 'any.png')
    png.write_png_rgba(path, np.zeros((2, 3, 4), np.uint8))
    with pytest.raises(RuntimeError, match='failed'):
        png.read_png_rgba(path)
    assert not list(tmp_path.glob('*.so'))
