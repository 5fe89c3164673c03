"""The port's flat-image data path against the JAX package's, on the CPU:
``ImageFolderDataset`` and the ``dataset-tool`` CLI.

Every image is written from seeded numpy (PIL writes the inputs, as a user's
files would be).  ``ImageFolderDataset`` of the port and of the JAX package
read the same folder or zip: the same arrays and labels, exactly.  The
dataset tool runs through both CLIs (the JAX one through click's runner) on
the same source, every source type and both transforms: every PNG written
is decoded by PIL and held pixel for pixel, and ``dataset.json`` byte for
byte.  An LMDB archive is written as ``tests/test_lmdb_reader.py`` writes
one.  The port reads no JPEG: a JPEG input raises with the file's name.
"""

import gzip
import io
import json
import os
import pickle
import struct
import zipfile

import numpy as np
import pytest
from click.testing import CliRunner
from PIL import Image

from montage_gan_tpu.cli.dataset_tool import main as jax_tool
from montage_gan_tpu.data.dataset import ImageFolderDataset as JaxFolder
from montage_gan_tpu_torch.cli import dataset_tool
from montage_gan_tpu_torch.data.dataset import ImageFolderDataset
from montage_gan_tpu_torch.data.synthetic import make_synthetic_layer_dataset
from test_lmdb_reader import _write_env

MODES = {'RGB': 3, 'RGBA': 4, 'L': 1}


def _images(mode, n, size=(12, 10), seed=0):
    rng = np.random.RandomState(seed)
    c = MODES[mode]
    return [rng.randint(0, 256, (*size, c)).astype(np.uint8).squeeze()
            for _ in range(n)]


def _write_folder(root, mode, n, labels=None, to_zip=False, size=(12, 10)):
    """``n`` PIL-written PNGs in a folder (in a sub-folder for half of
    them) or a zip, with ``dataset.json`` where ``labels`` are given."""
    names = [f'{"sub/" if i % 2 else ""}img{i:03d}.png' for i in range(n)]
    files = {}
    for name, img in zip(names, _images(mode, n, size)):
        buf = io.BytesIO()
        Image.fromarray(img, mode).save(buf, format='png')
        files[name] = buf.getvalue()
    if labels is not None:
        files['dataset.json'] = json.dumps(
            {'labels': [[k, v] for k, v in zip(names, labels)]}).encode()
    if to_zip:
        with zipfile.ZipFile(root, 'w') as z:
            for k, v in files.items():
                z.writestr(k, v)
    else:
        for k, v in files.items():
            os.makedirs(os.path.dirname(os.path.join(root, k)),
                        exist_ok=True)
            with open(os.path.join(root, k), 'wb') as f:
                f.write(v)
    return root


FOLDER_CASES = {
    'folder-rgb-int-xflip': ('RGB', 'int', False, dict(xflip=True)),
    'zip-rgba-vector': ('RGBA', 'vector', True, {}),
    'folder-grey-maxsize': ('L', None, False, dict(max_size=5,
                                                   random_seed=3)),
    'zip-grey-int-xflip-maxsize': ('L', 'int', True,
                                   dict(xflip=True, max_size=6)),
}


@pytest.mark.parametrize('case', sorted(FOLDER_CASES))
def test_image_folder_dataset_matches_jax(case, tmp_path):
    """The same items (image and label) in the same order, exactly: RGB,
    RGBA and grey (read as RGB), integer labels one-hot, vector labels as
    they are, xflip's mirrored copies, ``max_size``'s seeded choice."""
    mode, kind, to_zip, kw = FOLDER_CASES[case]
    n = 9
    rng = np.random.RandomState(1)
    labels = (None if kind is None else
              rng.randint(0, 4, n).tolist() if kind == 'int' else
              rng.randn(n, 3).round(3).tolist())
    path = _write_folder(str(tmp_path / ('d.zip' if to_zip else 'd')), mode,
                         n, labels, to_zip)
    use = kind is not None
    ours = ImageFolderDataset(path, use_labels=use, **kw)
    ref = JaxFolder(path, use_labels=use, **kw)
    assert len(ours) == len(ref)
    assert (ours.resolution, ours.num_channels, ours.label_dim,
            ours.has_labels, ours.name) == \
        (ref.resolution, ref.num_channels, ref.label_dim, ref.has_labels,
         ref.name)
    assert ours.image_shape == ref.image_shape
    for i in range(len(ref)):
        img, lab = ours[i]
        rimg, rlab = ref[i]
        assert img.dtype == rimg.dtype == np.uint8
        np.testing.assert_array_equal(img, rimg)
        np.testing.assert_array_equal(lab, rlab)
        assert lab.dtype == rlab.dtype
        out = np.empty_like(img)
        np.testing.assert_array_equal(ours.load_u8(i, out=out), rimg)


def test_image_folder_dataset_raises_on_jpeg(tmp_path):
    """A JPEG (which the JAX class reads through PIL) raises with the
    file's name; the port decodes PNGs only."""
    d = tmp_path / 'd'
    d.mkdir()
    Image.fromarray(_images('RGB', 1)[0]).save(str(d / 'a.jpg'))
    with pytest.raises(ValueError, match='a.jpg.*not a PNG'):
        ImageFolderDataset(str(d))


# ---------------------------------------------------------------------------
# dataset-tool
# ---------------------------------------------------------------------------

def _cifar10(root):
    os.makedirs(root)
    rng = np.random.RandomState(2)
    for b in range(1, 6):
        with open(os.path.join(root, f'data_batch_{b}'), 'wb') as f:
            pickle.dump({'data': rng.randint(0, 256, (3, 3072)).astype(
                np.uint8), 'labels': rng.randint(0, 10, 3).tolist()}, f)
    return root


def _mnist(root):
    os.makedirs(root)
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    with gzip.open(os.path.join(root, 'train-images-idx3-ubyte.gz'),
                   'wb') as f:
        f.write(struct.pack('>IIII', 2051, 5, 28, 28) + imgs.tobytes())
    with gzip.open(os.path.join(root, 'train-labels-idx1-ubyte.gz'),
                   'wb') as f:
        f.write(struct.pack('>II', 2049, 5)
                + rng.randint(0, 10, 5).astype(np.uint8).tobytes())
    return root


def _lmdb(root, tmp_path):
    """4 PNG records (RGB, grey, RGBA, RGB) and a record that is no
    image, which both tools skip."""
    items = []
    for i, mode in enumerate(['RGB', 'L', 'RGBA', 'RGB']):
        buf = io.BytesIO()
        Image.fromarray(_images(mode, 1, (9, 11), seed=i)[0], mode).save(
            buf, format='png')
        items.append((b'%08d' % i, buf.getvalue()))
    items.append((b'zz-bad', b'not an image'))
    return _write_env(tmp_path, items, name=os.path.basename(root))


SOURCES = {
    'folder': lambda p, t: _write_folder(p, 'RGBA', 4,
                                         labels=[0, 2, 1, 2],
                                         size=(20, 14)),
    'zip': lambda p, t: _write_folder(p + '.zip', 'L', 4, to_zip=True,
                                      size=(11, 17)),
    'cifar10': lambda p, t: _cifar10(p),
    'mnist': lambda p, t: _mnist(p),
    'lmdb': _lmdb,
}
TOOL_CASES = {
    'folder': ('folder', [], '.zip'),
    'folder-center-crop': ('folder', ['--transform', 'center-crop',
                                      '--width', '8', '--height', '8'], ''),
    'zip-center-crop-wide': ('zip', ['--transform', 'center-crop-wide',
                                     '--width', '24', '--height', '12'],
                             '.zip'),
    'cifar10-resize': ('cifar10', ['--width', '16', '--height', '16',
                                   '--max-images', '10'], '.zip'),
    'mnist-center-crop': ('mnist', ['--transform', 'center-crop', '--width',
                                    '20', '--height', '20'], ''),
    'lmdb': ('lmdb', ['--width', '10', '--height', '10'], '.zip'),
}


def _read_output(dest):
    """{name: pixels} of the PNGs written and the ``dataset.json`` text."""
    if dest.endswith('.zip'):
        with zipfile.ZipFile(dest) as z:
            files = {n: z.read(n) for n in z.namelist()}
    else:
        files = {}
        for n in os.listdir(dest):
            with open(os.path.join(dest, n), 'rb') as f:
                files[n] = f.read()
    meta = files.pop('dataset.json').decode()
    imgs = {}
    for n, data in files.items():
        img = Image.open(io.BytesIO(data))
        imgs[n] = (img.mode, np.asarray(img))
    return imgs, meta


@pytest.mark.parametrize('case', sorted(TOOL_CASES))
def test_dataset_tool_matches_jax(case, tmp_path, capsys):
    """Both CLIs on the same source: the same PNGs (mode and pixels) and
    the same ``dataset.json``."""
    kind, args, ext = TOOL_CASES[case]
    src = SOURCES[kind](str(tmp_path / 'src'), tmp_path)
    base = ['--source', src, '--source-type', kind, *args]
    ref_dest = str(tmp_path / f'jax{ext}')
    res = CliRunner().invoke(jax_tool, [*base, '--dest', ref_dest])
    assert res.exit_code == 0, res.output
    dest = str(tmp_path / f'port{ext}')
    count = dataset_tool.main([*base, '--dest', dest])
    out = capsys.readouterr().out
    assert f'wrote {count} images to {dest}' in out
    ours, meta = _read_output(dest)
    ref, ref_meta = _read_output(ref_dest)
    assert meta == ref_meta
    assert sorted(ours) == sorted(ref) and len(ours) == count > 0
    for name, (mode, pixels) in ref.items():
        assert ours[name][0] == mode, name
        np.testing.assert_array_equal(ours[name][1], pixels, err_msg=name)
    if kind == 'lmdb':
        assert 'skipped 1 LMDB values' in out


def test_dataset_tool_layers_matches_jax(tmp_path, capsys):
    """``--source-type layers`` (and ``auto`` on a directory of
    directories): the tree copied and the same statistics cache."""
    src = str(tmp_path / 'layers')
    make_synthetic_layer_dataset(src, num_samples=3)
    res = CliRunner().invoke(jax_tool, ['--source', src, '--dest',
                                        str(tmp_path / 'jax')])
    assert res.exit_code == 0, res.output
    assert dataset_tool.main(['--source', src, '--dest',
                              str(tmp_path / 'port')]) == 3
    assert 'layers dataset: 3 samples' in capsys.readouterr().out
    for name in ('jax', 'port'):
        with open(tmp_path / name / 'montage_stats.json') as f:
            stats = json.load(f)
        if name == 'jax':
            ref = stats
    assert stats == ref
    assert sorted(os.listdir(tmp_path / 'port')) == \
        sorted(os.listdir(tmp_path / 'jax'))


def test_dataset_tool_raises_on_jpeg_with_its_name(tmp_path):
    d = tmp_path / 'src'
    d.mkdir()
    Image.fromarray(_images('RGB', 1)[0]).save(str(d / 'photo.jpeg'))
    with pytest.raises(ValueError, match='photo.jpeg'):
        dataset_tool.main(['--source', str(d), '--dest',
                           str(tmp_path / 'out.zip')])


def test_dataset_tool_cli_entry(tmp_path, capsys):
    """``python -m montage_gan_tpu_torch dataset-tool`` reaches the CLI."""
    from montage_gan_tpu_torch import __main__ as port_main
    src = _write_folder(str(tmp_path / 'src'), 'RGB', 2)
    assert port_main.main(['dataset-tool', '--source', src, '--dest',
                           str(tmp_path / 'o')]) == 2
    assert sorted(os.listdir(tmp_path / 'o')) == [
        'dataset.json', 'img00000000.png', 'img00000001.png']


def test_port_imports_no_pil():
    """The card's machine has no PIL: no module of the port, and not
    ``chip_smoke.py``, imports it (read from the source)."""
    import ast
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent / 'montage_gan_tpu_torch'
    sources = [p for p in root.rglob('*.py')
               if (root / 'build') not in p.parents]
    sources.append(root.parent / 'chip_smoke.py')
    found = []
    for path in sorted(sources):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            found += [f'{path.name}: {n}' for n in names
                      if n.split('.')[0] == 'PIL']
    assert not found, found
    assert any(p.name == 'dataset_tool.py' for p in sources)
