"""check-weights: the metric detectors' weights, what is present and what
is missing.

Port of ``montage_gan_tpu/cli/check_weights.py`` with ``argparse`` and the
port's converters.  The reference downloads its FID and LPIPS detectors at
run time (reference: metrics/metric_utils.py:46-57, pointing at
``inception-2015-12-05.pt`` and ``vgg16.pt``); offline they are converted
``.npz`` files in the drop-in directory (``MGT_WEIGHTS_DIR``, default
``~/.cache/montage_gan_tpu/weights``), or where ``MGT_INCEPTION_WEIGHTS``
and ``MGT_VGG16_WEIGHTS`` point, the same files for both packages:

    python -m montage_gan_tpu_torch check-weights [--convert] [--smoke]

A torch checkpoint dropped into the directory is checked against the
sha256 prefix in its name (torch hub's convention: the 8 hex digits before
the extension); ``--convert`` writes the ``.npz`` of each verified one.
``--smoke`` runs one image through each detector on ``--device`` (default
the card).  Exit code 0 when every detector is available, 1 otherwise.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import importlib
import os
import re
import sys
from typing import Optional, Sequence

_SPECS = [
    dict(
        key='inception',
        env='MGT_INCEPTION_WEIGHTS',
        npz='inception.npz',
        used_for='FID / KID / IS (absolute values)',
        upstream=('pytorch-fid "pt_inception-2015-12-05-6726825d.pth" or a '
                  'torchvision inception_v3 checkpoint (same layout); the '
                  'reference\'s own download is '
                  'https://nvlabs-fi-cdn.nvidia.com/stylegan2-ada-pytorch/'
                  'pretrained/metrics/inception-2015-12-05.pt'),
        official='pt_inception-2015-12-05-6726825d.pth',
        source_globs=('*inception*.pth', '*inception*.pt'),
        converter='montage_gan_tpu_torch.utils.convert_inception',
    ),
    dict(
        key='vgg16',
        env='MGT_VGG16_WEIGHTS',
        npz='vgg16.npz',
        used_for='PPL and the projector (LPIPS perceptual distance)',
        upstream=('torchvision vgg16 checkpoint (+ optional LPIPS "lin" '
                  'head); the reference\'s own download is '
                  'https://nvlabs-fi-cdn.nvidia.com/stylegan2-ada-pytorch/'
                  'pretrained/metrics/vgg16.pt'),
        official='vgg16-397923af.pth',
        source_globs=('vgg16*.pth', 'vgg16*.pt'),
        converter='montage_gan_tpu_torch.utils.convert_vgg16',
    ),
]

# torch hub's naming: the 8 hex digits before the extension are the sha256
# prefix of the file itself (offline, the file name is the manifest)
_HUB_SHA_RE = re.compile(r'-([0-9a-f]{8})\.pth?$')


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        for chunk in iter(lambda: f.read(1 << 20), b''):
            h.update(chunk)
    return h.hexdigest()


def _scan_dropin_sources(spec, dropin):
    """The torch checkpoints of this detector in the drop-in directory, each
    with its verdict: 'verified', 'CORRUPT' (its sha256 is not the one its
    name carries) or 'unverified' (its name carries none)."""
    seen, out = set(), []
    for pat in spec['source_globs']:
        for path in sorted(glob.glob(os.path.join(dropin, pat))):
            if path in seen or path.endswith('.npz'):
                continue
            seen.add(path)
            m = _HUB_SHA_RE.search(os.path.basename(path))
            if m is None:
                out.append((path, 'unverified'))
            elif _sha256(path).startswith(m.group(1)):
                out.append((path, 'verified'))
            else:
                out.append((path, 'CORRUPT'))
    return out


def _check_one(spec, smoke: bool, convert: bool, device: str):
    """(ok, report lines) of one detector."""
    from ..metrics.features import resolve_weights, weights_dropin_dir
    lines = []
    dropin = weights_dropin_dir()
    path = resolve_weights(spec['env'], spec['npz'])
    lines.append(f"[{spec['key']}] {spec['env']} — {spec['used_for']}")

    if not path or not os.path.exists(path):
        sources = _scan_dropin_sources(spec, dropin) if os.path.isdir(
            dropin) else []
        good = [p for p, v in sources if v != 'CORRUPT']
        for p, v in sources:
            mark = {'verified': 'sha256 VERIFIED (filename digest)',
                    'CORRUPT': 'sha256 MISMATCH vs filename digest — '
                               're-obtain this file',
                    'unverified': 'no filename digest to verify against'}[v]
            lines.append(f"  drop-in source: {p} — {mark}")
        dst = os.path.join(dropin, spec['npz'])
        if good and convert:
            src = good[0]
            lines.append(f"  converting {src} → {dst} ...")
            importlib.import_module(spec['converter']).main([src, dst])
            path = dst
        elif good:
            lines.append("  ready to convert — run:  python -m "
                         "montage_gan_tpu_torch check-weights --convert")
            lines.append(f"  (or: python -m {spec['converter']} "
                         f"{good[0]} {dst})")
            return False, lines
        else:
            env_p = os.environ.get(spec['env'])
            if env_p:
                lines.append(f"  MISSING: {spec['env']}={env_p} "
                             f"does not exist.")
            else:
                lines.append(f"  MISSING: {spec['env']} unset and no "
                             f"{spec['npz']} in the drop-in dir.")
            lines.append(f"  one-file handoff: copy {spec['official']} "
                         f"into {dropin}/")
            lines.append("    then run:  python -m montage_gan_tpu_torch "
                         "check-weights --convert")
            lines.append(f"  (manual route: python -m {spec['converter']} "
                         f"{spec['official']} {spec['npz']}; "
                         f"export {spec['env']}=$PWD/{spec['npz']})")
            lines.append(f"  obtain it: {spec['upstream']}")
            return False, lines
    if not os.path.exists(path):
        lines.append(f"  MISSING: {path} does not exist after conversion?")
        return False, lines
    lines.append(f"  found: {path} "
                 f"({os.path.getsize(path) / 1e6:.1f} MB)")
    try:
        from ..utils.weights import inception_v3_from_jax, vgg16_from_jax
        if spec['key'] == 'inception':
            from ..metrics import inception_net
            net = inception_v3_from_jax(inception_net.load_params(path))
        else:
            from ..metrics import vgg16_net
            net = vgg16_from_jax(vgg16_net.load_params(path))
        n = sum(b.numel() for b in net.buffers())
        lines.append(f"  loads: OK ({n / 1e6:.1f}M parameters)")
    except Exception as e:  # a corrupt or wrong-layout file: report it
        lines.append(f"  BROKEN: loading failed — {e}")
        lines.append(f"  re-convert: python -m {spec['converter']} "
                     f"<source.pth> {spec['npz']}")
        return False, lines
    if smoke:
        import torch
        from ..metrics.features import InceptionV3Features, VGG16Features
        cls = InceptionV3Features if spec['key'] == 'inception' \
            else VGG16Features
        ex = cls(path, device=device)
        feats = ex(torch.zeros((1, 64, 64, 3), device=next(
            ex.buffers()).device))
        lines.append(f"  forward: OK (feature shape {tuple(feats.shape)}, "
                     f"{feats.device})")
    return True, lines


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='python -m montage_gan_tpu_torch check-weights',
        description='Report which metric-detector weights are available and '
                    'how to supply the missing ones.')
    p.add_argument('--smoke', action='store_true',
                   help='Also run one image through each detector')
    p.add_argument('--convert', action='store_true',
                   help='Convert any sha256-verified torch source found in '
                        'the drop-in dir to its .npz in place')
    p.add_argument('--device', default='cuda',
                   help="device of --smoke (default 'cuda')")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Report every detector; exits with 1 unless all are available."""
    opts = make_parser().parse_args(argv)
    from ..metrics.features import weights_dropin_dir
    print(f"weights drop-in dir: {weights_dropin_dir()}  "
          f"(override with MGT_WEIGHTS_DIR)\n")
    all_ok = True
    for spec in _SPECS:
        ok, lines = _check_one(spec, opts.smoke, opts.convert, opts.device)
        all_ok &= ok
        print('\n'.join(lines) + '\n')
    if all_ok:
        print('All detector weights available — metrics report ABSOLUTE '
              'values (reference-comparable).')
    else:
        print('Some detector weights missing — FID/KID/IS/PPL fall back to '
              'the deterministic random-feature extractor (RELATIVE metrics '
              'only: valid for comparing checkpoints of the same run, not '
              'against published numbers).')
        sys.exit(1)


if __name__ == '__main__':
    main()
