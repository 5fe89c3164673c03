"""K1' and K2' on the card in turns: this tree's wrappers against another
tree's.

    python -m montage_gan_tpu_torch.tools.kernel_turns --parent _trees/parent

``_trees/parent`` is the root of another checkout, for example
``git archive <commit> | tar -x -C _trees/parent``.  Each tree's own public
wrappers (``ops.bias_act.bias_act_cuda``, ``ops.upfirdn2d.upfirdn2d_cuda``),
built from its own ``csrc/`` into its own ``build/``, run in a process of
their own, in turns: parent, this tree, this tree, parent.  Each process
holds its outputs to its plain versions and reports per case the device
time and the host's time per call.  This tree then times the library call
that computes the same function, where there is one, and the bound.

Times come from ``timing.py``: device times with L2 cold (256 MB read
before each call, events around the call alone) and host µs per call.
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve()
TREE = HERE.parents[2]

# (name, op, shape, dtype, keyword arguments): the main shapes of K1' and
# K2', K2''s gradient, and two small K1' launches.
CASES = (
    ("K1' [8,256,256,64] bf16 lrelu", 'bias_act', (8, 256, 256, 64),
     torch.bfloat16, dict(act='lrelu', gain=math.sqrt(2), clamp=256.0)),
    ("K1' [8,128,128,128] bf16 lrelu", 'bias_act', (8, 128, 128, 128),
     torch.bfloat16, dict(act='lrelu', gain=math.sqrt(2), clamp=256.0)),
    ("K1' [8,512] f32 linear", 'bias_act', (8, 512), torch.float32, {}),
    ("K1' [8,4608] f32 lrelu", 'bias_act', (8, 4608), torch.float32,
     dict(act='lrelu')),
    ("K2' [8,128,128,4] f32 up2", 'upfirdn2d', (8, 128, 128, 4),
     torch.float32, dict(up=2, padding=[2, 1, 2, 1], gain=4.0)),
    ("K2' [8,256,256,4] -> [8,128,128,4] f32 down2", 'upfirdn2d',
     (8, 256, 256, 4), torch.float32,
     dict(down=2, padding=1, gain=4.0, flip_filter=True)),
)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1e-5)}


def timing():
    """This tree's ``timing.py``, whichever tree's package is imported."""
    spec = importlib.util.spec_from_file_location('_mgt_timing',
                                                  HERE.with_name('timing.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def calls(case, ba, up, filters, seed):
    """(kernel call, plain call, input) of ``case`` through the imported
    tree's wrappers, on inputs drawn from ``seed``."""
    _, op, shape, dtype, kw = case
    g = torch.Generator(device='cuda').manual_seed(seed)
    x = (torch.randn(*shape, device='cuda', generator=g) * 3).to(dtype)
    if op == 'bias_act':
        b = torch.randn(shape[-1], device='cuda', generator=g).to(dtype)
        return (lambda: ba.bias_act_cuda(x, b, **kw),
                lambda: ba.bias_act_ref(x, b, **kw), x)
    f = filters.setup_filter([1, 3, 3, 1], device='cuda')
    return (lambda: up.upfirdn2d_cuda(x, f, **kw),
            lambda: up.upfirdn2d_ref(x, f, **kw), x)


def worker(root: Path) -> None:
    """Time every case through the wrappers of the tree at ``root``; one
    JSON line per case."""
    sys.path.insert(0, str(root))
    from montage_gan_tpu_torch import set_fp32_precision
    from montage_gan_tpu_torch.ops import bias_act as ba
    from montage_gan_tpu_torch.ops import filters
    from montage_gan_tpu_torch.ops import upfirdn2d as up
    t = timing()
    set_fp32_precision()
    for i, case in enumerate(CASES):
        kernel, plain, x = calls(case, ba, up, filters, seed=i)
        out, ref = kernel(), plain()
        torch.testing.assert_close(out, ref, **TOL[x.dtype])
        print(json.dumps({'case': case[0], 'ms': t.device_ms(kernel),
                          'host_us': t.host_us(kernel)}), flush=True)


def turns(parent: Path, card: str) -> None:
    t = timing()
    order = (('parent', parent), ('new', TREE), ('new', TREE),
             ('parent', parent))
    got = {}
    for label, root in order:
        run = subprocess.run([sys.executable, str(HERE), '--worker',
                              str(root)], cwd=root, capture_output=True,
                             text=True, timeout=1200)
        if run.returncode != 0:
            raise RuntimeError(f'{label} tree {root}: worker exit '
                               f'{run.returncode}\n{run.stdout}\n{run.stderr}')
        for line in run.stdout.splitlines():
            if line.startswith('{'):
                r = json.loads(line)
                got.setdefault(r['case'], []).append((label, r))
    print(f'[turns] parent | new | new | parent; device ms (L2 cold), then '
          f'host us per call; bound from bytes at {t.PEAK_BYTES / 1e12} '
          f'TB/s  card: {card}', flush=True)
    from ..ops import bias_act as ba
    from ..ops import filters
    from ..ops import upfirdn2d as up
    import torch.nn.functional as F
    for i, case in enumerate(CASES):
        runs = got[case[0]]
        ms = [r['ms'] for _, r in runs]
        host = [r['host_us'] for _, r in runs]
        p, n = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
        kernel, _, x = calls(case, ba, up, filters, seed=i)
        y = kernel()
        kern = ba.kernel if case[1] == 'bias_act' else up.kernel
        before = dict(kern.variants)
        kernel()
        variant = [k for k, v in kern.variants.items()
                   if v != before.get(k, 0)][0]
        moved = x.numel() * x.element_size() + y.numel() * y.element_size()
        bound = moved / t.PEAK_BYTES * 1e3
        line = (f'  {case[0]} ({variant}): parent {ms[0]:.4f} {ms[3]:.4f}  '
                f'new {ms[1]:.4f} {ms[2]:.4f}  speed-up {p / n:.2f}x  bound '
                f'{bound:.4f} ({moved / 1e6:.1f} MB; new at '
                f'{100 * bound / n:.1f}%)  host us: parent {host[0]:.1f} '
                f'{host[3]:.1f} new {host[1]:.1f} {host[2]:.1f}')
        if case[1] == 'upfirdn2d':
            # one depthwise convolution computes the same resampling
            f = filters.setup_filter([1, 3, 3, 1], device='cuda')
            w = (f * 4.0)[None, None].repeat(4, 1, 1, 1)
            xc = x.permute(0, 3, 1, 2)
            if case[4].get('up'):
                def lib():
                    return F.conv_transpose2d(xc, w, stride=2, padding=1,
                                              groups=4).permute(0, 2, 3, 1)
                name = 'depthwise F.conv_transpose2d'
            else:
                def lib():
                    return F.conv2d(xc, w, stride=2, padding=1,
                                    groups=4).permute(0, 2, 3, 1)
                name = 'depthwise F.conv2d stride 2'
            torch.testing.assert_close(lib(), y, **TOL[x.dtype])
            line += f'  {name} {t.device_ms(lib):.4f}'
        print(line + f'  card: {card}', flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parent', type=Path, default=None,
                    help="the root of another tree's checkout")
    ap.add_argument('--worker', type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if (args.parent is None) == (args.worker is None):
        ap.error('give --parent')
    if not torch.cuda.is_available():
        raise SystemExit('kernel_turns: no CUDA device')
    if args.worker is not None:
        worker(args.worker.resolve())
        return
    from .. import set_fp32_precision
    from ..ops import cuda
    set_fp32_precision()
    card = timing().card_line()
    cuda.build(['bias_act', 'upfirdn2d'])
    for name, log in cuda.BUILD_LOGS.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line or 'smem' in line:
                print(f'  {name}: {line.strip()}')
    turns(args.parent.resolve(), card)
    print(card)


if __name__ == '__main__':
    main()
