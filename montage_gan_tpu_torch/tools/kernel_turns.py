"""The hand-written kernels on the card in turns: this tree's wrappers against
another tree's.

    python -m montage_gan_tpu_torch.tools.kernel_turns --parent _trees/parent

``_trees/parent`` is the root of another checkout, for example
``git archive <commit> | tar -x -C _trees/parent``.  Each tree's own public
wrappers (``ops.bias_act.bias_act_cuda``, ``ops.upfirdn2d.upfirdn2d_cuda``,
``ops.affine_warp.warp_forward_cuda`` and ``warp_transpose_cuda``,
``ops.composite.translate_and_composite_cuda``), built from its own
``csrc/`` into its own ``build/``, run in a process of their own, in turns:
parent, this tree, this tree, parent.  Each process holds its outputs to its
plain versions and reports per case the device time and the host's time per
call.  This tree then times the library call that computes the same
function, where there is one (for the warp, two calls: ``F.conv_transpose2d``
for the ×2 upsample and ``F.grid_sample``, and their autograd backward for
K4'; for K5', ``F.grid_sample`` and ``alpha_composite``), and the bound.

The warp's cases take theta from the pipe's own law (``sample_warp_theta``
at p = 0.6, the same seed in every process) at the main shape (crops of
256², warped [16, 396, 396, 4] → [16, 524, 524, 4]) and at the 64×32
layer's.  K5''s cases: the sampling path's stack shape [8, 9, 256, 256, 4]
with shifts within ±0.1 (the STN's range at the start of training), and
[3, 5, 67, 45, 4] with shifts in ±1.5 (some clamped); its bound counts the
pixels some tap reads (``ops.composite.needed_bytes``).

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
# K2', K2''s gradient, two small K1' launches, and K3'/K4' (shape: the
# batch and the crop the warp's geometry is made for).
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
    ("K3' [16,396,396,4] -> [16,524,524,4]", 'warp_forward', (16, 256, 256),
     torch.float32, {}),
    ("K4' [16,524,524,4] -> [16,396,396,4]", 'warp_transpose',
     (16, 256, 256), torch.float32, {}),
    ("K3' [16,108,60,4] -> [16,140,76,4]", 'warp_forward', (16, 64, 32),
     torch.float32, {}),
    ("K4' [16,140,76,4] -> [16,108,60,4]", 'warp_transpose', (16, 64, 32),
     torch.float32, {}),
    ("K5' [8,9,256,256,4] shifts +-0.1", 'composite', (8, 9, 256, 256),
     torch.float32, dict(shift=0.1)),
    ("K5' [3,5,67,45,4] shifts +-1.5", 'composite', (3, 5, 67, 45),
     torch.float32, dict(shift=1.5)),
)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1e-5)}


def premultiplied(img):
    """RGBA with the colour multiplied by alpha (how K5' is compared: the
    plain version's closed form loses digits where alpha is small).  Kept
    here: a worker imports another tree's package, which may lack one."""
    return torch.cat([img[..., :3] * img[..., 3:], img[..., 3:]], -1)


def timing():
    """This tree's ``timing.py``, whichever tree's package is imported."""
    spec = importlib.util.spec_from_file_location('_mgt_timing',
                                                  HERE.with_name('timing.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _warp_inputs(case, pkg, seed):
    """(x, g, theta, geometry, taps) of a warp case, from ``seed``."""
    aug = pkg['augment']
    n, h, w = case[2]
    gen = torch.Generator(device='cuda').manual_seed(seed)
    theta, ph, pw, oh, ow = aug.sample_warp_theta(
        pkg['Draws'](gen), 0.6, aug.make_augment_config('bgcfnc'), n, h, w,
        device='cuda')
    x = torch.rand(n, ph, pw, 4, device='cuda', generator=gen) * 2 - 1
    g = torch.randn(n, oh, ow, 4, device='cuda', generator=gen)
    return x, g, theta.contiguous(), (ph, pw, oh, ow), aug._HZ_GEOM.to('cuda')


def _composite_inputs(case, seed):
    """(layers in [0, 1], shifts within ±kw['shift']) of a K5' case."""
    b, l, h, w = case[2]
    gen = torch.Generator(device='cuda').manual_seed(seed)
    layers = torch.rand(b, l, h, w, 4, device='cuda', generator=gen)
    shifts = (torch.rand(b, l, 2, device='cuda', generator=gen) * 2 - 1) \
        * case[4]['shift']
    return layers, shifts


def calls(case, pkg, seed):
    """(kernel call, plain call, input) of ``case`` through the imported
    tree's wrappers (``pkg``: its modules), on inputs drawn from ``seed``."""
    _, op, shape, dtype, kw = case
    if op == 'composite':
        cm = pkg['composite']
        layers, shifts = _composite_inputs(case, seed)
        return (lambda: cm.translate_and_composite_cuda(layers, shifts),
                lambda: cm.translate_and_composite_ref(layers, shifts),
                layers)
    if op.startswith('warp'):
        aw = pkg['affine_warp']
        x, g, theta, (ph, pw, oh, ow), taps = _warp_inputs(case, pkg, seed)
        if op == 'warp_forward':
            return (lambda: aw.warp_forward_cuda(x, theta, oh, ow, 2, taps),
                    lambda: aw.affine_warp_ref(x, theta, oh, ow, 2, taps), x)

        def plain():
            xr = x.clone().requires_grad_(True)
            y = aw.affine_warp_ref(xr, theta, oh, ow, 2, taps)
            return torch.autograd.grad(y, xr, g)[0]
        return (lambda: aw.warp_transpose_cuda(g, theta, ph, pw, 2, taps),
                plain, g)
    g = torch.Generator(device='cuda').manual_seed(seed)
    x = (torch.randn(*shape, device='cuda', generator=g) * 3).to(dtype)
    if op == 'bias_act':
        ba = pkg['bias_act']
        b = torch.randn(shape[-1], device='cuda', generator=g).to(dtype)
        return (lambda: ba.bias_act_cuda(x, b, **kw),
                lambda: ba.bias_act_ref(x, b, **kw), x)
    up = pkg['upfirdn2d']
    f = pkg['filters'].setup_filter([1, 3, 3, 1], device='cuda')
    return (lambda: up.upfirdn2d_cuda(x, f, **kw),
            lambda: up.upfirdn2d_ref(x, f, **kw), x)


def modules():
    """The imported tree's modules that ``calls`` uses."""
    from montage_gan_tpu_torch.ops import affine_warp, bias_act, composite
    from montage_gan_tpu_torch.ops import filters, upfirdn2d
    from montage_gan_tpu_torch.training import augment
    from montage_gan_tpu_torch.training.draws import Draws
    return dict(affine_warp=affine_warp, bias_act=bias_act,
                composite=composite, filters=filters, upfirdn2d=upfirdn2d,
                augment=augment, Draws=Draws)


def worker(root: Path) -> None:
    """Time every case through the wrappers of the tree at ``root``; one
    JSON line per case."""
    sys.path.insert(0, str(root))
    from montage_gan_tpu_torch import set_fp32_precision
    pkg = modules()
    t = timing()
    set_fp32_precision()
    for i, case in enumerate(CASES):
        kernel, plain, x = calls(case, pkg, seed=i)
        out, ref = kernel(), plain()
        tol = TOL[x.dtype]
        if case[1] == 'warp_transpose':       # the gradient's own scale
            tol = dict(rtol=1e-5, atol=1e-5 * ref.abs().max().item())
        elif case[1] == 'warp_forward':
            tol = dict(rtol=1e-5, atol=1e-5)
        elif case[1] == 'composite':
            out, ref = premultiplied(out), premultiplied(ref)
        torch.testing.assert_close(out, ref, **tol)
        print(json.dumps({'case': case[0], 'ms': t.device_ms(kernel),
                          'host_us': t.host_us(kernel)}), flush=True)


def library(case, pkg, seed, y, t):
    """(name, device ms) of the library calls that compute ``case``'s
    function, checked against the kernel's output ``y``; None if none."""
    import torch.nn.functional as F
    op = case[1]
    if op == 'composite':
        # F.grid_sample of every layer (the grid and the NCHW copy made
        # outside the timed region), then alpha_composite; held loosely, as
        # grid_sample computes its coordinates in another order
        from ..ops.grid_sample import translate_to_theta
        layers, shifts = _composite_inputs(case, seed)
        b, l, h, w, _ = layers.shape
        nchw = layers.reshape(b * l, h, w, 4).permute(0, 3, 1, 2).contiguous()
        grid = F.affine_grid(translate_to_theta(shifts.clamp(-1, 1)).reshape(
            b * l, 2, 3), [b * l, 4, h, w], align_corners=False)

        def two_calls():
            moved = F.grid_sample(nchw, grid, mode='bilinear',
                                  padding_mode='zeros', align_corners=False)
            return pkg['composite'].alpha_composite(
                moved.permute(0, 2, 3, 1).reshape(b, l, h, w, 4))
        torch.testing.assert_close(premultiplied(two_calls()),
                                   premultiplied(y), rtol=0, atol=1e-3)
        return 'F.grid_sample + alpha_composite', t.device_ms(two_calls)
    if op == 'upfirdn2d':
        _, _, x = calls(case, pkg, seed)
        f = pkg['filters'].setup_filter([1, 3, 3, 1], device='cuda')
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
        return name, t.device_ms(lib)
    if not op.startswith('warp'):
        return None
    # two calls: the ×2 upsample as a depthwise transposed convolution
    # (stride 2, padding k0 = 5, kernel 4·f⊗f), then F.grid_sample on the
    # plain version's grid; they round the coordinates in another order, so
    # they are held to the kernel loosely
    x, g, theta, (ph, pw, oh, ow), taps = _warp_inputs(case, pkg, seed)
    from ..ops.grid_sample import affine_grid
    k0 = taps.shape[0] - 1 - (taps.shape[0] + 1) // 2
    w = (4.0 * taps[:, None] * taps[None, :])[None, None].repeat(4, 1, 1, 1)
    grid = affine_grid(theta, oh, ow)
    xc = x.permute(0, 3, 1, 2).contiguous()

    def two_calls(v):
        up = F.conv_transpose2d(v, w, stride=2, padding=k0, groups=4)
        return F.grid_sample(up, grid, mode='bilinear', padding_mode='zeros',
                             align_corners=False)
    if op == 'warp_forward':
        torch.testing.assert_close(two_calls(xc).permute(0, 2, 3, 1), y,
                                   rtol=0, atol=1e-3)
        return ('F.conv_transpose2d + F.grid_sample',
                t.device_ms(lambda: two_calls(xc)))
    xl = xc.clone().requires_grad_(True)
    yl = two_calls(xl)
    gl = g.permute(0, 3, 1, 2).contiguous()
    dl, = torch.autograd.grad(yl, xl, gl, retain_graph=True)
    torch.testing.assert_close(dl.permute(0, 2, 3, 1), y, rtol=0,
                               atol=1e-3 * y.abs().max().item())
    return ('their autograd backward', t.device_ms(
        lambda: torch.autograd.grad(yl, xl, gl, retain_graph=True)))


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
    pkg = modules()
    kernels = {'bias_act': pkg['bias_act'].kernel,
               'upfirdn2d': pkg['upfirdn2d'].kernel,
               'warp_forward': pkg['affine_warp'].forward_kernel,
               'warp_transpose': pkg['affine_warp'].transpose_kernel,
               'composite': pkg['composite'].kernel}
    for i, case in enumerate(CASES):
        runs = got[case[0]]
        ms = [r['ms'] for _, r in runs]
        host = [r['host_us'] for _, r in runs]
        p, n = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
        kernel, _, x = calls(case, pkg, seed=i)
        y = kernel()
        kern = kernels[case[1]]
        before = dict(kern.variants)
        kernel()
        variant = [k for k, v in kern.variants.items()
                   if v != before.get(k, 0)][0]
        moved = x.numel() * x.element_size() + y.numel() * y.element_size()
        if case[1] == 'composite':
            _, shifts = _composite_inputs(case, i)
            moved = pkg['composite'].needed_bytes(x.shape, shifts.cpu())
        bound = moved / t.PEAK_BYTES * 1e3
        line = (f'  {case[0]} ({variant}): parent {ms[0]:.4f} {ms[3]:.4f}  '
                f'new {ms[1]:.4f} {ms[2]:.4f}  speed-up {p / n:.2f}x  bound '
                f'{bound:.4f} ({moved / 1e6:.1f} MB; new at '
                f'{100 * bound / n:.1f}%)  host us: parent {host[0]:.1f} '
                f'{host[3]:.1f} new {host[1]:.1f} {host[2]:.1f}')
        lib = library(case, pkg, i, y, t)
        if lib is not None:
            line += f'  {lib[0]} {lib[1]:.4f}'
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
    cuda.build()
    for name, log in cuda.BUILD_LOGS.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line or 'smem' in line:
                print(f'  {name}: {line.strip()}')
    turns(args.parent.resolve(), card)
    print(card)


if __name__ == '__main__':
    main()
