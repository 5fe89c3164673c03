"""Where the resampling kernels spend their time: K3' and K4' (the warp) and
K5' (translate and composite), each timed with one phase taken out at a
time.

    python -m montage_gan_tpu_torch.tools.warp_phases [--only warp|composite]
        [--parent _trees/parent]

``ncu`` does not run on the card's machine, so the phases are measured by
difference: each variant is the kernel's source with one phase disabled by a
text substitution (each must match exactly once), built with ``nvcc`` into
``build/phases/<source>/<variant>/`` and timed through the C entry points,
device time with L2 cold (``timing.device_ms``).  A variant's saving over
``full`` is the cost of the phase it takes out; the results are wrong by
construction and only timed.

* K3'/K4' at the main shape ([16, 396, 396, 4] ↔ [16, 524, 524, 4], theta
  from ``sample_warp_theta`` at p = 0.6).
* K5' at the sampling path's stack shape [8, 9, 256, 256, 4], shifts within
  ±0.1: this tree's kernel (launch, plan and tables, staging copies,
  compositing, stores), and other tiles and ring depths, each built by
  changing one of the source's constants.  With ``--parent`` (the root of
  another checkout, e.g. ``git archive <commit> | tar -x -C
  _trees/parent``), that tree's ``csrc/composite.cu`` (tap loads, A-over-B
  divisions, stores) beside it.
* K5''s small-launch rule: on the launches it changes ([1-4, 9, 256, 256,
  4], shifts within ±0.1, and [3, 5, 67, 45, 4], shifts in ±1.5), 8-row
  against 4-row tiles in turns (8, 4, 4, 8), with the parent's kernel
  before and after where ``--parent`` is given.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path

import torch

from .. import set_fp32_precision
from ..ops import affine_warp as aw
from ..ops import composite as comp
from ..ops import cuda
from ..training import augment as aug
from ..training.draws import Draws
from .timing import card_line, device_ms

# variant -> (kernel, [(text of csrc/warp.cu, its replacement)])
WARP_VARIANTS = {
    'full': ('both', []),
    "K3' plan only": ('forward', [(
        'const MgtForwardPlan p = *plan;',
        'const MgtForwardPlan p = *plan;\n    if (p.mode != 99) return;')]),
    "K3' no staging loads": ('forward', [(
        'region[r * p.sw + c] = __ldg(src + static_cast<int64_t>(r) * s.W);',
        'region[r * p.sw + c] = make_float4(0.f, 0.f, 0.f, float(r));')]),
    "K3' no filter passes": ('forward', [
        ('if (a < nl) mgt_fma4(acc, w[a], src[r * p.sw + a]);',
         'if (a < nl && nl < 0) mgt_fma4(acc, w[a], src[r * p.sw + a]);'),
        ('if (a < nl) mgt_fma4(acc, taps[j - 2 * a], src[a * p.vw]);',
         'if (a < nl && nl < 0) mgt_fma4(acc, taps[j - 2 * a], '
         'src[a * p.vw]);')]),
    "K3' no bilinear": ('forward', [(
        'for (int r = k / tile_w; r < rows; r += go) {\n'
        '                const float yo',
        'for (int r = k / tile_w; r < rows && rows < 0; r += go) {\n'
        '                const float yo')]),
    "K4' plan only": ('transpose', [(
        'const int mode = plan->mode;',
        'const int mode = plan->mode;\n    if (mode != 99) return;')]),
    "K4' no loads of g": ('transpose', [(
        'mgt_fma4(acc, wy * wx, __ldg(grow + dj));', 'acc.x += wy * wx;')]),
    "K4' no candidate tests": ('transpose', [(
        'for (int dj = c0; dj <= c1; ++dj) {',
        'for (int dj = c0; dj <= c1 && c1 < -1; ++dj) {')]),
    "K4' no candidate rows": ('transpose', [(
        'for (int di = r0; di <= r1; ++di) {',
        'for (int di = r0; di <= r1 && r1 < -1; ++di) {')]),
    "K4' no filter passes": ('transpose', [
        ('if (a < nm) mgt_fma4(acc, w[a], src[r * vw + a]);',
         'if (a < nm && nm < 0) mgt_fma4(acc, w[a], src[r * vw + a]);'),
        ('if (a < nm) mgt_fma4(acc, taps[j + a], src[a * cols]);',
         'if (a < nm && nm < 0) mgt_fma4(acc, taps[j + a], '
         'src[a * cols]);')]),
}

# This tree's K5' (csrc/composite.cu): variant -> substitutions.  "no
# stores" keeps the canvas alive behind a test that never holds.
_NO_COPIES = ('const uint32_t bytes = 16u * w.rows * w.cols;',
              'const uint32_t bytes = 0u;')
_NO_COMPOSITING = ('if (tid < ncols) {\n            const MgtWindow w = window[st];',
                   'if (tid < ncols && s.L < 0) {\n'
                   '            const MgtWindow w = window[st];')
_NO_STORES = ('if (r < nrows)\n                __stcs(',
              'if (r < nrows && acc[r].w == -1.0f)\n                __stcs(')
COMPOSITE_VARIANTS = {
    'full': [],
    "K5' launch only": [('    const int tid = threadIdx.x;\n    const int b = blockIdx.z;',
                         '    if (s.L > 0) return;\n'
                         '    const int tid = threadIdx.x;\n    const int b = blockIdx.z;')],
    "K5' plan and tables only": [_NO_COPIES, _NO_COMPOSITING, _NO_STORES],
    "K5' no staging copies": [_NO_COPIES],
    "K5' no compositing": [_NO_COMPOSITING],
    "K5' no stores": [_NO_STORES],
}
# The tiled K5' at other tiles and ring depths, run as its 8-row tiles:
# label -> substitutions of the source's constants.
_EIGHT_ROWS = 'if (rows == 8) return launch_composite<8, TILED>'
COMPOSITE_TILES = {
    "K5' 8x256, 3 stages": [('constexpr int COMPOSITE_STAGES = 2;',
                             'constexpr int COMPOSITE_STAGES = 3;')],
    "K5' 8x128, 2 stages": [('constexpr int COMPOSITE_TILE_W = 256;',
                             'constexpr int COMPOSITE_TILE_W = 128;')],
    "K5' 16x256, 2 stages": [(_EIGHT_ROWS, _EIGHT_ROWS.replace('<8', '<16'))],
}
# A parent tree's K5' (its csrc/composite.cu; the per-pixel kernel before
# the tiled one).
PARENT_COMPOSITE_VARIANTS = {
    'full': [],
    "parent K5' no tap loads": [(
        '? mgt_load4(img + (static_cast<int64_t>(yy) * s.W + xx) * 4, VEC4)',
        '? make_float4(xx, yy, 0.0f, 0.5f)')],
    "parent K5' no A-over-B divisions": [(
        '    __fdiv_rn(__fadd_rn(__fmul_rn(c.x, la), __fmul_rn(canvas.x, keep)), ao),\n'
        '                    __fdiv_rn(__fadd_rn(__fmul_rn(c.y, la), __fmul_rn(canvas.y, keep)), ao),\n'
        '                    __fdiv_rn(__fadd_rn(__fmul_rn(c.z, la), __fmul_rn(canvas.z, keep)), ao), ao);',
        '    __fmul_rn(__fadd_rn(__fmul_rn(c.x, la), __fmul_rn(canvas.x, keep)), ao),\n'
        '                    __fmul_rn(__fadd_rn(__fmul_rn(c.y, la), __fmul_rn(canvas.y, keep)), ao),\n'
        '                    __fmul_rn(__fadd_rn(__fmul_rn(c.z, la), __fmul_rn(canvas.z, keep)), ao), ao);')],
    "parent K5' no stores": [(
        '*reinterpret_cast<float4*>(o) = canvas;',
        'if (canvas.w == -1.0f) *reinterpret_cast<float4*>(o) = canvas;')],
}
PARENT_COMPOSITE_SIGNATURE = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                              + [ctypes.c_float, ctypes.c_void_p])


def build_variants(csrc: Path, source: str, variants, symbols, argtypes,
                   tag: str):
    """Build ``csrc/<source>.cu`` once per variant ({name: substitutions}),
    with the ``.cuh`` headers beside it, all at once; {name: ctypes CDLL}
    with each of ``symbols`` bound to ``argtypes``."""
    src = (csrc / f'{source}.cu').read_text()
    root = cuda.BUILD_DIR / 'phases' / tag
    procs = {}
    for i, (name, subs) in enumerate(variants.items()):
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f'{name}: the text to replace occurs '
                                   f'{text.count(old)} times in {source}.cu')
            text = text.replace(old, new)
        d = root / f'v{i}'
        d.mkdir(parents=True, exist_ok=True)
        for h in csrc.glob('*.cuh'):
            shutil.copy(h, d / h.name)
        (d / f'{source}.cu').write_text(text)
        procs[name] = (subprocess.Popen(
            [cuda.nvcc_path(), *cuda.NVCC_FLAGS, '-I', str(d), '-o',
             str(d / f'lib{source}.so'), str(d / f'{source}.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'{name}: nvcc failed\n{out}')
        lib = ctypes.CDLL(str(d / f'lib{source}.so'))
        for sym in symbols:
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def checked(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA error {rc}')


def report(label: str, ms: float, full: float = None) -> None:
    if full is None:
        print(f'  {label}: {ms:.4f}', flush=True)
    else:
        print(f'  {label}: {ms:.4f}  (saves {full - ms:.4f})', flush=True)


def warp_phases(card: str) -> None:
    variants = {name: subs for name, (_, subs) in WARP_VARIANTS.items()}
    libs = build_variants(cuda.CSRC_DIR, 'warp', variants,
                          ('mgt_warp_forward', 'mgt_warp_transpose'),
                          aw._SIGNATURE, 'warp')
    gen = torch.Generator(device='cuda').manual_seed(4)
    theta, ph, pw, oh, ow = aug.sample_warp_theta(
        Draws(gen), 0.6, aug.make_augment_config('bgcfnc'), 16, 256, 256,
        device='cuda')
    theta = theta.contiguous()
    taps = aug._HZ_GEOM.to('cuda')
    x = torch.rand(16, ph, pw, 4, device='cuda', generator=gen)
    g = torch.randn(16, oh, ow, 4, device='cuda', generator=gen)
    y, dx = torch.empty_like(g), torch.empty_like(x)
    n, t = 16, taps.shape[0]
    plans = {k: aw.warp_plan(k, n, (ph, pw), (oh, ow), 4, t, 2)
             for k in ('forward', 'transpose')}
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib, kind):
        p = plans[kind]
        fn, src, dst = ((lib.mgt_warp_forward, x, y) if kind == 'forward'
                        else (lib.mgt_warp_transpose, g, dx))
        checked(fn(src.data_ptr(), theta.data_ptr(), taps.data_ptr(),
                   dst.data_ptr(), n, ph, pw, 4, oh, ow, t, 2,
                   aw.VARIANT_CODES[p.variant], p.tile[0], p.tile[1],
                   p.smem_bytes, None, stream), kind)

    print(f"[warp phases] K3' [{n},{ph},{pw},4] -> [{n},{oh},{ow},4] tile "
          f"{plans['forward'].tile}, K4' tile {plans['transpose'].tile}; "
          f'device ms, L2 cold  card: {card}', flush=True)
    full = {}
    for name, (kind, _) in WARP_VARIANTS.items():
        for k in (('forward', 'transpose') if kind == 'both' else (kind,)):
            ms = device_ms(lambda: call(libs[name], k))
            if name == 'full':
                full[k] = ms
                report(f"{'K3' if k == 'forward' else 'K4'}' full", ms)
            else:
                report(name, ms, full[k])


def composite_phases(card: str, parent: Path = None) -> None:
    b, l, h, w = 8, 9, 256, 256
    gen = torch.Generator(device='cuda').manual_seed(9)
    layers = torch.rand(b, l, h, w, 4, device='cuda', generator=gen)
    shifts = (torch.rand(b, l, 2, device='cuda', generator=gen) * 2 - 1) * 0.1
    small = torch.rand(3, 5, 67, 45, 4, device='cuda', generator=gen)
    small_shifts = (torch.rand(3, 5, 2, device='cuda', generator=gen) * 2
                    - 1) * 1.5
    out = torch.empty(b, h, w, 4, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream
    sms = comp.sm_count(layers.device)
    plan = comp.composite_plan(b, h, w, sms)
    libs = build_variants(cuda.CSRC_DIR, 'composite',
                          {**COMPOSITE_VARIANTS, **COMPOSITE_TILES},
                          ('mgt_translate_composite',),
                          comp.kernel.argtypes, 'composite')
    old = None if parent is None else build_variants(
        parent / 'montage_gan_tpu_torch' / 'csrc', 'composite',
        PARENT_COMPOSITE_VARIANTS, ('mgt_translate_composite',),
        PARENT_COMPOSITE_SIGNATURE, 'composite_parent')

    def call(lib, rows=plan.rows, x=layers, t=shifts):
        checked(lib.mgt_translate_composite(
            x.data_ptr(), t.data_ptr(), out.data_ptr(), *x.shape[:4], 0.0,
            comp.VARIANT_CODES['tiled'], rows, stream), 'composite')

    def call_parent(lib, x=layers, t=shifts):
        checked(lib.mgt_translate_composite(
            x.data_ptr(), t.data_ptr(), out.data_ptr(), *x.shape[:4], 0.0,
            stream), 'parent composite')

    print(f"[composite phases] K5' [{b},{l},{h},{w},4], shifts within "
          f'+-0.1; plan {plan.variant} {plan.rows}x{plan.tile_w}, '
          f'{comp.STAGES} stages, {plan.smem_bytes} B shared; device ms, '
          f'L2 cold  card: {card}', flush=True)
    full = device_ms(lambda: call(libs['full']))
    report("K5' full", full)
    for name in [*COMPOSITE_VARIANTS][1:]:
        report(name, device_ms(lambda: call(libs[name])), full)
    report("K5' 4x256, 2 stages", device_ms(lambda: call(libs['full'], 4)),
           full)
    for name in COMPOSITE_TILES:
        report(name, device_ms(lambda: call(libs[name], 8)), full)
    if old is not None:
        pfull = device_ms(lambda: call_parent(old['full']))
        report(f"{parent.name} K5' full", pfull)
        for name in [*PARENT_COMPOSITE_VARIANTS][1:]:
            report(name, device_ms(lambda: call_parent(old[name])), pfull)

    print(f"[composite small launches] 8-row against 4-row tiles in turns "
          f'(8, 4, 4, 8; the parent first and last); the plan takes 4 rows '
          f'below {sms} tiles of 8 rows; device ms, L2 cold  card: {card}',
          flush=True)
    cases = [((n, 9, 256, 256), layers[:n], shifts[:n]) for n in (1, 2, 3, 4)]
    cases.append(((3, 5, 67, 45), small, small_shifts))
    for shape, x, t in cases:
        order = ([] if old is None else ['parent']) + [8, 4, 4, 8] + (
            [] if old is None else ['parent'])
        ms = {}
        for k in order:
            fn = ((lambda: call_parent(old['full'], x, t)) if k == 'parent'
                  else (lambda: call(libs['full'], k, x, t)))
            ms.setdefault(k, []).append(device_ms(fn))
        chosen = comp.composite_plan(*shape[:1], *shape[2:], sms).rows
        line = '  '.join(f"{k}{' rows' if k != 'parent' else ''} "
                         + ' '.join(f'{v:.4f}' for v in vs)
                         for k, vs in ms.items())
        print(f"  K5' [{','.join(map(str, shape))},4] (the plan: {chosen} "
              f'rows): {line}', flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--only', choices=('warp', 'composite'), default=None)
    ap.add_argument('--parent', type=Path, default=None,
                    help="another checkout's root: time its K5' too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('warp_phases: no CUDA device')
    set_fp32_precision()
    card = card_line()
    if args.only in (None, 'warp'):
        warp_phases(card)
    if args.only in (None, 'composite'):
        composite_phases(card, args.parent and args.parent.resolve())
    print(card)


if __name__ == '__main__':
    main()
