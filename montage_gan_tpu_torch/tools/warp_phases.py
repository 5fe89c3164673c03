"""Where K3' and K4' spend their time: each kernel timed with one phase
taken out at a time.

    python -m montage_gan_tpu_torch.tools.warp_phases

``ncu`` does not run on the card's machine, so the phases are measured by
difference: each variant is ``csrc/warp.cu`` with one phase disabled by a
text substitution (each must match exactly once), built with ``nvcc`` into
``build/warp_phases/<variant>/`` and timed through the C entry points at the
main shape ([16, 396, 396, 4] ↔ [16, 524, 524, 4], theta from
``sample_warp_theta`` at p = 0.6), device time with L2 cold
(``timing.device_ms``).  A variant's saving over ``full`` is the cost of the
phase it takes out; the results are wrong by construction and only timed.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import torch

from .. import set_fp32_precision
from ..ops import affine_warp as aw
from ..ops import cuda
from ..training import augment as aug
from ..training.draws import Draws
from .timing import card_line, device_ms

# variant -> (kernel, [(text of csrc/warp.cu, its replacement)])
VARIANTS = {
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


def build_variants():
    """Build every variant's library, all at once; {name: ctypes CDLL}."""
    src = (cuda.CSRC_DIR / 'warp.cu').read_text()
    root = cuda.BUILD_DIR / 'warp_phases'
    procs = {}
    for i, (name, (_, subs)) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f'{name}: the text to replace occurs '
                                   f'{text.count(old)} times in warp.cu')
            text = text.replace(old, new)
        d = root / f'v{i}'
        d.mkdir(parents=True, exist_ok=True)
        for h in cuda.CSRC_DIR.glob('*.cuh'):
            shutil.copy(h, d / h.name)
        (d / 'warp.cu').write_text(text)
        procs[name] = (subprocess.Popen(
            [cuda.nvcc_path(), *cuda.NVCC_FLAGS, '-I', str(d), '-o',
             str(d / 'libwarp.so'), str(d / 'warp.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'{name}: nvcc failed\n{out}')
        lib = ctypes.CDLL(str(d / 'libwarp.so'))
        for fn in (lib.mgt_warp_forward, lib.mgt_warp_transpose):
            fn.argtypes = aw._SIGNATURE
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit('warp_phases: no CUDA device')
    set_fp32_precision()
    card = card_line()
    libs = build_variants()
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
        rc = fn(src.data_ptr(), theta.data_ptr(), taps.data_ptr(),
                dst.data_ptr(), n, ph, pw, 4, oh, ow, t, 2,
                aw.VARIANT_CODES[p.variant], p.tile[0], p.tile[1],
                p.smem_bytes, None, stream)
        if rc != 0:
            raise RuntimeError(f'{kind}: CUDA error {rc}')

    print(f"[warp phases] K3' [{n},{ph},{pw},4] -> [{n},{oh},{ow},4] tile "
          f"{plans['forward'].tile}, K4' tile {plans['transpose'].tile}; "
          f'device ms, L2 cold  card: {card}', flush=True)
    full = {}
    for name, (kind, _) in VARIANTS.items():
        for k in (('forward', 'transpose') if kind == 'both' else (kind,)):
            ms = device_ms(lambda: call(libs[name], k))
            label = "K3'" if k == 'forward' else "K4'"
            if name == 'full':
                full[k] = ms
                print(f'  {label} full: {ms:.4f}', flush=True)
            else:
                print(f'  {name}: {ms:.4f}  (saves {full[k] - ms:.4f})',
                      flush=True)
    print(card)


if __name__ == '__main__':
    main()
