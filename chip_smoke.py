#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``montage_gan_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; each raises on failure, and the script then exits non-zero:

1. device: a CUDA card is required; the run never falls back to the CPU.
2. build: ``nvcc`` builds every kernel of ``montage_gan_tpu_torch/csrc/`` for
   ``sm_90a``, one process per source, all started together.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the sampling path's shapes and at odd ones, with TF32 off.  Times are the
   median of 20 runs after warm-up, from CUDA events.
4. slice: the full-width config ``aio`` sampling path (mapping -> 9 synthesis
   nets -> STN -> alpha composite) at batch 8 through ``build_inference_fn``,
   with seeded random weights.  Every kernel launch count is set to 0 just
   before that run and read just after; each must equal what the path
   implies.
5. cross-device: a micro ensemble on the CPU (plain versions) and on the card
   (kernels) with the same weights; ``placed`` and ``img`` must agree.

Its last two lines are the card's name and power limit (from ``nvidia-smi``)
and one JSON object, ``{"ok": true, "device": {...}}``; the line before them
is ``{"kernels": [...]}``.
"""

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 8
SEED = 0

# Tolerances of kernel against plain version.  float32: the same operations
# in another order (bias_act: bit-level; upfirdn2d: a sum of a few taps).
# bfloat16: the plain version rounds after every step, the kernel once, so
# the two differ by up to 2 bfloat16 ulps.
TOL_F32 = dict(rtol=1e-6, atol=1e-6)
TOL_F32_FIR = dict(rtol=1e-5, atol=1e-6)
TOL_BF16 = dict(rtol=1.6e-2, atol=1e-5)
# Card against CPU on the float32 micro ensemble: convolutions sum in another
# order (TF32 is off), as in tests/test_torch_slice.py.
TOL_CROSS = dict(rtol=0.0, atol=1e-4)

MICRO = dict(layer_names=('a', 'b', 'c'),
             layer_targets=((32, 32), (32, 32), (16, 8)),
             base_resolution=32, img_channels=4, conv_config_index=2,
             z_dim=32, w_dim=32, mapping_num_layers=2, channel_base=512,
             channel_max=32, num_fp16_res=0, conv_clamp=256,
             renderer_type='none', stn_stages=2)


def log(msg=''):
    print(msg, flush=True)


def card_line():
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, iters=20, warmup=3):
    """Median device time of ``fn`` over ``iters`` runs, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(label, kernel_fn, plain_fn, tol, timed=False):
    """Kernel against plain version on the same inputs; raises on a
    mismatch.  Returns (max abs error, kernel ms, plain ms)."""
    import torch
    out = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f'{label}: kernel gives {tuple(out.shape)} '
                             f'{out.dtype}, plain {tuple(ref.shape)} {ref.dtype}')
    if not torch.isfinite(out).all():
        raise AssertionError(f'{label}: kernel output is not finite')
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out, ref, **tol, msg=lambda m: f'{label}: {m}')
    ms = plain = None
    if timed:
        ms, plain = median_ms(kernel_fn), median_ms(plain_fn)
    times = f'  kernel {ms:.4f} ms  plain {plain:.4f} ms' if timed else ''
    log(f'  ok  {label}: max_abs_err {err:.3g} '
        f'(rtol {tol["rtol"]}, atol {tol["atol"]}){times}')
    return err, ms, plain


def phase_bias_act(dev, card):
    import torch
    from montage_gan_tpu_torch.ops import bias_act as ba
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(dtype)

    def case(label, x, b, tol, timed=False, **kw):
        return compare(label, lambda: ba.bias_act_cuda(x, b, **kw),
                       lambda: ba.bias_act_ref(x, b, **kw), tol, timed)

    log(f'[kernels] bias_act (K1\')  card: {card}')
    # The synthesis layers' epilogue at 256 px (bf16 blocks, 64 channels).
    main = case('[8,256,256,64] bf16 lrelu gain sqrt2 clamp 256',
                randn(8, 256, 256, 64, dtype=torch.bfloat16, scale=3.0),
                randn(64, dtype=torch.bfloat16), TOL_BF16, timed=True,
                act='lrelu', gain=math.sqrt(2), clamp=256.0)
    # An affine (style) layer, and the global mapping's last FC (512 x 9).
    case('[8,512] f32 linear', randn(8, 512), randn(512), TOL_F32,
         timed=True)
    case('[8,4608] f32 lrelu', randn(8, 4608), randn(4608), TOL_F32,
         timed=True, act='lrelu')
    # Odd shapes: every activation, C not a multiple of the vector width,
    # an unaligned view, no bias.
    for act in sorted(ba.activation_funcs):
        case(f'[3,5,7,13] f32 {act} clamp 0.5', randn(3, 5, 7, 13, scale=2.0),
             randn(13), TOL_F32, act=act, clamp=0.5)
    case('[2,9,11,6] bf16 selu', randn(2, 9, 11, 6, dtype=torch.bfloat16),
         randn(6, dtype=torch.bfloat16), TOL_BF16, act='selu')
    flat = randn(1 + 2 * 3 * 8)
    case('[2,3,8] f32 unaligned view, swish', flat[1:].view(2, 3, 8),
         randn(8), TOL_F32, act='swish')
    case('[4,1000] bf16 tanh no bias', randn(4, 1000, dtype=torch.bfloat16),
         None, TOL_BF16, act='tanh')
    return main


def phase_upfirdn2d(dev, card):
    import torch
    from montage_gan_tpu_torch.ops import filters
    from montage_gan_tpu_torch.ops import upfirdn2d as up
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    f2d = filters.setup_filter([1, 3, 3, 1], device=dev)           # [4, 4]
    f1d = filters.setup_filter([1, 2, 3, 4, 4, 3, 2, 1], device=dev)  # [8]

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    def case(label, x, f, tol, timed=False, **kw):
        return compare(label, lambda: up.upfirdn2d_cuda(x, f, **kw),
                       lambda: up.upfirdn2d_ref(x, f, **kw), tol, timed)

    log(f'[kernels] upfirdn2d (K2\')  card: {card}')
    # The ToRGB skip: upsample2d(img, [4,4] filter) = up 2, pad [2,1,2,1],
    # gain 4, on the 256 px nets' 128 px image.
    main = case('[8,128,128,4] f32 upsample2d 4x4 filter',
                randn(8, 128, 128, 4), f2d, TOL_F32_FIR, timed=True,
                up=2, padding=[2, 1, 2, 1], gain=4.0)
    case('[3,17,13,5] f32 down 2 pad 1', randn(3, 17, 13, 5), f2d,
         TOL_F32_FIR, down=2, padding=1)
    case('[2,9,11,3] f32 1-D 8 taps up 2 pad 3 gain 2', randn(2, 9, 11, 3),
         f1d, TOL_F32_FIR, up=2, padding=3, gain=2.0)
    case('[2,9,11,3] f32 1-D up [2,1] down [1,2] flip', randn(2, 9, 11, 3),
         f1d, TOL_F32_FIR, up=[2, 1], down=[1, 2], padding=[3, 4, -1, 2],
         flip_filter=True)
    case('[2,10,7,6] f32 crop pad [-1,2,0,-2]', randn(2, 10, 7, 6), f2d,
         TOL_F32_FIR, padding=[-1, 2, 0, -2])
    case('[2,33,31,3] bf16 upsample2d flip', randn(2, 33, 31, 3,
                                                   dtype=torch.bfloat16),
         f2d, TOL_BF16, up=2, padding=[2, 1, 2, 1], gain=4.0,
         flip_filter=True)
    return main


def expected_launches(model):
    """Launches one sampling call makes: one bias_act per FullyConnected,
    SynthesisLayer and ToRGBLayer forward; one upfirdn2d (the ToRGB skip
    upsample) per synthesis block above the first."""
    from montage_gan_tpu_torch.models.layers import FullyConnected
    from montage_gan_tpu_torch.models.synthesis import (SynthesisLayer,
                                                        ToRGBLayer)
    k1 = sum(isinstance(m, (FullyConnected, SynthesisLayer, ToRGBLayer))
             for m in model.modules())
    k2 = sum(len(net.block_resolutions) - 1 for net in model.local_g)
    return {'bias_act': k1, 'upfirdn2d': k2}


def seed_z(seeds, z_dim):
    """z as the generate CLI draws it, one row per seed."""
    import numpy as np
    return np.concatenate([np.random.RandomState(s).randn(1, z_dim)
                           for s in seeds]).astype(np.float32)


def perturb_zero_init(model, generator, scale):
    """Seeded values for the zero-initialised terms (biases, noise
    strengths, w_avg, the STN's last FC) so that each does work."""
    import torch
    with torch.no_grad():
        for name, t in model.named_parameters():
            if name.endswith(('bias', 'noise_strength')) or name.startswith(
                    'stn.fc_loc.2'):
                t.add_(torch.randn(t.shape, generator=generator) * scale)
        w_avg = model.mapping.w_avg
        w_avg.add_(torch.randn(w_avg.shape, generator=generator) * scale)


def phase_slice(card, kernels, cfg, device='cuda'):
    import torch
    from montage_gan_tpu_torch.models.ensemble import MontageEnsemble
    from montage_gan_tpu_torch.utils.serving import build_inference_fn

    log(f'[slice] config aio: {cfg.num_layers} layers, base '
        f'{cfg.base_resolution}, cci {cfg.conv_config_index}, z/w '
        f'{cfg.z_dim}/{cfg.w_dim}, {cfg.mapping_num_layers} mapping layers, '
        f'channel_base {cfg.channel_base}, channel_max {cfg.channel_max}, '
        f'num_fp16_res {cfg.num_fp16_res}, {cfg.stn_stages} STN stages, '
        f'batch {BATCH}')
    t0 = time.perf_counter()
    model = MontageEnsemble(cfg).init_weights(SEED)
    with torch.no_grad():    # the STN's zero-init head: a small seeded shift
        bias = model.stn.fc_loc[2].bias
        bias.copy_(torch.randn(bias.shape, generator=torch.Generator()
                               .manual_seed(SEED + 2)) * 0.05)
    model = model.to(device).eval().requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    log(f'  init {time.perf_counter() - t0:.1f} s, {n_params} parameters')

    fn = build_inference_fn(cfg, model, noise_mode='const')
    z = torch.from_numpy(seed_z(range(BATCH), cfg.z_dim)).to(device)
    t0 = time.perf_counter()
    fn(z)                                    # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    log(f'  first call {time.perf_counter() - t0:.2f} s')

    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    placed, img = fn(z)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    expect = expected_launches(model)
    log(f'  launches {launches}, expected {expect}')
    for name, n in launches.items():
        if n == 0 or n != expect[name]:
            raise AssertionError(f'{name}: {n} launches on the main path, '
                                 f'expected {expect[name]}')
    base = cfg.base_resolution
    if tuple(placed.shape) != (BATCH, cfg.num_layers, base, base, 4) or \
            tuple(img.shape) != (BATCH, base, base, 4):
        raise AssertionError(f'shapes placed {tuple(placed.shape)}, '
                             f'img {tuple(img.shape)}')
    if not (torch.isfinite(placed).all() and torch.isfinite(img).all()):
        raise AssertionError('non-finite output')
    # img: alpha is 1 - prod(1 - a) and lies in [0, 1]; the colour is a
    # ratio with alpha as its denominator, which rounding can push past 1
    # where alpha is tiny (the generate CLI clips), so it is checked
    # premultiplied: colour * alpha lies in [0, alpha] up to rounding.
    alpha = img[..., 3:]
    premult = img[..., :3] * alpha
    if placed.min() < -1 or placed.max() > 1 or alpha.min() < 0 or \
            alpha.max() > 1 or premult.min() < -1e-5 or \
            (premult - alpha).max() > 1e-5:
        raise AssertionError(
            f'output out of range: placed [{placed.min()}, {placed.max()}], '
            f'alpha [{alpha.min()}, {alpha.max()}], colour*alpha - alpha '
            f'max {(premult - alpha).max()}')
    if not img[..., 3].std() > 0:
        raise AssertionError('degenerate montage (constant alpha)')
    log(f'  outputs ok: placed {tuple(placed.shape)} in '
        f'[{placed.min().item():.3f}, {placed.max().item():.3f}], img '
        f'{tuple(img.shape)} in [{img.min().item():.3f}, '
        f'{img.max().item():.3f}], alpha mean {img[..., 3].mean().item():.4f}')

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn(z)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sec = statistics.median(times)
    log(f'  {BATCH / sec:.2f} images/s ({sec * 1e3:.1f} ms per batch of '
        f'{BATCH}, median of 5), peak memory {peak / 2**30:.2f} GiB  '
        f'card: {card}')
    return launches


def phase_cross_device(device='cuda'):
    import torch
    from montage_gan_tpu_torch.models.ensemble import (MontageConfig,
                                                       MontageEnsemble)
    from montage_gan_tpu_torch.utils.serving import build_inference_fn

    cfg = MontageConfig(**MICRO)
    log(f'[cross-device] micro ensemble {cfg.layer_targets}, base '
        f'{cfg.base_resolution}, float32: CPU (plain) against card (kernels)')
    cpu_model = MontageEnsemble(cfg).init_weights(SEED)
    perturb_zero_init(cpu_model, torch.Generator().manual_seed(SEED + 3), 0.1)
    cpu_model.eval().requires_grad_(False)
    card_model = copy.deepcopy(cpu_model).to(device)
    z = torch.from_numpy(seed_z(range(2), cfg.z_dim))
    ref = build_inference_fn(cfg, cpu_model, truncation_psi=0.7)(z)
    out = build_inference_fn(cfg, card_model, truncation_psi=0.7)(z.to(device))
    for name, a, b in zip(('placed', 'img'), out, ref):
        err = (a.cpu() - b).abs().max().item()
        torch.testing.assert_close(a.cpu(), b, **TOL_CROSS,
                                   msg=lambda m: f'{name}: {m}')
        log(f'  ok  {name} {tuple(a.shape)}: max_abs_err {err:.3g} '
            f'(atol {TOL_CROSS["atol"]})')


def main():
    if not os.path.isdir(os.path.join(REPO, 'montage_gan_tpu_torch', 'csrc')):
        sys.exit('chip_smoke.py: montage_gan_tpu_torch/ is not beside this '
                 'script; run it from a checkout of the repository')
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        sys.exit('chip_smoke.py: no CUDA device; this run needs the card')

    from montage_gan_tpu_torch import set_fp32_precision
    from montage_gan_tpu_torch.models.ensemble import MontageConfig
    from montage_gan_tpu_torch.ops import bias_act, cuda, upfirdn2d

    set_fp32_precision()
    card = card_line()
    log(f'[device] {torch.cuda.get_device_name(0)}, '
        f'{torch.cuda.device_count()} visible; torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}; card: {card}')

    t0 = time.perf_counter()
    paths = cuda.build()
    log(f'[build] {", ".join(p.name for p in paths.values())} in '
        f'{time.perf_counter() - t0:.1f} s (nvcc {" ".join(cuda.NVCC_FLAGS)})')
    for name, out in cuda.BUILD_LOGS.items():
        for line in out.splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'  {name}: {line.strip()}')

    kernels = {'bias_act': bias_act.kernel, 'upfirdn2d': upfirdn2d.kernel}
    checks = {'bias_act': phase_bias_act('cuda', card),
              'upfirdn2d': phase_upfirdn2d('cuda', card)}
    launches = phase_slice(card, kernels, MontageConfig())
    phase_cross_device()

    sources = {'bias_act': ('montage_gan_tpu_torch/csrc/bias_act.cu',
                            'montage_gan_tpu/ops/pallas/bias_act_kernel.py:39'),
               'upfirdn2d': ('montage_gan_tpu_torch/csrc/upfirdn2d.cu',
                             'montage_gan_tpu/ops/pallas/upfirdn2d_kernel.py:222')}
    log(json.dumps({'kernels': [
        {'name': name, 'route': 'cuda', 'source': sources[name][0],
         'replaces': sources[name][1], 'launches': launches[name],
         'max_abs_err': checks[name][0], 'ms': checks[name][1],
         'plain_ms': checks[name][2]} for name in kernels]}))
    log(card_line())
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
