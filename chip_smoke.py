#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``montage_gan_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; each raises on failure, and the script then exits non-zero:

1. device: a CUDA card is required; the run never falls back to the CPU.
2. build: ``nvcc`` builds every kernel of ``montage_gan_tpu_torch/csrc/`` for
   ``sm_90a``, one process per source, all started together.
3. kernels: K1' bias_act and K2' upfirdn2d against their plain PyTorch
   versions on the card, at the main paths' shapes and at odd ones, with TF32
   off, each variant of both (K1': vector, scalar; K2': up2, down2,
   generic) with the variant the wrapper took checked.  Times (here and
   below) are device times per call with L2 cold
   (``montage_gan_tpu_torch/tools/timing.py::device_ms``): 256 MB read
   before each call, CUDA events around the call alone, the samples queued
   behind a sleep kernel so the host's launch time is hidden; the median of
   25 samples.
4. warp: K3' against the plain warp (upsample, then gather) at the training
   path's main shape and geometries, a 45° rotation, a zoom 2, C = 3 and a
   singular theta, the adjoint identity of K4' and K4' against the plain
   version's gradient; each kernel twice on the same inputs, bit for bit;
   the share of blocks that took the direct path; the two-call yardstick
   (F.conv_transpose2d + F.grid_sample) at the main shape.
5. grads: the K1' gradient kernel (orders 1 and 2, float32 and bfloat16)
   and K2''s backward against autograd of the plain versions.
6. slice: the full-width config ``aio`` sampling path (mapping -> 9 synthesis
   nets -> STN -> alpha composite) at batch 8 through ``build_inference_fn``,
   with seeded random weights, and its exact launch counts.
7. cross-device: a micro ensemble sampled on the CPU (plain versions) and on
   the card (kernels) with the same weights.
8. train: 5 steps of the full-width local-phase training step (9 local Gs
   and Ds, the ADA pipe, Gmain/Greg/Dmain/Dr1, Adam, EMA, ADA) at batch 8
   through ``MontageTrainer``, with seeded weights and synthetic reals, and
   the exact launch counts of all five kernels over the 5 steps.
9. train cross-device: the four local losses and their gradients on a micro
   ensemble, CPU (plain) against the card (kernels), same weights and draws.
10. composite: K5' (translate and composite) driven once through
   ``translate_and_composite_fused`` on the full-width sampling path's
   layer stack and STN shifts at [8, 9, 256, 256, 4] (one launch, tiled),
   then against its plain version there and at odd shapes, shifts (on
   integers of t·W/2 and one ulp off) and fills, four column tiles, one
   layer and a base pointer off 16-byte alignment (the direct variant),
   each twice, bit for bit; timed beside ``F.grid_sample`` +
   ``alpha_composite``, with the host's time per call.
11. aio train: 5 steps of the full-width all-in-one training step (the
   renderer phase, the local phases, global Gmain/Dmain/R1 through the STN,
   the tanh renderer and the global D, EMA, ADA over 10 lanes) at batch 8
   through ``MontageTrainer`` with ``TrainHyper()`` defaults, with the exact
   launch counts of K1'-K4' over the 5 steps, K1''s, K2''s, K3''s and K4''s
   launches by variant (K2''s generic variant and the warp's direct one
   never run there), the bytes each
   kernel's launches moved, and one more step split by phase.
12. aio cross-device: the global Gmain, Dmain and R1 losses and the renderer
   loss with their gradients on a micro ensemble with a tanh renderer and a
   global D, CPU (plain) against the card (kernels).

Each main path (6, 8, 10 and 11) is driven with every launch count set to
0 just before it and read just after.  The last two lines are the card's name and
power limit (from ``nvidia-smi``) and one JSON object, ``{"ok": true,
"device": {...}}``; the line before them is ``{"kernels": [...]}``.
"""

import copy
import json
import math
import os
import statistics
import sys
import time

from montage_gan_tpu_torch.tools.timing import (PEAK_BYTES, card_line, device_ms,
                                                host_us)

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
# The warp: the same taps and weights, summed in another order (the plain
# version builds the upsample first); inputs are O(1).
TOL_WARP = dict(rtol=1e-5, atol=1e-5)
# Training losses and gradients, card against CPU, float32: the losses
# within 1e-4; every gradient entry within 1e-3 of the phase's largest
# gradient entry.  The scale is the phase's, not each tensor's: R1's bias
# gradients are small next to the phase's others and ill-conditioned
# (through a leaky ReLU network the input gradient is piecewise constant in
# the biases).  The run prints the CPU's own spread when its weights move
# by 1e-6 relative beside the card's error.
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GRAD = 1e-3

# K5' against its plain version: the same taps and lerp weights, the
# A-over-B recurrence against the closed form.  The colour is compared
# premultiplied by alpha: the plain version divides Σ c·a·T by
# 1 - Π(1 - a), whose absolute rounding error of a few ulps of 1 becomes a
# large relative error where alpha is small (5.9e-3 against float64 at
# alpha 1.9e-6 on a test input); the recurrence has no such cancellation.
TOL_COMPOSITE = dict(rtol=1e-5, atol=1e-6)

# H100 SXM peak float32 FLOP/s outside the tensor cores (NVIDIA's data
# sheet), for the bounds beside PEAK_BYTES.
PEAK_F32 = 67e12
TRAIN_STEPS = 5

MICRO = dict(layer_names=('a', 'b', 'c'),
             layer_targets=((32, 32), (32, 32), (16, 8)),
             base_resolution=32, img_channels=4, conv_config_index=2,
             z_dim=32, w_dim=32, mapping_num_layers=2, channel_base=512,
             channel_max=32, num_fp16_res=0, conv_clamp=256,
             renderer_type='none', stn_stages=2)


MICRO_AIO = {**MICRO, 'renderer_type': 'tanh', 'mbstd_group_size': 2}


def log(msg=''):
    print(msg, flush=True)


def bound(nbytes, flops):
    """(least ms, what bounds it): bytes over the memory rate against
    float32 operations over the peak rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def backward_ms(out, inp, cotangent):
    """Median time of autograd's backward alone through an already built
    graph (the plain version of a backward kernel)."""
    import torch
    return device_ms(lambda: torch.autograd.grad(out, inp, cotangent,
                                                 retain_graph=True))


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
        ms, plain = device_ms(kernel_fn), device_ms(plain_fn)
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

    def variant_of(label, x, b, **kw):
        """The variant the wrapper takes for these inputs (one launch)."""
        before = dict(ba.kernel.variants)
        ba.bias_act_cuda(x, b, **kw)
        got = [k for k, n in ba.kernel.variants.items()
               if n != before.get(k, 0)]
        log(f'      {label}: variant {got[0]}')
        return got[0]

    log(f'[kernels] bias_act (K1\')  card: {card}')
    # The synthesis layers' epilogue at 256 px (bf16 blocks, 64 channels).
    x = randn(8, 256, 256, 64, dtype=torch.bfloat16, scale=3.0)
    b = randn(64, dtype=torch.bfloat16)
    kw = dict(act='lrelu', gain=math.sqrt(2), clamp=256.0)
    main = case('[8,256,256,64] bf16 lrelu gain sqrt2 clamp 256', x, b,
                TOL_BF16, timed=True, **kw)
    if variant_of('[8,256,256,64] bf16', x, b, **kw) != 'vector':
        raise AssertionError('K1\' takes the vector variant at its main '
                             'shape')
    # The 128 px blocks' epilogue (128 channels).
    x = randn(8, 128, 128, 128, dtype=torch.bfloat16, scale=3.0)
    b = randn(128, dtype=torch.bfloat16)
    case('[8,128,128,128] bf16 lrelu gain sqrt2 clamp 256', x, b, TOL_BF16,
         timed=True, **kw)
    variant_of('[8,128,128,128] bf16', x, b, **kw)
    # An affine (style) layer, and the global mapping's last FC (512 x 9).
    x, b = randn(8, 512), randn(512)
    case('[8,512] f32 linear', x, b, TOL_F32, timed=True)
    variant_of('[8,512] f32', x, b)
    case('[8,4608] f32 lrelu', randn(8, 4608), randn(4608), TOL_F32,
         timed=True, act='lrelu')
    # The vector variant at odd channel counts: C above a block's vectors;
    # grids that stride over 3.0M and 6.3M vectors with a channel step of
    # 24 (not 0) per stride; no bias at a length of no whole rows.
    for shape, dtype, act, bias in (
            ((2, 64, 9000), torch.float32, 'relu', True),
            ((600_000, 40), torch.bfloat16, 'selu', True),
            ((700_000, 36), torch.float32, 'tanh', True),
            (((1 << 20) + 4,), torch.float32, 'elu', False)):
        x = randn(*shape, dtype=dtype, scale=2.0)
        b = randn(shape[-1], dtype=dtype) if bias else None
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        label = f'{list(shape)} {str(dtype)[6:]} {act}' + (
            '' if bias else ' no bias')
        case(label, x, b, tol, act=act, clamp=0.5 if act == 'tanh' else None)
        if variant_of(label, x, b, act=act) != 'vector':
            raise AssertionError(f'{label}: expected the vector variant')
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
    import torch.nn.functional as F
    from montage_gan_tpu_torch.ops import filters
    from montage_gan_tpu_torch.ops import upfirdn2d as up
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    f2d = filters.setup_filter([1, 3, 3, 1], device=dev)           # [4, 4]
    f1d = filters.setup_filter([1, 2, 3, 4, 4, 3, 2, 1], device=dev)  # [8]

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    def case(label, x, f, tol, timed=False, variant=None, **kw):
        before = dict(up.kernel.variants)
        got = compare(label, lambda: up.upfirdn2d_cuda(x, f, **kw),
                      lambda: up.upfirdn2d_ref(x, f, **kw), tol, timed)
        took = {k for k, n in up.kernel.variants.items()
                if n != before.get(k, 0)}
        if variant is not None and took != {variant}:
            raise AssertionError(f'{label}: took {took}, expected {variant}')
        return got

    log(f'[kernels] upfirdn2d (K2\')  card: {card}')
    # The ToRGB skip: upsample2d(img, [4,4] filter) = up 2, pad [2,1,2,1],
    # gain 4, on the 256 px nets' 128 px image.
    main = case('[8,128,128,4] f32 upsample2d 4x4 filter',
                randn(8, 128, 128, 4), f2d, TOL_F32_FIR, timed=True,
                variant='up2', up=2, padding=[2, 1, 2, 1], gain=4.0)
    # Its gradient: the same filter flipped, down 2, pad 1, from the 256 px
    # image's cotangent.
    dy = randn(8, 256, 256, 4)
    down = case('[8,256,256,4] -> [8,128,128,4] f32 down 2 (the skip\'s '
                'gradient)', dy, f2d, TOL_F32_FIR, timed=True,
                variant='down2', down=2, padding=1, gain=4.0,
                flip_filter=True)
    w = (f2d * 4.0)[None, None].repeat(4, 1, 1, 1)
    dyc = dy.permute(0, 3, 1, 2)

    def lib():
        return F.conv2d(dyc, w, stride=2, padding=1, groups=4)
    torch.testing.assert_close(
        lib().permute(0, 2, 3, 1),
        up.upfirdn2d_cuda(dy, f2d, down=2, padding=1, gain=4.0,
                          flip_filter=True), **TOL_F32_FIR)
    lib_ms = device_ms(lib)
    log(f'  library: depthwise F.conv2d stride 2 {lib_ms:.4f} ms (same '
        f'downsample)')
    backward = (*down, *bound(nbytes(dy) * 5 // 4, 8 * 4 * dy.numel() // 4),
                lib_ms)
    # Edge cases of the tiled variants: H and W not multiples of the tile,
    # C = 3 and 5, bfloat16, a 1-D filter of 4 taps, a footprint above 48 KB.
    f1d4 = filters.setup_filter([1, 3, 3, 1], separable=True, device=dev)
    for label, x, f, kw, v in (
            ('[3,37,23,4] f32 up 2', randn(3, 37, 23, 4), f2d,
             dict(up=2, padding=[2, 1, 2, 1], gain=4.0), 'up2'),
            ('[3,74,46,4] f32 down 2', randn(3, 74, 46, 4), f2d,
             dict(down=2, padding=1, gain=4.0), 'down2'),
            ('[2,33,31,3] f32 up 2 C=3', randn(2, 33, 31, 3), f2d,
             dict(up=2, padding=[2, 1, 2, 1], gain=4.0), 'up2'),
            ('[2,35,29,5] f32 down 2 C=5', randn(2, 35, 29, 5), f2d,
             dict(down=2, padding=1), 'down2'),
            ('[2,20,9,5] f32 up 2 1-D 4 taps', randn(2, 20, 9, 5), f1d4,
             dict(up=2, padding=[2, 1, 2, 1], gain=4.0), 'up2'),
            ('[2,20,18,20] f32 down 2 C=20 (> 48 KB)', randn(2, 20, 18, 20),
             f2d, dict(down=2, padding=1), 'down2')):
        case(label, x, f, TOL_F32_FIR, variant=v, **kw)
    for label, x, kw, v in (
            ('[2,33,31,4] bf16 up 2', (2, 33, 31, 4),
             dict(up=2, padding=[2, 1, 2, 1], gain=4.0), 'up2'),
            ('[2,33,31,8] bf16 up 2 flip (16-byte pixels)', (2, 33, 31, 8),
             dict(up=2, padding=[2, 1, 2, 1], gain=4.0, flip_filter=True),
             'up2'),
            ('[2,70,66,3] bf16 down 2', (2, 70, 66, 3),
             dict(down=2, padding=1), 'down2')):
        case(label, randn(*x, dtype=torch.bfloat16), f2d, TOL_BF16,
             variant=v, **kw)
    case('[3,17,13,5] f32 down 2 pad 1', randn(3, 17, 13, 5), f2d,
         TOL_F32_FIR, variant='down2', down=2, padding=1)
    case('[2,9,11,3] f32 1-D 8 taps up 2 pad 3 gain 2', randn(2, 9, 11, 3),
         f1d, TOL_F32_FIR, variant='generic', up=2, padding=3, gain=2.0)
    case('[2,9,11,3] f32 1-D up [2,1] down [1,2] flip', randn(2, 9, 11, 3),
         f1d, TOL_F32_FIR, variant='generic', up=[2, 1], down=[1, 2],
         padding=[3, 4, -1, 2], flip_filter=True)
    case('[2,10,7,6] f32 crop pad [-1,2,0,-2]', randn(2, 10, 7, 6), f2d,
         TOL_F32_FIR, variant='generic', padding=[-1, 2, 0, -2])
    case('[2,33,31,3] bf16 upsample2d flip', randn(2, 33, 31, 3,
                                                   dtype=torch.bfloat16),
         f2d, TOL_BF16, variant='up2', up=2, padding=[2, 1, 2, 1], gain=4.0,
         flip_filter=True)
    return main, backward


def library_upsample_ms(dev):
    """The yardstick of K2' at its main shape: one depthwise
    ``F.conv_transpose2d`` (stride 2, padding 1) computes the same upsample
    (checked here); the port never calls it."""
    import torch
    import torch.nn.functional as F
    from montage_gan_tpu_torch.ops import filters
    from montage_gan_tpu_torch.ops import upfirdn2d as up
    x = torch.randn(8, 128, 128, 4, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    f2d = filters.setup_filter([1, 3, 3, 1], device=dev)
    w = (f2d * 4.0)[None, None].repeat(4, 1, 1, 1)
    xc = x.permute(0, 3, 1, 2)

    def lib():
        return F.conv_transpose2d(xc, w, stride=2, padding=1, groups=4)
    ref = up.upfirdn2d_cuda(x, f2d, up=2, padding=[2, 1, 2, 1], gain=4.0)
    torch.testing.assert_close(lib().permute(0, 2, 3, 1), ref, **TOL_F32_FIR)
    ms = device_ms(lib)
    log(f'  library: depthwise conv_transpose2d {ms:.4f} ms (same upsample)')
    return ms


def library_warp(x, theta, taps, oh, ow):
    """The warp's yardstick in two PyTorch calls: a depthwise
    ``F.conv_transpose2d`` (stride 2, padding k0 = 5, the 4·f⊗f kernel:
    ``upsample2d``'s ×2 upsample) and ``F.grid_sample`` on the plain
    version's grid (built outside the timed region).  The port never calls
    them.  Returns (forward, its output, input NCHW)."""
    import torch.nn.functional as F
    from montage_gan_tpu_torch.ops.grid_sample import affine_grid
    n, _, _, c = x.shape
    t = taps.shape[0]
    k0 = t - 1 - (t + 1) // 2
    w = (4.0 * taps[:, None] * taps[None, :])[None, None].repeat(c, 1, 1, 1)
    grid = affine_grid(theta, oh, ow)
    xc = x.permute(0, 3, 1, 2).contiguous()

    def two_calls(v=xc):
        up = F.conv_transpose2d(v, w, stride=2, padding=k0, groups=c)
        return F.grid_sample(up, grid, mode='bilinear', padding_mode='zeros',
                             align_corners=False)
    return two_calls, xc


def phase_warp(dev, card):
    """K3' against the plain warp, K4''s adjoint identity and K4' against
    the plain version's gradient, at the training path's shapes and at
    geometries that send blocks down the direct path (a 45° rotation, a
    zoom 2) or every block (C = 3, a singular theta); each kernel twice on
    the same inputs, bit for bit; the share of blocks that took the direct
    path; at the main shape the times, and the two-call library
    yardstick."""
    import torch
    from montage_gan_tpu_torch.ops import affine_warp as aw
    from montage_gan_tpu_torch.training import augment as aug
    from montage_gan_tpu_torch.training.draws import Draws

    log(f'[warp] K3\' forward, K4\' transpose  card: {card}')
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    cfg = aug.make_augment_config('bgcfnc')
    taps = aug._HZ_GEOM.to(dev)
    out = {}

    def thetas(kind, n, h, w):
        if kind == 'sampled':        # the pipe's own law at p = aug_p_max
            theta, ph, pw, oh, ow = aug.sample_warp_theta(
                Draws(gen), 0.6, cfg, n, h, w, device=dev)
            return theta.contiguous(), ph, pw, oh, ow
        _, _, _, ph, pw, oh, ow = aug._warp_geometry(cfg, h, w)
        theta = torch.eye(2, 3, device=dev).repeat(n, 1, 1)
        if kind == 'off_plane':
            theta = theta * 1.3
            theta[:, :, 2] = torch.tensor([0.7, -0.6], device=dev)
        elif kind == 'rotate 45':
            c = math.cos(math.pi / 4)
            theta[:] = torch.tensor([[c, -c, 0.1], [c, c, -0.05]], device=dev)
        elif kind == 'zoom 2':
            theta = theta * 2.0
            theta[:, :, 2] = torch.tensor([0.3, -0.2], device=dev)
        elif kind == 'singular':
            theta[:] = torch.tensor([[0.8, 0.2, 0.0], [0.4, 0.1, 0.2]],
                                    device=dev)
        return theta.contiguous(), ph, pw, oh, ow

    def blocks(plan):
        return plan.grid[0] * plan.grid[1] * plan.grid[2]

    for kind, n, (h, w), c in (('sampled', 16, (256, 256), 4),
                               ('sampled', 16, (64, 32), 4),
                               ('identity', 16, (64, 32), 4),
                               ('off_plane', 16, (256, 256), 4),
                               ('rotate 45', 16, (256, 256), 4),
                               ('zoom 2', 16, (256, 256), 4),
                               ('sampled', 4, (64, 32), 3),
                               ('singular', 2, (16, 16), 4)):
        main = kind == 'sampled' and h == 256
        theta, ph, pw, oh, ow = thetas(kind, n, h, w)
        x = torch.rand(n, ph, pw, c, device=dev, generator=gen) * 2 - 1
        g = torch.randn(n, oh, ow, c, device=dev, generator=gen)
        label = f'[{n},{ph},{pw},{c}] -> [{n},{oh},{ow},{c}] {kind}'
        fwd = compare(f'K3\' {label}',
                      lambda: aw.warp_forward_cuda(x, theta, oh, ow, 2, taps),
                      lambda: aw.affine_warp_ref(x, theta, oh, ow, 2, taps),
                      TOL_WARP, timed=main)
        # each kernel twice, with the count of blocks that took the direct
        # path: the same bits
        counts = torch.zeros(2, dtype=torch.int32, device=dev)
        y = aw.warp_forward_cuda(x, theta, oh, ow, 2, taps, counts[0:1])
        dx = aw.warp_transpose_cuda(g, theta, ph, pw, 2, taps, counts[1:2])
        if not (torch.equal(y, aw.warp_forward_cuda(x, theta, oh, ow, 2, taps))
                and torch.equal(dx, aw.warp_transpose_cuda(g, theta, ph, pw,
                                                           2, taps))):
            raise AssertionError(f'{label}: two runs of K3\' or K4\' differ')
        plans = [aw.warp_plan(k, n, (ph, pw), (oh, ow), c, taps.shape[0], 2)
                 for k in ('forward', 'transpose')]
        direct = [int(v) for v in counts.tolist()]
        log(f'  ok  {label}: K3\' and K4\' each give the same bits twice; '
            f'direct path K3\' {direct[0]}/{blocks(plans[0])} blocks, K4\' '
            f'{direct[1]}/{blocks(plans[1])} ({plans[0].variant}, '
            f'{plans[1].variant})')
        # the adjoint identity <K3 x, g> = <x, K4 g>, in float64 sums
        lhs = (y.double() * g.double()).sum().item()
        rhs = (x.double() * dx.double()).sum().item()
        rel = abs(lhs - rhs) / max(abs(lhs), 1e-30)
        if not rel <= 1e-5:
            raise AssertionError(f'K4\' {label}: <K3 x, g> = {lhs}, '
                                 f'<x, K4 g> = {rhs}, relative {rel:.3g}')
        log(f'  ok  K4\' {label}: adjoint identity relative error {rel:.3g}'
            ' (limit 1e-5)')
        # K4' against autograd of the plain version
        xr = x.clone().requires_grad_(True)
        yr = aw.affine_warp_ref(xr, theta, oh, ow, 2, taps)
        ref, = torch.autograd.grad(yr, xr, g, retain_graph=True)
        err = (dx - ref).abs().max().item()
        scale = ref.abs().max().item()
        torch.testing.assert_close(dx, ref, rtol=1e-5, atol=1e-5 * scale,
                                   msg=lambda m: f'K4\' {label}: {m}')
        line = f'  ok  K4\' {label}: max_abs_err {err:.3g} ' \
            f'(rtol 1e-5, atol {1e-5 * scale:.3g})'
        if main:
            t_ms = device_ms(lambda: aw.warp_transpose_cuda(g, theta, ph, pw,
                                                            2, taps))
            t_plain = backward_ms(yr, xr, g)
            line += f'  kernel {t_ms:.4f} ms  plain (autograd backward) ' \
                f'{t_plain:.4f} ms'
            # the two-call yardstick, forward and its autograd; it rounds
            # the coordinates in another order (one float32 step of a
            # coordinate near 800 is 6e-5 pixel), so it is held loosely
            two_calls, xc = library_warp(x, theta, taps, oh, ow)
            lib = two_calls().permute(0, 2, 3, 1)
            torch.testing.assert_close(lib, y, rtol=0, atol=1e-3)
            xl = xc.clone().requires_grad_(True)
            yl = two_calls(xl)
            gl = g.permute(0, 3, 1, 2).contiguous()
            dl, = torch.autograd.grad(yl, xl, gl, retain_graph=True)
            torch.testing.assert_close(dl.permute(0, 2, 3, 1), dx, rtol=0,
                                       atol=1e-3 * scale)
            two_fwd, two_bwd = device_ms(two_calls), backward_ms(yl, xl, gl)
            flops = 2 * 49 * n * oh * ow * 4        # <= 7x7 taps per output
            out['warp_forward'] = (fwd[0], fwd[1], fwd[2],
                                   *bound(nbytes(x, y), flops), None)
            out['warp_transpose'] = (err, t_ms, t_plain,
                                     *bound(nbytes(g, dx), flops), None)
            out['two_calls'] = {'warp_forward': two_fwd,
                                'warp_transpose': two_bwd}
            out['direct_share'] = {'warp_forward': direct[0] / blocks(plans[0]),
                                   'warp_transpose': direct[1] / blocks(plans[1])}
            out['host_us'] = {
                'warp_forward': host_us(lambda: aw.warp_forward_cuda(
                    x, theta, oh, ow, 2, taps)),
                'warp_transpose': host_us(lambda: aw.warp_transpose_cuda(
                    g, theta, ph, pw, 2, taps))}
            log(f'  bound at the main shape: {out["warp_forward"][3]:.4f} ms '
                f'({out["warp_forward"][4]}; {nbytes(x, y) / 1e6:.1f} MB, '
                f'{flops / 1e9:.2f} GFLOP); two calls (F.conv_transpose2d + '
                f'F.grid_sample) {two_fwd:.4f} ms, their autograd backward '
                f'{two_bwd:.4f} ms; host us per call K3\' '
                f'{out["host_us"]["warp_forward"]:.1f}, K4\' '
                f'{out["host_us"]["warp_transpose"]:.1f}  card: {card}')
        log(line)
    return out


def phase_grads(dev, card):
    """The K1' gradient kernel, orders 1 and 2, and K2''s backward, against
    autograd of the plain versions."""
    import torch
    from montage_gan_tpu_torch.ops import bias_act as ba
    from montage_gan_tpu_torch.ops import filters
    from montage_gan_tpu_torch.ops import upfirdn2d as up

    log(f'[grads] K1\' grad (orders 1, 2), K2\' backward  card: {card}')
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen)
                * scale).to(dtype)

    def orders(fn, x, b):
        """Order 1 of <fn(x, b)^2, r> and order 2 (<grad_x, s>)."""
        x = x.clone().requires_grad_(True)
        b = b.clone().requires_grad_(True)
        out = fn(x, b)
        r = torch.ones_like(out, dtype=torch.float32)
        g1 = torch.autograd.grad((out.float().square() * r).sum(), (x, b),
                                 create_graph=True)
        g2 = torch.autograd.grad((g1[0].float()).sum(), (x, b),
                                 allow_unused=True)
        return [t for t in g1 + g2 if t is not None]

    def case(label, x, b, tol, **kw):
        ref = orders(lambda x, b: ba.bias_act_ref(x, b, **kw), x, b)
        got = orders(lambda x, b: ba.bias_act(x, b, **kw), x, b)
        if x.dtype == torch.float32:
            err = 0.0
            for a, r in zip(got, ref):
                err = max(err, (a - r).abs().max().item())
                torch.testing.assert_close(a, r, **tol,
                                           msg=lambda m: f'{label}: {m}')
            log(f'  ok  {label} orders 1, 2: max_abs_err {err:.3g} '
                f'(rtol {tol["rtol"]}, atol {tol["atol"]})')
            return
        # bfloat16: the plain version rounds at every step and its order-2
        # sums cancel, so both are held to the float32 truth: the kernels no
        # further from it than twice the plain version, plus 1e-2 of the
        # tensor's largest entry.
        truth = orders(lambda x, b: ba.bias_act_ref(x, b, **kw), x.float(), b)
        worst = 0.0
        for a, r, t in zip(got, ref, truth):
            dk = (a.float() - t).abs().max().item()
            dp = (r.float() - t).abs().max().item()
            limit = 2 * dp + 1e-2 * t.abs().max().item()
            if not dk <= limit:
                raise AssertionError(f'{label}: kernels {dk:.3g} from the '
                                     f'float32 truth, plain {dp:.3g}')
            worst = max(worst, dk / max(limit, 1e-30))
        log(f'  ok  {label} orders 1, 2: against the float32 truth at most '
            f'{worst:.3g} of the limit (2x plain + 1e-2 of max)')

    # order 1 of the main path's epilogue, timed: g * gain * lrelu'(y) masked
    x = randn(8, 256, 256, 64, dtype=torch.bfloat16, scale=3.0)
    b = randn(64)
    kw = dict(act='lrelu', gain=math.sqrt(2), clamp=256.0)
    xr = x.clone().requires_grad_(True)
    yr = ba.bias_act_ref(xr, b, **kw)
    y = ba.bias_act_cuda(x, b, **kw)
    dy = randn(8, 256, 256, 64, dtype=torch.bfloat16)
    main = compare('[8,256,256,64] bf16 lrelu order 1 (dy, y -> dx)',
                   lambda: ba.bias_act_grad_cuda(dy, None, None, y, **kw),
                   lambda: torch.autograd.grad(yr, xr, dy,
                                               retain_graph=True)[0],
                   TOL_BF16)
    t_ms = device_ms(lambda: ba.bias_act_grad_cuda(dy, None, None, y, **kw))
    t_plain = backward_ms(yr, xr, dy)
    log(f'  [8,256,256,64] bf16 order 1: kernel {t_ms:.4f} ms  plain '
        f'(autograd backward) {t_plain:.4f} ms  card: {card}')
    out = {'bias_act_grad': (main[0], t_ms, t_plain,
                             *bound(nbytes(dy, y, dy), 4 * dy.numel()),
                             None)}
    for dtype, tol in ((torch.float32, dict(rtol=1e-5, atol=1e-5)),
                       (torch.bfloat16, None)):
        name = 'f32' if dtype == torch.float32 else 'bf16'
        case(f'[8,256,256,64] {name} lrelu clamp 256',
             randn(8, 256, 256, 64, dtype=dtype, scale=3.0), randn(64), tol,
             act='lrelu', gain=math.sqrt(2), clamp=256.0)
        case(f'[8,512] {name} lrelu (mapping FC)', randn(8, 512, dtype=dtype),
             randn(512), tol, act='lrelu')
        for act in sorted(ba.activation_funcs):
            case(f'[3,5,7,16] {name} {act} clamp 1.5',
                 randn(3, 5, 7, 16, dtype=dtype, scale=2.0), randn(16), tol,
                 act=act, clamp=1.5 if dtype == torch.float32 else None)
        case(f'[8,256,256,64] {name} swish (act\'\' != 0)',
             randn(8, 256, 256, 64, dtype=dtype), randn(64), tol, act='swish')

    # K2' backward: K2' with transposed parameters
    f2d = filters.setup_filter([1, 3, 3, 1], device=dev)
    f1d = filters.setup_filter([1, 2, 3, 4, 4, 3, 2, 1], device=dev)
    for label, shape, f, kw in (
            ('[8,128,128,4] upsample2d 4x4', (8, 128, 128, 4), f2d,
             dict(up=2, padding=[2, 1, 2, 1], gain=4.0)),
            ('[3,17,13,5] down 2 pad 1', (3, 17, 13, 5), f2d,
             dict(down=2, padding=1)),
            ('[2,9,11,3] 1-D up [2,1] down [1,2] flip', (2, 9, 11, 3), f1d,
             dict(up=[2, 1], down=[1, 2], padding=[3, 4, -1, 2],
                  flip_filter=True))):
        x = randn(*shape)
        xr = x.clone().requires_grad_(True)
        yr = up.upfirdn2d_ref(xr, f, **kw)
        g = torch.randn_like(yr)
        xk = x.clone().requires_grad_(True)
        yk = up.upfirdn2d(xk, f, **kw)
        got = compare(f'K2\' backward {label}',
                      lambda: torch.autograd.grad(yk, xk, g,
                                                  retain_graph=True)[0],
                      lambda: torch.autograd.grad(yr, xr, g,
                                                  retain_graph=True)[0],
                      TOL_F32_FIR)
        if shape[1] == 128:
            out['upfirdn2d_backward'] = got
    return out


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


def expected_train_launches(model, hyper, steps):
    """Launches of ``steps`` training steps from step 0, per kernel, from the
    module structure.  Per local layer (G: S synthesis layers, T ToRGBs, A
    style affines, B blocks; D: nD bias_act layers, Lb of them in the
    blocks; M mapping FCs, twice with style mixing):

    * K1' forward: one per bias_act a forward runs.  Gmain M + G + D;
      Greg M + G; Dmain M + G + 2 D (fakes and reals apart); Dr1 D.
    * K1' grad: one per backward of a bias_act whose activation is not the
      identity (the affines and D's last FC are linear with gain 1, no
      clamp: their backward is the identity).  Gmain: D (nD - 1), G (S + T),
      M.  Greg: inner grad S + T; outer: each synthesis layer's order-1 node
      (S) and forward node (S: the style gradient reads its output), and M.
      The ToRGBs' inner nodes see the constant path-length noise and record
      nothing.  Dmain: 2 (nD - 1).  Dr1: inner nD - 1, outer nD - 1 for the
      order-1 nodes and Lb for the block layers' forward nodes (the
      minibatch-std's gradient reads the blocks' output).
    * K2' (forward and backward): B - 1 per G forward; Gmain's backward
      B - 1; Greg's inner grad B - 1 (its outer pass reads none).
    * K3': the augmented forward in Gmain (B), Dmain (2B) and Dr1, and the
      backward of K4' in Dr1's outer pass.  K4': Gmain's backward and Dr1's
      inner grad.

    The renderer and global phases run every local G once per global
    forward (all layers: M + G each, and B - 1 K2'), and the global D (nD,
    Lb of its own) as a local D is run: the renderer phase one global
    forward without gradients; global Gmain a global forward, the D, and
    the backward of both (no renderer, STN or composite op launches a
    kernel); global Dmain a global forward without gradients and the D on
    fakes and reals, augmented together at 2B; global R1 the D's Dr1.  The
    global pipe's warp runs as in the local phases."""
    from montage_gan_tpu_torch.models.layers import (Conv2dLayer,
                                                     FullyConnected)
    from montage_gan_tpu_torch.models.synthesis import (SynthesisLayer,
                                                        ToRGBLayer)

    def count(module, kinds):
        return sum(isinstance(m, kinds) for m in module.modules())

    def d_counts(d):
        return (count(d, (Conv2dLayer, FullyConnected)),
                sum(count(b, Conv2dLayer) for b in d.blocks()))

    def has_warp(aug):
        return int(aug is not None and (aug.any_blit or aug.any_geom))

    warp = has_warp(hyper.augment if not hyper.local_noaug else None)
    gwarp = has_warp(hyper.augment if not hyper.global_noaug else None)
    m = model.mapping.num_layers * (2 if hyper.style_mixing_prob > 0 else 1)
    g_fwd = g_grad = g_up = 0        # one global forward: all local Gs
    for g in model.local_g:
        s, t = count(g, SynthesisLayer), count(g, ToRGBLayer)
        g_fwd += m + s + t + count(g, FullyConnected)
        g_grad += m + s + t
        g_up += len(g.block_resolutions) - 1
    use_r = not hyper.bypass_renderer and model.renderer is not None
    renderer = int(hyper.train_renderer and use_r)
    glob = int(hyper.train_global and model.stn is not None)
    out = dict.fromkeys(('bias_act', 'bias_act_grad', 'upfirdn2d',
                         'warp_forward', 'warp_transpose'), 0)
    for step in range(steps):
        greg = int(hyper.g_reg_interval is not None and hyper.pl_weight != 0
                   and step % hyper.g_reg_interval == 0)
        dr1 = int(hyper.d_reg_interval is not None and hyper.r1_gamma != 0
                  and step % hyper.d_reg_interval == 0)
        for g, d in zip(model.local_g, model.local_d):
            if not hyper.train_local:
                break
            s, t = count(g, SynthesisLayer), count(g, ToRGBLayer)
            n_g = s + t + count(g, FullyConnected)
            blocks = len(g.block_resolutions)
            n_d, lb = d_counts(d)
            out['bias_act'] += ((m + n_g + n_d) + greg * (m + n_g)
                                + (m + n_g + 2 * n_d) + dr1 * n_d)
            out['bias_act_grad'] += ((n_d - 1 + s + t + m)
                                     + greg * (3 * s + t + m)
                                     + 2 * (n_d - 1)
                                     + dr1 * (2 * (n_d - 1) + lb))
            out['upfirdn2d'] += (blocks - 1) * (2 + 2 * greg + 1)
            out['warp_forward'] += warp * (2 + 2 * dr1)
            out['warp_transpose'] += warp * (1 + dr1)
        out['bias_act'] += renderer * g_fwd
        out['upfirdn2d'] += renderer * g_up
        if not glob:
            continue
        goi = hyper.global_optimize_interval
        n_d, lb = d_counts(model.global_d)
        main = int(step % goi == 0)
        gr1 = int(hyper.d_reg_interval is not None
                  and hyper.global_r1_gamma != 0
                  and step % (hyper.d_reg_interval * goi) == 0)
        out['bias_act'] += (main * ((g_fwd + n_d) + (g_fwd + 2 * n_d))
                            + gr1 * n_d)
        out['bias_act_grad'] += (main * ((n_d - 1 + g_grad) + 2 * (n_d - 1))
                                 + gr1 * (2 * (n_d - 1) + lb))
        out['upfirdn2d'] += main * 3 * g_up
        out['warp_forward'] += gwarp * (2 * main + 2 * gr1)
        out['warp_transpose'] += gwarp * (main + gr1)
    return out


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
        k.reset()
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
    return model, z


def premultiplied(img):
    """RGBA with the colour multiplied by alpha."""
    import torch
    return torch.cat([img[..., :3] * img[..., 3:], img[..., 3:]], -1)


def phase_composite(card, model, z):
    """K5' driven once on the sampling path's unplaced layer stack (mapped
    to [0, 1]) and its STN shifts, then held to its plain version there and
    at odd cases (shifts where t·W/2 lies on an integer or one ulp off it,
    several column tiles, H and W not multiples of the tile, one layer, a
    base pointer off 16-byte alignment), each twice, bit for bit, with the
    variant it took; timed, with the host's time per call."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from montage_gan_tpu_torch.ops import composite as comp
    from montage_gan_tpu_torch.ops.grid_sample import translate_to_theta
    from montage_gan_tpu_torch.utils.image_utils import normalize_zero1

    with torch.no_grad():
        stack = model.synthesize_layers(model.mapping(z), noise_mode='const')
        _, theta = model.stn(stack)
    layers = normalize_zero1(stack).clamp(0, 1).contiguous()
    shifts = theta[..., 2].contiguous()                     # [B, L, 2]
    b, l, h, w, _ = layers.shape
    log(f'[composite] K5\' translate and composite  [{b},{l},{h},{w},4] '
        f'f32, shifts in [{shifts.min().item():.4f}, '
        f'{shifts.max().item():.4f}]  card: {card}')
    comp.kernel.reset()
    img = comp.translate_and_composite_fused(layers, shifts)
    torch.cuda.synchronize()
    launches, variants = comp.kernel.launches, dict(comp.kernel.variants)
    if launches != 1 or variants != {'tiled': 1} or \
            tuple(img.shape) != (b, h, w, 4) or not torch.isfinite(img).all():
        raise AssertionError(f'composite: {launches} launches {variants}, '
                             f'{tuple(img.shape)}')

    def case(label, x, t, pad, variant='tiled'):
        ref = comp.translate_and_composite_ref(x, t, pad)
        comp.kernel.reset()
        got = comp.translate_and_composite_cuda(x, t, pad)
        again = comp.translate_and_composite_cuda(x, t, pad)
        torch.cuda.synchronize()
        if dict(comp.kernel.variants) != {variant: 2}:
            raise AssertionError(f'{label}: launches by variant '
                                 f'{dict(comp.kernel.variants)}, expected '
                                 f'{variant}')
        if not torch.equal(got, again):
            raise AssertionError(f'{label}: two runs of K5\' differ')
        straight = (got - ref).abs().max().item()
        err = compare(f'{label} pad {pad} ({variant}, twice the same bits; '
                      'colour premultiplied)', lambda: premultiplied(got),
                      lambda: premultiplied(ref), TOL_COMPOSITE)[0]
        log(f'      straight colour max_abs_err {straight:.3g}')
        return err

    err = case(f'[{b},{l},{h},{w},4] sampling stack', layers, shifts, 0.0)
    t_ms = device_ms(lambda: comp.translate_and_composite_cuda(layers,
                                                               shifts))
    t_plain = device_ms(lambda: comp.translate_and_composite_ref(layers,
                                                                 shifts))
    t_host = host_us(lambda: comp.translate_and_composite_cuda(layers,
                                                               shifts))
    # two calls that compute the same function for pad 0 (the grid and the
    # NCHW copy are made outside the timed region); a check that they do,
    # loosely: grid_sample computes its coordinates in another order
    nchw = layers.reshape(b * l, h, w, 4).permute(0, 3, 1, 2).contiguous()
    grid = F.affine_grid(translate_to_theta(shifts.clamp(-1, 1)).reshape(
        b * l, 2, 3), [b * l, 4, h, w], align_corners=False)

    def two_calls():
        moved = F.grid_sample(nchw, grid, mode='bilinear',
                              padding_mode='zeros', align_corners=False)
        return comp.alpha_composite(moved.permute(0, 2, 3, 1).reshape(
            b, l, h, w, 4))
    torch.testing.assert_close(premultiplied(two_calls()), premultiplied(img),
                               rtol=0, atol=1e-3)
    t_two = device_ms(two_calls)
    moved = comp.needed_bytes(layers.shape, shifts.cpu())
    bound_ms, bound_by = bound(moved, 70 * layers.numel() // 4)
    log(f'  kernel {t_ms:.4f} ms  plain {t_plain:.4f} ms  F.grid_sample + '
        f'alpha_composite {t_two:.4f} ms  bound {bound_ms:.4f} ms '
        f'({bound_by}; {moved / 1e6:.2f} MB that some tap reads, the '
        f'shifts and the output)  host us per call {t_host:.1f}  '
        f'card: {card}')

    gen = torch.Generator(device='cuda').manual_seed(SEED + 9)
    x = torch.rand(3, 5, 67, 45, 4, device='cuda', generator=gen)
    x[:, 2, ..., 3] = 0.0                       # one layer with alpha 0
    t = torch.tensor([[1.0, -1.0], [-1.0, 1.0], [1.7, -2.3], [0.0, 0.0],
                      [-0.31, 0.77]], device='cuda')
    t = t[None].repeat(3, 1, 1)
    t[1] = torch.rand(5, 2, device='cuda', generator=gen) * 3 - 1.5
    for pad in (0.0, 0.3):
        case('[3,5,67,45,4] shifts +-1, beyond +-1, 0; alpha-0 layer', x, t,
             pad)
    # t·W/2 and t·H/2 on an integer, and one float32 ulp either side
    rng = np.random.RandomState(SEED + 9)
    nb, nl, nh, nw = 2, 6, 40, 72
    k = np.stack([rng.randint(-nw // 2, nw // 2 + 1, (nb, nl)) / (nw / 2),
                  rng.randint(-nh // 2, nh // 2 + 1, (nb, nl)) / (nh / 2)],
                 -1).astype(np.float32)
    k[:, 0::3] = np.nextafter(k[:, 0::3], np.float32(2))
    k[:, 1::3] = np.nextafter(k[:, 1::3], np.float32(-2))
    x = torch.rand(nb, nl, nh, nw, 4, device='cuda', generator=gen)
    case(f'[{nb},{nl},{nh},{nw},4] shifts on integers and one ulp off', x,
         torch.from_numpy(k).cuda(), 0.0)
    x = torch.rand(2, 3, 64, 1000, 4, device='cuda', generator=gen)
    t = torch.rand(2, 3, 2, device='cuda', generator=gen) * 2.4 - 1.2
    case('[2,3,64,1000,4] four column tiles', x, t, 0.0)
    x = torch.rand(4, 1, 33, 50, 4, device='cuda', generator=gen)
    t = torch.rand(4, 1, 2, device='cuda', generator=gen) * 2.4 - 1.2
    case('[4,1,33,50,4] one layer', x, t, 0.3)
    # a base pointer 4 bytes off 16-byte alignment: the direct variant
    buf = torch.rand(3 * 5 * 67 * 45 * 4 + 1, device='cuda', generator=gen)
    x = buf[1:].view(3, 5, 67, 45, 4)
    t = torch.rand(3, 5, 2, device='cuda', generator=gen) * 3 - 1.5
    case('[3,5,67,45,4] storage offset 4 bytes', x, t, 0.0, variant='direct')
    return {'composite': (err, t_ms, t_plain, bound_ms, bound_by, None)}, \
        launches, {'variants': variants, 'host_us': t_host,
                   'two_calls_ms': t_two}


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


def train_setup(cfg, hyper, device, seed=SEED):
    """A trainer with seeded weights, and synthetic reals as the local Ds
    take them: per-layer centred crops in [-1, 1]."""
    import numpy as np
    from montage_gan_tpu_torch.data.synthetic import synthetic_batch
    from montage_gan_tpu_torch.models.ensemble import MontageEnsemble
    from montage_gan_tpu_torch.training.train_step import MontageTrainer
    from montage_gan_tpu_torch.utils.image_utils import \
        make_batch_for_local_d_np
    model = MontageEnsemble(cfg, with_d=True)
    trainer = MontageTrainer(model, hyper, device=device)
    state = trainer.init_state(seed)
    stack01 = synthetic_batch(np.random.RandomState(seed), hyper.batch_size,
                              cfg.num_layers, cfg.base_resolution)
    crops = make_batch_for_local_d_np(stack01, cfg.layer_targets,
                                      to_minus11=True)
    return trainer, state, stack01 * 2.0 - 1.0, crops


def check_moved(model, before, skip=()):
    """Raises unless every parameter (but those named ``skip*``) moved from
    ``before``."""
    import torch
    still = [k for k, v in model.named_parameters()
             if torch.equal(v.detach(), before[k]) and not k.startswith(skip)]
    if still:
        raise AssertionError(f'{len(still)} parameters did not move: '
                             f'{still[:5]}')


def phase_train(card, kernels, cfg, device='cuda'):
    """5 full-width local-phase steps at batch 8: step 0 runs all four
    phases, step 4 Greg again, and the ADA controller fires after step 3."""
    import torch
    from montage_gan_tpu_torch.training.augment import make_augment_config
    from montage_gan_tpu_torch.training.train_step import TrainHyper

    hyper = TrainHyper(batch_size=BATCH, train_global=False,
                       train_renderer=False,
                       augment=make_augment_config('bgcfnc'),
                       augment_p_init=0.6)
    log(f'[train] config aio local phases (train_global=False): '
        f'{cfg.num_layers} local G/D pairs, batch {BATCH}, augment bgcfnc at '
        f'p {hyper.augment_p_init}, g_reg every {hyper.g_reg_interval}, '
        f'd_reg every {hyper.d_reg_interval}, ADA every {hyper.ada_interval}')
    t0 = time.perf_counter()
    trainer, state, stack, crops = train_setup(cfg, hyper, device)
    model = trainer.ens
    n_params = sum(p.numel() for p in model.parameters())
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    crops = [torch.from_numpy(c).to(device) for c in crops]
    log(f'  init {time.perf_counter() - t0:.1f} s, {n_params} parameters '
        f'(G side and {cfg.num_layers} local Ds)')
    gen = torch.Generator(device=device).manual_seed(SEED)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.reset()
    times = []
    for step in range(TRAIN_STEPS):
        phases = ['Gmain'] + (['Greg'] if step % hyper.g_reg_interval == 0
                              else []) + ['Dmain'] + (
            ['Dr1'] if step % hyper.d_reg_interval == 0 else [])
        t0 = time.perf_counter()
        state, stats = trainer.train_step(state, stack, crops, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        bad = [k for k, v in stats.items() if not torch.isfinite(v).all()]
        if bad:
            raise AssertionError(f'step {step}: non-finite stats {bad}')
        first = cfg.layer_names[0]
        log(f'  step {step}: {times[-1] * 1e3:.1f} ms, phases '
            f'{"+".join(phases)} per layer, {first} G loss '
            f'{stats[f"{first}/Loss/G/loss"].item():.4f} D loss '
            f'{stats[f"{first}/Loss/D/loss"].item():.4f}')
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    expect = expected_train_launches(model, hyper, TRAIN_STEPS)
    log(f'  launches over {TRAIN_STEPS} steps {launches}, expected {expect}')
    log_variants(kernels)
    for name, n in launches.items():
        if n == 0 or n != expect[name]:
            raise AssertionError(f'{name}: {n} launches on the training path, '
                                 f'expected {expect[name]}')
    check_moved(model, before, skip=('renderer.',))   # not trained here
    if state.step != TRAIN_STEPS or not torch.isfinite(state.pl_mean).all():
        raise AssertionError(f'state after the steps: step {state.step}, '
                             f'pl_mean {state.pl_mean}')
    mid = statistics.median(times[1:4])
    log(f'  every parameter moved; aug_p {state.aug_p.tolist()}, pl_mean '
        f'{[round(v, 4) for v in state.pl_mean.tolist()]}')
    log(f'  steps 1-3 (Gmain+Dmain): median {mid * 1e3:.1f} ms, '
        f'{BATCH / mid:.2f} images/s; peak memory {peak / 2**30:.2f} GiB  '
        f'card: {card}')
    return launches


def log_variants(kernels):
    """K1''s and K2''s launches by variant, and the bytes of every kernel's
    launches (each input read once, each output written once)."""
    for name in ('bias_act', 'upfirdn2d'):
        log(f'  {name} launches by variant {dict(kernels[name].variants)}')
    log('  bytes moved (GB) ' + ', '.join(
        f'{name} {k.bytes / 1e9:.3f}' for name, k in kernels.items()))


def cpu_draws(seed, device):
    """Draws made on one CPU generator and moved to ``device``: the same
    numbers for a CPU run and a card run."""
    import torch
    from montage_gan_tpu_torch.training.draws import Draws

    class CpuDraws(Draws):
        def normal(self, shape, kind):
            return super().normal(shape, kind).to(device)

        def uniform(self, shape, kind):
            return super().uniform(shape, kind).to(device)
    return CpuDraws(torch.Generator().manual_seed(seed))


def spread(grads, ref_grads):
    """(largest entry difference, worst tensor) over a phase's gradients,
    relative to the phase's largest entry."""
    import torch
    # autograd gives None where the other path may give structural zeros
    pairs = [(i, torch.zeros_like(r) if g is None else g,
              torch.zeros_like(g) if r is None else r)
             for i, (g, r) in enumerate(zip(grads, ref_grads))
             if g is not None or r is not None]
    scale = max(max(r.abs().max().item() for _, _, r in pairs), 1e-12)
    errs = [((g - r).abs().max().item() / scale, i) for i, g, r in pairs]
    return max(errs)


def nudged_copy(model):
    """A copy of ``model`` with every weight moved by 1e-6 relative: the
    CPU against it gives the float32 spread of a phase's gradients."""
    import torch
    nudged = copy.deepcopy(model)
    with torch.no_grad():
        for i, p in enumerate(nudged.parameters()):
            p.mul_(1 + 1e-6 * torch.randn(
                p.shape, generator=torch.Generator().manual_seed(i)))
    return nudged


def check_phase(phase, run, cpu, card, nudged, device):
    """A phase's loss and gradients, card against CPU; raises beyond
    ``TOL_TRAIN_LOSS`` / ``TOL_TRAIN_GRAD``."""
    ref_loss, ref_grads = run(cpu, 'cpu', phase)
    loss, grads = run(card, device, phase)
    if not abs(loss.item() - ref_loss.item()) <= TOL_TRAIN_LOSS:
        raise AssertionError(f'{phase}: loss {loss.item()} on the card, '
                             f'{ref_loss.item()} on the CPU')
    worst, at = spread(grads, ref_grads)
    floor, _ = spread(run(nudged, 'cpu', phase)[1], ref_grads)
    if not worst <= TOL_TRAIN_GRAD:
        raise AssertionError(f'{phase}: gradient {at} differs by '
                             f'{worst:.3g} of the phase\'s largest entry')
    log(f'  ok  {phase}: loss {loss.item():.6f} (CPU {ref_loss.item():.6f},'
        f' atol {TOL_TRAIN_LOSS}); gradients within {worst:.3g} of the '
        f'phase\'s largest entry (limit {TOL_TRAIN_GRAD}; CPU with '
        f'weights moved 1e-6: {floor:.3g})')


def phase_train_cross_device(device='cuda'):
    """The four local losses and their gradients on a float32 micro
    ensemble: CPU (plain versions) against the card (kernels)."""
    import torch
    from montage_gan_tpu_torch.models.ensemble import MontageConfig
    from montage_gan_tpu_torch.training import losses
    from montage_gan_tpu_torch.training.augment import make_augment_config
    from montage_gan_tpu_torch.training.train_step import TrainHyper

    cfg = MontageConfig(**{**MICRO, 'train_global': False,
                           'mbstd_group_size': 2})
    hyper = TrainHyper(batch_size=4, train_global=False, train_renderer=False,
                       augment=make_augment_config('bgcfnc'))
    log(f'[train cross-device] micro ensemble {cfg.layer_targets}, float32, '
        'augment bgcfnc at p 0.6: CPU (plain) against card (kernels)')
    trainer, _, _, crops = train_setup(cfg, hyper, 'cpu', seed=SEED + 6)
    cpu = trainer.ens
    with torch.no_grad():
        for name, p in cpu.named_parameters():     # zero-init terms do work
            if name.endswith(('bias', 'noise_strength')):
                p.add_(torch.randn(p.shape, generator=torch.Generator()
                                   .manual_seed(len(name))) * 0.1)
    card = copy.deepcopy(cpu).to(device)
    layer = 2                                     # the non-square one
    z = torch.randn(4, cfg.z_dim, generator=torch.Generator().manual_seed(7))
    real = torch.from_numpy(crops[layer])

    def run(model, dev, phase):
        draws = cpu_draws(SEED + 8, dev)
        aug, p = hyper.augment, 0.6
        if phase == 'Gmain':
            loss, _ = losses.local_gmain_loss(model, layer, z.to(dev), draws,
                                              aug, p)
        elif phase == 'Greg':
            loss, _, _ = losses.local_gpl_loss(model, layer, z.to(dev), draws,
                                               torch.tensor(0.1, device=dev))
        elif phase == 'Dmain':
            loss, _, _ = losses.local_dmain_loss(model, layer, z.to(dev),
                                                 real.to(dev), draws, aug, p)
        else:
            loss, _, _ = losses.local_dr1_loss(model, layer, real.to(dev),
                                               draws, aug, p)
        params = (list(model.local_d[layer].parameters())
                  if phase.startswith('D') else
                  list(model.mapping.parameters())
                  + list(model.local_g[layer].parameters()))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach().cpu(), [None if g is None else g.cpu()
                                     for g in grads]

    nudged = nudged_copy(cpu)
    for phase in ('Gmain', 'Greg', 'Dmain', 'Dr1'):
        check_phase(phase, run, cpu, card, nudged, device)


def phase_aio_train(card, kernels, cfg, device='cuda'):
    """5 full-width AIO steps at batch 8 with ``TrainHyper()`` defaults:
    every step runs the renderer phase, Gmain and Dmain of each layer, and
    global Gmain and Dmain; step 0 also Greg, Dr1 and global R1, step 4
    Greg; the ADA controller fires after step 3.  Then one step with a
    synchronisation after each phase, for the split."""
    import torch
    from montage_gan_tpu_torch.tools.profile import phase_split
    from montage_gan_tpu_torch.training.augment import make_augment_config
    from montage_gan_tpu_torch.training.train_step import TrainHyper

    hyper = TrainHyper(batch_size=BATCH,
                       augment=make_augment_config('bgcfnc'),
                       augment_p_init=0.6)
    log(f'[aio train] config aio, all phases: renderer {cfg.renderer_type}, '
        f'{cfg.num_layers} local G/D pairs, STN, global D at '
        f'{cfg.base_resolution} (init_res {cfg.base_init_res}), batch '
        f'{BATCH}, augment bgcfnc at p {hyper.augment_p_init}, global every '
        f'{hyper.global_optimize_interval}, g_reg every '
        f'{hyper.g_reg_interval}, d_reg every {hyper.d_reg_interval}')
    t0 = time.perf_counter()
    trainer, state, stack, crops = train_setup(cfg, hyper, device)
    model = trainer.ens
    n_params = sum(p.numel() for p in model.parameters())
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    crops = [torch.from_numpy(c).to(device) for c in crops]
    stack = torch.from_numpy(stack).float().to(device)
    log(f'  init {time.perf_counter() - t0:.1f} s, {n_params} parameters')
    gen = torch.Generator(device=device).manual_seed(SEED)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.reset()
    times = []
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, stats = trainer.train_step(state, stack, crops, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        bad = [k for k, v in stats.items() if not torch.isfinite(v).all()]
        if bad:
            raise AssertionError(f'step {step}: non-finite stats {bad}')
        first = cfg.layer_names[0]
        reg = ' (with Greg, Dr1, global R1)' if step == 0 else (
            ' (with Greg)' if step % hyper.g_reg_interval == 0 else '')
        log(f'  step {step}{reg}: {times[-1] * 1e3:.1f} ms; renderer loss '
            f'{stats["Renderer/loss_gen"].item():.4f} + '
            f'{stats["Renderer/loss_real"].item():.4f}, global G loss '
            f'{stats["global/Loss/G/loss"].item():.4f}, global D loss '
            f'{stats["global/Loss/D/loss"].item():.4f}, {first} G loss '
            f'{stats[f"{first}/Loss/G/loss"].item():.4f}')
        if step == 0:
            log(f'    global R1 penalty '
                f'{stats["global/Loss/r1_penalty"].item():.6g}, theta '
                f'constraint {stats["global/Loss/STN/theta_constrain"]}')
    launches = {name: k.launches for name, k in kernels.items()}
    variants = {name: dict(k.variants) for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    expect = expected_train_launches(model, hyper, TRAIN_STEPS)
    log(f'  launches over {TRAIN_STEPS} steps {launches}, expected {expect}')
    log_variants(kernels)
    for name, n in launches.items():
        if n == 0 or n != expect[name]:
            raise AssertionError(f'{name}: {n} launches on the AIO path, '
                                 f'expected {expect[name]}')
    if variants['upfirdn2d'].get('generic', 0) != 0:
        raise AssertionError('K2\' took its generic variant on the AIO path: '
                             f'{variants["upfirdn2d"]}')
    for name in ('warp_forward', 'warp_transpose'):
        if variants[name].get('direct', 0) != 0:
            raise AssertionError(f'{name} took its direct variant on the AIO '
                                 f'path: {variants[name]}')
    check_moved(model, before)
    if state.step != TRAIN_STEPS or not torch.isfinite(
            model.mapping.w_avg).all():
        raise AssertionError(f'state after the steps: step {state.step}')
    ema_names = {k for k, _ in state.ema.named_parameters()}
    if any(k.startswith(('renderer.', 'global_d.', 'local_d.'))
           for k in ema_names) or not any(k.startswith('stn.')
                                          for k in ema_names):
        raise AssertionError('the EMA holds other modules than the mapping, '
                             'the local Gs and the STN')
    mid = statistics.median(times[1:4])
    log(f'  every parameter moved (renderer, global D, STN included); aug_p '
        f'{[round(v, 6) for v in state.aug_p.tolist()]}')
    log(f'  steps 1-3: median {mid * 1e3:.1f} ms, {BATCH / mid:.2f} '
        f'images/s; step 0 {times[0] * 1e3:.1f} ms, step 4 '
        f'{times[4] * 1e3:.1f} ms; peak memory {peak / 2**30:.2f} GiB  '
        f'card: {card}')
    split = phase_split(lambda: trainer.train_step(state, stack, crops, gen),
                        1)
    log('  step 5 by phase (synchronised after each; ms): ' + ', '.join(
        f'{k} {v:.1f}' for k, v in split.items()))
    return launches, variants


def phase_aio_cross_device(device='cuda'):
    """The renderer loss and the global Gmain, Dmain and R1 losses with
    their gradients on a float32 micro ensemble with a tanh renderer and a
    global D: CPU (plain versions) against the card (kernels)."""
    import torch
    from montage_gan_tpu_torch.models.ensemble import MontageConfig
    from montage_gan_tpu_torch.training import losses
    from montage_gan_tpu_torch.training.augment import make_augment_config
    from montage_gan_tpu_torch.training.train_step import TrainHyper

    cfg = MontageConfig(**MICRO_AIO)
    hyper = TrainHyper(batch_size=4, augment=make_augment_config('bgcfnc'))
    log(f'[aio cross-device] micro ensemble {cfg.layer_targets}, base '
        f'{cfg.base_resolution}, tanh renderer, global D, float32, augment '
        'bgcfnc at p 0.6: CPU (plain) against card (kernels)')
    trainer, _, stack, _ = train_setup(cfg, hyper, 'cpu', seed=SEED + 10)
    cpu = trainer.ens
    with torch.no_grad():
        for name, p in cpu.named_parameters():     # zero-init terms do work
            if name.endswith(('bias', 'noise_strength')) or \
                    name.startswith('stn.fc_loc.2'):
                p.add_(torch.randn(p.shape, generator=torch.Generator()
                                   .manual_seed(len(name))) * 0.1)
    card = copy.deepcopy(cpu).to(device)
    z = torch.randn(4, cfg.z_dim, generator=torch.Generator().manual_seed(11))
    real = torch.from_numpy(stack).float()
    trained = {'renderer': ('renderer.',), 'global Gmain': (
        'mapping.', 'local_g.', 'stn.'), 'global Dmain': ('global_d.',),
        'global Dr1': ('global_d.',)}

    def run(model, dev, phase):
        draws = cpu_draws(SEED + 12, dev).scoped('global_')
        aug, p = hyper.augment, 0.6
        if phase == 'renderer':
            loss, _ = losses.renderer_loss(model, z.to(dev), real.to(dev),
                                           draws)
        elif phase == 'global Gmain':
            loss, _ = losses.global_gmain_loss(model, z.to(dev), draws, aug,
                                               p)
        elif phase == 'global Dmain':
            loss, _, _ = losses.global_dmain_loss(model, z.to(dev),
                                                  real.to(dev), draws, aug, p)
        else:
            loss, _, _ = losses.global_dr1_loss(model, real.to(dev), draws,
                                                aug, p)
        params = [p for k, p in model.named_parameters()
                  if k.startswith(trained[phase])]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach().cpu(), [None if g is None else g.cpu()
                                     for g in grads]

    nudged = nudged_copy(cpu)
    for phase in trained:
        check_phase(phase, run, cpu, card, nudged, device)


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
    from montage_gan_tpu_torch.ops import affine_warp, bias_act, cuda, upfirdn2d

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

    kernels = {'bias_act': bias_act.kernel,
               'bias_act_grad': bias_act.grad_kernel,
               'upfirdn2d': upfirdn2d.kernel,
               'warp_forward': affine_warp.forward_kernel,
               'warp_transpose': affine_warp.transpose_kernel}
    # (max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms) at the
    # main path's shape
    k1 = phase_bias_act('cuda', card)
    x = torch.empty(8, 256, 256, 64, dtype=torch.bfloat16)
    checks = {'bias_act': (*k1, *bound(2 * nbytes(x), 5 * x.numel()), None)}
    k2, k2_backward = phase_upfirdn2d('cuda', card)
    x = torch.empty(8, 128, 128, 4)
    checks['upfirdn2d'] = (*k2, *bound(5 * nbytes(x), 8 * 4 * x.numel()),
                           library_upsample_ms('cuda'))
    warp = phase_warp('cuda', card)
    warp_extra = {k: warp.pop(k) for k in ('two_calls', 'direct_share',
                                           'host_us')}
    checks.update(warp)
    grads = phase_grads('cuda', card)
    checks['bias_act_grad'] = grads['bias_act_grad']

    slice_kernels = {k: kernels[k] for k in ('bias_act', 'upfirdn2d')}
    model, z = phase_slice(card, slice_kernels, MontageConfig())
    composite_check, composite_launches, composite_extra = phase_composite(
        card, model, z)
    checks.update(composite_check)
    del model
    phase_cross_device()
    phase_train(card, kernels, MontageConfig(train_global=False))
    phase_train_cross_device()
    launches, variants = phase_aio_train(card, kernels, MontageConfig())
    launches['composite'] = composite_launches
    phase_aio_cross_device()

    sources = {
        'bias_act': ('bias_act.cu', 'bias_act_kernel.py:39'),
        'bias_act_grad': ('bias_act.cu', 'bias_act_kernel.py:39'),
        'upfirdn2d': ('upfirdn2d.cu', 'upfirdn2d_kernel.py:222'),
        'warp_forward': ('warp.cu', 'warp_kernel.py:274'),
        'warp_transpose': ('warp.cu', 'warp_kernel.py:384'),
        'composite': ('composite.cu', 'composite_kernel.py:80')}
    rows = []
    for name in [*kernels, 'composite']:
        err, ms, plain, bound_ms, bound_by, lib = checks[name]
        src, rep = sources[name]
        rows.append({'name': name, 'route': 'cuda',
                     'source': f'montage_gan_tpu_torch/csrc/{src}',
                     'replaces': f'montage_gan_tpu/ops/pallas/{rep}',
                     'launches': launches[name], 'max_abs_err': err,
                     'ms': ms, 'plain_ms': plain, 'bound_ms': bound_ms,
                     'bound_by': bound_by, 'library_ms': lib})
        if name in ('bias_act', 'upfirdn2d', 'warp_forward',
                    'warp_transpose'):
            rows[-1]['launches_by_variant'] = variants[name]
        if name == 'composite':
            # its main-path launch by variant, the host's time per call and
            # F.grid_sample + alpha_composite, at the main shape
            rows[-1]['launches_by_variant'] = composite_extra['variants']
            rows[-1]['host_us'] = composite_extra['host_us']
            rows[-1]['two_calls_ms'] = composite_extra['two_calls_ms']
        if name.startswith('warp_'):
            # F.conv_transpose2d + F.grid_sample (their autograd backward
            # for K4'), the share of blocks that took the direct path and
            # the host's time per call, at the main shape
            rows[-1]['two_calls_ms'] = warp_extra['two_calls'][name]
            rows[-1]['direct_share'] = warp_extra['direct_share'][name]
            rows[-1]['host_us'] = warp_extra['host_us'][name]
    # K2''s gradient at its main shape (down2), beside the forward's row
    err, ms, plain, bound_ms, bound_by, lib = k2_backward
    rows[[r['name'] for r in rows].index('upfirdn2d')]['backward'] = {
        'shape': '[8,256,256,4] -> [8,128,128,4] f32 down 2',
        'max_abs_err': err, 'ms': ms, 'plain_ms': plain,
        'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': lib}
    log(json.dumps({'kernels': rows}))
    log(card_line())
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
