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
13. loop: the training CLI and loop at the reference's batch 32, config
   ``aio``, in a temporary directory outside the repository (deleted at the
   end): a synthetic dataset of 64 samples (9 layers, 256 px) written by
   the port's PNG writer, which picks PIL's row filters (the rows of each
   filter type counted; Up and Paeth rows required); the prefetcher alone
   (samples/s, at least 5x the loop's images/s); ``cli/train_aio.main`` for
   one step with ``--batch-gpu 16`` (its files, finite stats, and the exact
   launches of K1'-K4' in the accumulated step and its EMA grid), its
   train-state snapshot restored into a fresh trainer and checked bit for
   bit against the state the run returned; ``training_loop`` for 6 steps
   with and without ``--batch-gpu`` (images/s of steps 2-6, the data wait,
   peak memory; without it "does not fit" is reported, not raised); the
   CLI again with ``--resume`` (one more step from the saved one);
   ``cli/generate`` for 8 seeds from the EMA snapshot; every snapshot's
   bytes and save and restore seconds, as the runs' ``log.txt`` report
   them.
14. ddp: the data-parallel step (``tools/ddp_check.py::check_rank``) at
   config ``aio`` on every visible card through an NCCL process group (on
   one card: one rank, in this process, so every collective still runs),
   8 images a rank: in float32 (the bf16 blocks round differently at
   another batch size), 2 steps in 2 accumulation rounds, every
   regularizer at step 0, learning rates 0 (so each phase reads the
   initial weights): rank 0 first takes the step in one process at the
   global batch, then with its weights moved by 1e-6 relative; each
   phase's gradients, reduced over the ranks, are held to the first within
   the larger of 1e-3 of the phase's largest entry and ten times the moved
   step's spread, the step's losses within the larger of rtol 2e-3, atol
   2e-4 and ten times theirs; each rank's launches of
   K1'-K4' exactly; the ranks' train states identical
   (``assert_replicated``); then config ``aio`` as it trains: a step
   timed, and the NCCL kernels' time in one more, profiled step.
15. metrics: on the loop phase's dataset, with seeded random InceptionV3
   and VGG16-LPIPS ``.npz`` files in a drop-in directory (so
   ``build_extractor('auto')`` runs the real architectures): each detector
   on the card against the CPU; ``calc_metric('fid2k')`` at config
   ``aio``'s widths end to end, after one of its batch-16 samples through
   K1' and K2' is held to the plain route on the card (its seconds split
   into the dataset, the 2000 generated images and the Frechet distance;
   the generator's and InceptionV3's images/s at batch 16; K1' and K2'
   launched exactly 125
   sampling calls' counts); KID, PR and IS at 512 generated images and
   ppl2_wend at 256 samples; ``cli/train_aio --metrics fid2k`` for one step
   at batch 8 at the micro ensemble's widths (the metric's contract; its
   cost is the fid2k above), its ``metric-fid2k.jsonl`` and
   ``Metrics/fid2k`` checked; the phase's peak memory.
16. tools: on phase 13's EMA snapshot (kept; it holds the tanh renderer)
   and dataset, with phase 15's random-weight VGG16 in the drop-in
   directory: ``cli/style_mixing`` 4x4; ``cli/projector`` for 10 steps on
   one composite of the dataset with the VGG16-LPIPS distance (seconds a
   step, the first and last distance); one projector step on the micro
   ensemble, CPU (plain versions) against the card (kernels), same weights
   and draws (loss within 1e-4 relative, gradients within 1e-3 of the
   largest entry); ``cli/generate --projected-w`` of the projection and
   ``--composite renderer`` for 8 seeds; ``cli/export_model`` (seconds,
   bytes; no launch while tracing), the artifact loaded (seconds), its
   graph's ``mgt`` nodes, and its program at batch 8 and 3 against direct
   execution (rtol 2e-4, atol 2e-5) with images/s beside direct
   execution's; ``cli/compare_renderers`` over the 64 samples (PSNR,
   samples/s); the host's microseconds for one ``mgt::bias_act`` operator
   call against a direct launch of K1'.  Every tool's launches of K1',
   K1' grad and K2' are held exactly to ``tools/launches.py``
   (``expected_launches``, ``expected_projector_launches``).
17. interop and stage 0: a reference SG2-ADA ``.pkl`` of config ``aio``'s
   largest layer (256 px RGBA, z/w 512, channel_base 16384, bfloat16 at
   the top 4 resolutions), written from seeded weights (unconditional, and
   with ``c_dim`` 10): ``cli/generate`` of 8 seeds (and ``--class 3``), one
   batch through K1'/K2' held to the plain route (float32 blocks within
   ``TOL_CROSS``; bfloat16 blocks by ``TOL_METRIC_RATIO``),
   ``cli/convert_pickle`` and ``generate`` of its snapshot, bit for bit;
   ``cli/export_torch --format pth`` of phase 13's EMA snapshot (bytes,
   seconds), read back by ``torch_import.load_aio_snapshot`` and sampled bit
   for bit, and ``cli/compare_renderers`` of the ``.pth``; on phase 13's
   dataset ``cli/pretrain_renderer`` (tanh, batch 64, 20 steps: seconds a
   step, PSNR, data wait, peak memory; sigmoid and subpixel 2 steps) and
   ``cli/pretrain_stn`` (the SG2 D at 256 px, batch 16 of each of the three
   splits: 5 steps on the pretrained renderer, 4 on the exported one;
   the simple Ds 2 steps); one micro step of each pretrainer, card against
   CPU.  Every run's launches of K1', K1' grad and K2' are held exactly to
   ``tools/launches.py`` (``expected_generator_launches``,
   ``expected_stn_pretrain_launches``; none for the renderer's).
18. single: the single-GAN path in phase 13's temporary directory:
   ``cli/dataset_tool`` of 128 synthetic 256 px RGB PNGs into a zip, and of
   five synthetic CIFAR-10 pickles (64 images each, 10 classes) into a
   labelled zip; ``cli/train --cfg paper256`` (StyleGAN2-ADA's 256 px
   config) for 5 steps at batch 64 (``--kimg 0.32``; batch 32 where 64
   does not fit, said with the peak), resumed from a seeded ``paper256``
   ``.pkl`` (G, D, G_ema) through ``transfer_into_train_state`` (the
   copied and skipped counts), with seconds a step over steps 2-5, peak
   memory and data wait; ``cli/train --cfg cifar --cond true --freezed 2``
   for 5 steps, the frozen D layers bit for bit as initialised, and
   ``cli/generate --class 3`` of its EMA snapshot; ``cli/calc_metrics
   --metrics fid2k`` of the ``.pkl`` on the 256 px zip with phase 15's
   random-weight detectors, after one batch of 16 through K1'/K2' is held
   to the plain route; one labelled micro step (Freeze-D 2), card against
   CPU, each phase within ``TOL_TRAIN_LOSS``/``TOL_TRAIN_GRAD`` or ten
   times a 1e-6 nudge's spread.  Every run's launches of K1'-K4' are held
   exactly to ``tools/launches.py`` (``expected_train_launches`` with the
   fakes grid's ``expected_generator_launches``).

Each main path (6, 8, 10, 11, 13's CLI step and 6-step loops, 14's steps,
15's fid2k, each of 16's tools and each of 17's and 18's runs) is driven
with every launch count set to 0 just before it and read just after.
The last two lines are the card's name and power limit (from
``nvidia-smi``) and one JSON object, ``{"ok": true, "device": {...}}``;
the line before them is ``{"kernels": [...]}``, and before it phase 18's
figures (``{"single": ...}``), the total seconds, each phase's seconds
(``{"phase_seconds": ...}``), the data-parallel step's, phase 17's
(``{"stage0": ...}``), the tools', the metrics' and the loop's figures
(``{"loop": ...}``).
"""

import contextlib
import copy
import gc
import json
import math
import os
import re
import shutil
import statistics
import sys
import tempfile
import time

from montage_gan_tpu_torch.tools.ddp_check import spread
from montage_gan_tpu_torch.tools.launches import (expected_launches,
                                                  expected_projector_launches,
                                                  expected_train_launches)
from montage_gan_tpu_torch.tools.timing import (PEAK_BYTES, card_line, device_ms,
                                                host_us)

START = time.perf_counter()
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
    from montage_gan_tpu_torch.tools.seeded import seeded_model
    from montage_gan_tpu_torch.utils.serving import build_inference_fn

    log(f'[slice] config aio: {cfg.num_layers} layers, base '
        f'{cfg.base_resolution}, cci {cfg.conv_config_index}, z/w '
        f'{cfg.z_dim}/{cfg.w_dim}, {cfg.mapping_num_layers} mapping layers, '
        f'channel_base {cfg.channel_base}, channel_max {cfg.channel_max}, '
        f'num_fp16_res {cfg.num_fp16_res}, {cfg.stn_stages} STN stages, '
        f'batch {BATCH}')
    t0 = time.perf_counter()
    model = seeded_model(cfg, SEED).to(device).eval().requires_grad_(False)
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

        def permutation(self, n, kind):
            return super().permutation(n, kind).to(device)
    return CpuDraws(torch.Generator().manual_seed(seed))


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


def phase_ddp(card):
    """The data-parallel step on every visible card (one rank in this
    process where there is one card); raises where a check fails.  Returns
    each rank's figures."""
    import torch
    from montage_gan_tpu_torch.parallel import distributed, mesh
    from montage_gan_tpu_torch.tools import ddp_check
    world = torch.cuda.device_count()
    log(f'[ddp] {world} rank(s), NCCL, {ddp_check.PER_RANK} images a rank; '
        f'config aio in float32, {ddp_check.STEPS} steps in 2 rounds, held '
        'to one process at the global batch; then config aio timed and '
        'profiled')
    if world > 1:
        ranks = ddp_check.run_ranks(world)
    else:
        distributed.maybe_initialize(f'localhost:{distributed.free_port()}',
                                     1, 0, 0, device='cuda')
        try:
            ranks = [ddp_check.check_rank(
                mesh.DataParallel.from_process_group('cuda'))]
        finally:
            distributed.shutdown()
    r0 = ranks[0]
    log(f'  ok  {r0["phases"]} phases\' gradients within their limits '
        f'(nearest: {r0["worst_phase"]} {r0["worst_grad"]:.3g} of its '
        f'largest entry, limit {r0["worst_grad_limit"]:.3g}; one process '
        f'with weights moved {ddp_check.NUDGE}: up to {r0["floor_grad"]:.3g});'
        f' {r0["losses"]} losses within theirs (nearest: {r0["worst_loss"]} '
        f'{r0["worst_loss_err"]:.3g}, limit {r0["worst_loss_limit"]:.3g}); '
        f'{r0["replicated"]} tensors replicated; launches '
        f'{[r["launches"] for r in ranks]} as expected')
    log(f'  config aio, a step without regularizer '
        f'{r0["step_s"] * 1e3:.1f} ms; profiled step: NCCL '
        f'{[round(r["nccl_ms"], 3) for r in ranks]} ms, '
        f'{[r["nccl_launches"] for r in ranks]} launches, of '
        f'{[round(r["kernel_ms"], 1) for r in ranks]} ms kernel time; peak '
        f'{[round(r["peak_gib"], 2) for r in ranks]} GiB  card: {card}')
    return ranks


LOOP_BATCH = 32
LOOP_BATCH_GPU = 16
LOOP_STEPS = 6
LOOP_SAMPLES = 64
# what the loop prints of a snapshot's save or restore (training/loop_aio.py)
TOOLS_SNAPSHOT = 'ema-snapshot.pt'      # phase 13's EMA snapshot, kept
SNAPSHOT_LINE = re.compile(r'^(Saved|Restored) (.+): (\d+) bytes in '
                           r'([0-9.]+) s$', re.M)


def read_stats(run_dir):
    """The records of a run's ``stats.jsonl``."""
    with open(os.path.join(run_dir, 'stats.jsonl')) as f:
        return [json.loads(line) for line in f]


def check_run_dir(run_dir):
    """Raises unless a CLI run left its options, log, finite stats, grids and
    both snapshots."""
    files = set(os.listdir(run_dir))
    need = {'training_options.json', 'log.txt', 'stats.jsonl', 'reals.png',
            'fakes000000.png', 'fakes-layer000000.png',
            'network-snapshot-000000.pt', 'ema-snapshot-000000.pt'}
    if need - files:
        raise AssertionError(f'{run_dir}: missing {sorted(need - files)}')
    records = read_stats(run_dir)
    bad = [k for r in records for k, v in r.items()
           if isinstance(v, dict) and not math.isfinite(v['mean'])]
    if bad or not any(k.endswith('Loss/G/loss') for k in records[0]):
        raise AssertionError(f'{run_dir}: stats.jsonl non-finite {bad}')
    return records


def snapshot_lines(run_dir):
    """(Saved or Restored, path, bytes, seconds) of every snapshot a CLI run
    wrote or read, from its ``log.txt``."""
    with open(os.path.join(run_dir, 'log.txt')) as f:
        return [(what, path, int(n), float(sec))
                for what, path, n, sec in SNAPSHOT_LINE.findall(f.read())]


def row_filters(data):
    """How many rows of each PNG filter type (None, Sub, Up, Average,
    Paeth) the dataset's files hold."""
    from montage_gan_tpu_torch.utils.png import parse
    counts = [0] * 5
    for root, _, files in os.walk(data):
        for name in files:
            if name.endswith('.png'):
                path = os.path.join(root, name)
                with open(path, 'rb') as f:
                    _, w, c, raw = parse(f.read(), path)
                for t in raw[::w * c + 1]:
                    counts[t] += 1
    return dict(zip(('none', 'sub', 'up', 'average', 'paeth'), counts))


def check_restored(restored, saved):
    """Raises unless a restored train state equals the one that was saved,
    bit for bit: weights and buffers, the EMA, every optimizer's moments,
    the ADA controller and the step."""
    import torch

    def same(a, b, what):
        if not torch.equal(a, b):
            raise AssertionError(f'restored {what} differs from the saved')
    saved_model = saved.model.state_dict()
    for k, v in restored.model.state_dict().items():
        same(v, saved_model[k], k)
    saved_ema = saved.ema.state_dict()
    for k, v in restored.ema.state_dict().items():
        same(v, saved_ema[k], f'ema {k}')

    def optimizers(st):
        return st.opt_local_g + st.opt_local_d + [
            st.opt_global_g, st.opt_global_d, st.opt_renderer]
    moments = 0
    for i, (a, b) in enumerate(zip(optimizers(restored), optimizers(saved))):
        sa, sb = a.state_dict()['state'], b.state_dict()['state']
        if sa.keys() != sb.keys():
            raise AssertionError(f'optimizer {i}: parameters {len(sa)} '
                                 f'restored, {len(sb)} saved')
        for p_id, st in sa.items():
            for k, v in st.items():
                if torch.is_tensor(v):
                    same(v, sb[p_id][k], f'optimizer {i} {k}')
                    moments += v.numel()
    for k in ('aug_p', 'pl_mean', 'ada_sign_sum', 'ada_sign_count'):
        same(getattr(restored, k), getattr(saved, k), k)
    if restored.step != saved.step or restored.step < 1:
        raise AssertionError(f'restored step {restored.step}, saved '
                             f'{saved.step}')
    log(f'  ok  restored state = saved: {len(saved_model)} tensors, EMA, '
        f'{len(optimizers(saved))} optimizers ({moments} moment and step '
        f'entries), aug_p {[round(v, 6) for v in restored.aug_p.tolist()]}, '
        f'step {restored.step}')


def phase_loop(card, kernels, tmp):
    """The training CLI and loop at the reference's batch 32 on a synthetic
    dataset written in a temporary directory outside the repository (the
    snapshots are several GB), its PNGs with adaptive row filters as PIL
    writes them: the reader alone; ``cli/train_aio.main`` for one step with
    ``--batch-gpu`` (files, exact launch counts of the accumulated step and
    the EMA grid), its train-state snapshot restored and held to the state
    the run returned; ``training_loop`` for ``LOOP_STEPS`` steps with and
    without ``--batch-gpu`` (images/s of steps 2 on, data wait, peak
    memory; without accumulation "does not fit" is reported, not raised);
    the CLI again from the first run's snapshot; ``cli/generate`` from its
    EMA snapshot; every snapshot's bytes and seconds from the runs' logs.
    Everything but the dataset (``tmp/layers``) is deleted at the end."""
    import dataclasses
    import numpy as np
    import torch
    from montage_gan_tpu_torch.cli import generate, train_aio
    from montage_gan_tpu_torch.data.synthetic import \
        make_synthetic_layer_dataset
    from montage_gan_tpu_torch.models.ensemble import MontageEnsemble
    from montage_gan_tpu_torch.training import loop_aio
    from montage_gan_tpu_torch.training.train_step import MontageTrainer
    from montage_gan_tpu_torch.utils import checkpoint
    from montage_gan_tpu_torch.utils.png import read_png_rgba

    out = {}
    try:
        data = os.path.join(tmp, 'layers')
        t0 = time.perf_counter()
        make_synthetic_layer_dataset(data, num_samples=LOOP_SAMPLES)
        filters = row_filters(data)
        base = ['--data', data, '--cfg', 'aio', '--batch', str(LOOP_BATCH),
                '--aug', 'ada', '--augpipe', 'bgcfnc', '--run-once',
                '--batch-gpu', str(LOOP_BATCH_GPU)]
        argv = ['--outdir', os.path.join(tmp, 'runs'), *base]
        kw = train_aio.setup_training_loop_kwargs(
            train_aio.parse_options(argv))
        dataset, hyper, cfg = kw.dataset, kw.hyper, kw.cfg
        log(f'[loop] dataset of {LOOP_SAMPLES} samples x '
            f'{dataset.num_layers} layers {dataset.resolution}x'
            f'{dataset.resolution} written and its stats computed in '
            f'{time.perf_counter() - t0:.1f} s; rows by PNG filter {filters}; '
            f'{shutil.disk_usage(tmp).free / 2**30:.1f} GiB free in {tmp}')
        if not (filters['up'] and filters['paeth']):
            raise AssertionError(f'the dataset\'s PNGs hold rows {filters}, '
                                 'not the Up and Paeth rows of PIL\'s')
        out['row_filters'] = filters

        # 1. the reader alone: batches of LOOP_BATCH in turn after the first
        pf = loop_aio.BatchPrefetcher(dataset, LOOP_BATCH,
                                      dataset.layer_targets, depth=1,
                                      pin_memory=True)
        try:
            pf.next()
            n = 8
            t0 = time.perf_counter()
            for _ in range(n):
                pf.next()
            reader = n * LOOP_BATCH / (time.perf_counter() - t0)
        finally:
            pf.stop()
        out['reader_samples_per_s'] = reader
        log(f'  reader: {reader:.1f} samples/s at batch {LOOP_BATCH} (PNG '
            f'decode on {loop_aio.DECODE_THREADS} threads, crops, pinned '
            f'uint8)  card: {card}')

        # 2. the CLI, one step with accumulation
        for k in kernels.values():
            k.reset()
        t0 = time.perf_counter()
        state = train_aio.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        expect = expected_train_launches(state.model, hyper, 1)
        # the EMA grid of the tick: one sampling call of 32
        for name, n in expected_launches(state.ema).items():
            expect[name] += n
        log(f'[loop] cli/train_aio --batch {LOOP_BATCH} --batch-gpu '
            f'{LOOP_BATCH_GPU} --run-once: {wall:.1f} s '
            f'({hyper.accum_rounds} local and {hyper.global_accum_rounds} '
            'global rounds)')
        log(f'  launches {launches}, expected {expect} (step 0 and the EMA '
            f'grid of {min(32, LOOP_BATCH)})')
        for name, n in launches.items():
            if n == 0 or n != expect[name]:
                raise AssertionError(f'{name}: {n} launches in the CLI run, '
                                     f'expected {expect[name]}')
        records = check_run_dir(kw.run_dir)
        log(f'  ok  {kw.run_dir}: options, log, {len(records)} stats '
            f'record(s) ({len(records[0])} names, finite), grids, snapshots')
        snapshot = os.path.join(kw.run_dir, 'network-snapshot-000000.pt')
        ema_snapshot = os.path.join(kw.run_dir, 'ema-snapshot-000000.pt')

        # the snapshot restored into a fresh trainer equals the state the
        # run saved and returned
        trainer = MontageTrainer(MontageEnsemble(cfg, with_d=True), hyper,
                                 device='cuda')
        check_restored(checkpoint.restore_train_state(snapshot, trainer),
                       state)
        saved_step = state.step
        del trainer, state
        gc.collect()

        # 3. training_loop alone, LOOP_STEPS steps in 2-step ticks
        def loop(microbatch, name):
            h = dataclasses.replace(hyper, microbatch=microbatch)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for k in kernels.values():
                k.reset()
            d = os.path.join(tmp, name)
            try:
                st = loop_aio.training_loop(
                    d, dataset, cfg=cfg, hyper=h,
                    total_kimg=LOOP_STEPS * LOOP_BATCH / 1000,
                    kimg_per_tick=2 * LOOP_BATCH / 1000,
                    image_snapshot_ticks=None, network_snapshot_ticks=None)
            except torch.cuda.OutOfMemoryError as e:
                log(f'  batch {LOOP_BATCH} without --batch-gpu does not fit: '
                    f'{str(e).splitlines()[0][:160]}; peak '
                    f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  '
                    f'card: {card}')
                return None
            peak = torch.cuda.max_memory_allocated()
            got = {k: v.launches for k, v in kernels.items()}
            want = expected_train_launches(st.model, h, LOOP_STEPS)
            if got != want:
                raise AssertionError(f'{name}: launches {got}, expected '
                                     f'{want}')
            del st
            recs = read_stats(d)
            secs = sum(r['Timing/sec_per_tick']['mean'] for r in recs[1:])
            fetch = (sum(r['Timing/data_fetch']['mean']
                         * r['Timing/data_fetch']['num'] for r in recs)
                     / sum(r['Timing/data_fetch']['num'] for r in recs))
            ips = (LOOP_STEPS - 1) * LOOP_BATCH / secs
            log(f'  {name}: {LOOP_STEPS} steps, ticks of '
                f'{[r["Timing/data_fetch"]["num"] for r in recs]} steps; steps '
                f'2-{LOOP_STEPS}: {ips:.2f} images/s; data wait '
                f'{fetch * 1e3:.1f} ms a step; peak memory '
                f'{peak / 2**30:.2f} GiB; launches as expected  card: {card}')
            return dict(images_per_s=ips, data_fetch_s=fetch,
                        peak_gib=peak / 2**30)

        log(f'[loop] training_loop, batch {LOOP_BATCH}, {LOOP_STEPS} steps '
            'in 2-step ticks')
        out['accumulated'] = loop(LOOP_BATCH_GPU,
                                  f'batch-gpu-{LOOP_BATCH_GPU}')
        out['whole_batch'] = loop(None, 'whole-batch')
        gc.collect()
        torch.cuda.empty_cache()
        ratio = reader / out['accumulated']['images_per_s']
        log(f'  reader {reader:.1f} samples/s = {ratio:.1f}x the loop\'s '
            f'images/s with --batch-gpu {LOOP_BATCH_GPU}')
        if ratio < 5:
            raise AssertionError(f'the reader feeds only {ratio:.1f}x the '
                                 'loop\'s images/s')

        # 4. the CLI again from the first run's snapshot, one more step
        resumed = os.path.join(tmp, 'resumed')
        state = train_aio.main(['--outdir', resumed, *base,
                                '--resume', snapshot])
        torch.cuda.synchronize()
        resumed_dir = os.path.join(resumed, os.listdir(resumed)[0])
        read = [s for s in snapshot_lines(resumed_dir) if s[0] == 'Restored']
        if state.step != saved_step + 1 or [s[1] for s in read] != [snapshot]:
            raise AssertionError(f'--resume: step {state.step} after '
                                 f'restoring {read}, saved step {saved_step}')
        del state
        gc.collect()
        log(f'[loop] cli/train_aio --resume: restored step {saved_step}, '
            f'one more step to {saved_step + 1}')

        # 5. sampling from the first run's EMA snapshot
        gen_dir = os.path.join(tmp, 'generated')
        generate.main(['--network', ema_snapshot, '--seeds', '0-7',
                       '--outdir', gen_dir])
        pngs = sorted(f for f in os.listdir(gen_dir) if f.endswith('.png'))
        imgs = [read_png_rgba(os.path.join(gen_dir, f)) for f in pngs]
        res = dataset.resolution
        if len(pngs) != 8 or any(i.shape != (res, res, 4) for i in imgs):
            raise AssertionError(f'generate wrote {pngs}')
        log(f'  ok  cli/generate from {os.path.basename(ema_snapshot)}: 8 '
            f'seeds, {len(pngs)} PNGs of {res}x{res}, mean alpha '
            f'{np.mean([i[..., 3].mean() / 255 for i in imgs]):.3f}')

        # 6. the snapshots, as the runs' logs report them
        snapshots = [(what, os.path.relpath(path, tmp), n, sec)
                     for run_dir in (kw.run_dir, resumed_dir)
                     for what, path, n, sec in snapshot_lines(run_dir)]
        for what, path, n, sec in snapshots:
            log(f'  {what} {path}: {n} bytes in {sec:.2f} s  card: {card}')
        out['launches'] = launches
        out['snapshots'] = snapshots
        # the tools phase samples, projects and exports from it
        os.replace(ema_snapshot, os.path.join(tmp, TOOLS_SNAPSHOT))
    finally:
        for name in os.listdir(tmp):          # the snapshots: several GB
            if name not in ('layers', TOOLS_SNAPSHOT):
                shutil.rmtree(os.path.join(tmp, name), ignore_errors=True)
    return out


# Card against CPU for the detectors on the same images and weights:
# float32 convolutions (TF32 off) in another order through 48 (InceptionV3)
# and 13 (VGG16) layers; the pool3 features and VGG16's relu5_3 map within
# TOL_DETECTOR of their largest CPU entry, and the LPIPS distance of two
# images within TOL_DETECTOR relative.  The LPIPS features themselves are
# each tap's unit vector along channels, ill-conditioned where a pixel's
# activations are all near 0 (at random weights, many; even two CPU runs on
# different thread counts differ there): they are held within
# TOL_LPIPS_FEATURES of the largest entry.
TOL_DETECTOR = 1e-4
TOL_LPIPS_FEATURES = 1e-2
METRIC_BATCH = 16
# One metric batch, kernels against the plain route on the card (the same
# weights, z and cuDNN convolutions), on what the extractor reads (RGB in
# [0, 255]).  With float32 blocks the two agree within TOL_CROSS.  With config aio's bfloat16 blocks
# K1' rounds its output once where the plain version rounds after every
# step (TOL_BF16), and at random weights those ulps grow through the later
# layers to a mean of about 0.4 of 255; there the kernels' mean distance
# from the float32 run may exceed the plain route's by no more than
# TOL_METRIC_RATIO (the run prints the ratio; PERF.md has it).
TOL_METRIC_RATIO = 1.05
# The reduced budgets of the other metrics here (the registry's are 50k).
METRIC_REDUCED = 512
METRIC_PPL = 256


@contextlib.contextmanager
def plain_route():
    """Every op of ``montage_gan_tpu_torch.ops`` takes its plain PyTorch
    version, on the card's tensors too: the reference that
    ``check_metric_batch`` holds the kernels to."""
    from montage_gan_tpu_torch.ops import (affine_warp, bias_act, composite,
                                           upfirdn2d)
    mods = (affine_warp, bias_act, composite, upfirdn2d)
    saved = [m.takes_plain for m in mods]
    for m in mods:
        m.takes_plain = lambda x: True
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.takes_plain = fn


def hold_to_plain(label, sample, sample32, expect, kernels):
    """One batch, ``sample()`` and ``sample32()`` (the same weights with
    float32 blocks), each through K1' and K2' (exactly ``expect`` launches)
    and through the plain route (no launch) on the card: the float32
    routes within ``TOL_CROSS``; the bfloat16 kernels no further from the
    float32 result than ``TOL_METRIC_RATIO`` times the plain route's mean
    distance.  Returns the figures."""
    import torch

    def routes(fn):
        for k in kernels.values():
            k.reset()
        with torch.no_grad():
            got = fn()
            launched = {name: k.launches for name, k in kernels.items()}
            with plain_route():
                ref = fn()
        torch.cuda.synchronize()
        plain = {name: k.launches - launched[name]
                 for name, k in kernels.items()}
        if launched != {name: expect.get(name, 0) for name in kernels} or \
                any(plain.values()) or not torch.isfinite(got).all():
            raise AssertionError(f'{label}: launches {launched} through '
                                 f'the kernels (expected {expect}), {plain} '
                                 'through the plain route')
        return got, ref, launched

    got32, ref32, launched = routes(sample32)
    err32 = (got32 - ref32).abs().max().item()
    torch.testing.assert_close(got32, ref32, **TOL_CROSS,
                               msg=lambda m: f'{label}, float32: {m}')
    got, ref, _ = routes(sample)
    dist_k = (got - got32).abs().mean().item()
    dist_p = (ref - got32).abs().mean().item()
    diff = (got - ref).abs()
    out = dict(f32_max_abs_err=err32, bf16_max_abs_err=diff.max().item(),
               bf16_mean_abs_err=diff.mean().item(),
               bf16_mean_from_f32=dict(kernels=dist_k, plain=dist_p))
    log(f'  ok  {label} {list(got.shape)} through K1\' and K2\' {launched} '
        f'and through the plain route on the card: float32 blocks '
        f'max_abs_err {err32:.3g} (atol {TOL_CROSS["atol"]}); bfloat16 blocks '
        f'max {out["bf16_max_abs_err"]:.4g}, mean '
        f'{out["bf16_mean_abs_err"]:.4g}, the mean distance from the float32 '
        f'run {dist_k:.6g} through the kernels, {dist_p:.6g} through the '
        f'plain route (ratio {dist_k / dist_p:.4f}, limit {TOL_METRIC_RATIO})')
    if not dist_k <= TOL_METRIC_RATIO * dist_p:
        raise AssertionError(f'{label}, bfloat16: the kernels\' mean '
                             f'distance from the float32 run {dist_k:.6g}, '
                             f'the plain route\'s {dist_p:.6g}')
    return out


def check_metric_batch(model, model32, z, kernels):
    """One metric batch ``sample_fn(z)`` (``metric_utils.ensemble_fns``) on
    the extractor's input (RGB in [0, 255]) held to the plain route by
    ``hold_to_plain``, ``model32`` being ``model`` with float32 blocks."""
    from montage_gan_tpu_torch.metrics import metric_utils

    def sample(m):
        fn = metric_utils.ensemble_fns(m)[0]
        return lambda: metric_utils.images_to_metric_rgb(fn(z))
    return hold_to_plain('metric batch (the extractor\'s RGB in [0, 255])',
                         sample(model), sample(model32),
                         expected_launches(model), kernels)


def phase_metrics(card, kernels, tmp, device='cuda'):
    """The metrics path at config ``aio``'s widths on the loop phase's
    dataset (``tmp/layers``): seeded random InceptionV3 and VGG16-LPIPS
    ``.npz`` files in a drop-in directory, so ``build_extractor('auto')``
    runs the real architectures; each detector on the card against the CPU;
    one batch of ``METRIC_BATCH`` samples, kernels against the plain route
    and a float32 run (``check_metric_batch``); ``calc_metric('fid2k')`` end to end (seconds, the generator and
    InceptionV3 images/s at batch ``METRIC_BATCH``, the launches of K1' and
    K2' on it, exactly ``expected_launches`` per generator batch); KID, PR
    and IS at ``METRIC_REDUCED`` images and ppl2_wend at ``METRIC_PPL``
    samples; ``cli/train_aio --metrics fid2k`` for one step to a network
    snapshot (``metric-fid2k.jsonl`` and ``Metrics/fid2k`` checked); the
    phase's peak memory."""
    import math
    import numpy as np
    import torch
    from montage_gan_tpu_torch.cli import train_aio
    from montage_gan_tpu_torch.data.dataset import DatasetAIO
    from montage_gan_tpu_torch.metrics import (features, metric_main,
                                               metric_utils)
    from montage_gan_tpu_torch.metrics.inception_score import compute_is
    from montage_gan_tpu_torch.metrics.kernel_inception_distance import \
        compute_kid
    from montage_gan_tpu_torch.metrics.precision_recall import compute_pr
    from montage_gan_tpu_torch.models.ensemble import MontageConfig
    from montage_gan_tpu_torch.tools.seeded import (seeded_model,
                                                    use_detectors,
                                                    write_random_detectors)

    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    t0 = time.perf_counter()
    use_detectors(os.path.join(tmp, 'weights'))
    paths = write_random_detectors(os.environ['MGT_WEIGHTS_DIR'], SEED)
    inception = features.build_extractor('auto', device=device)
    lpips = features.build_extractor('auto_lpips', device=device)
    if not (isinstance(inception, features.InceptionV3Features)
            and isinstance(lpips, features.VGG16Features)):
        raise AssertionError(f'the drop-in directory gave {inception.name}, '
                             f'{lpips.name}')
    log(f'[metrics] random-weight InceptionV3 and VGG16-LPIPS written to '
        f'the drop-in directory and loaded in {time.perf_counter() - t0:.1f} '
        f's; config aio, batch {METRIC_BATCH}')

    # 1. each detector, card against CPU
    rng = np.random.RandomState(SEED)
    def against_cpu(label, fn, cpu_fn, x, tol):
        with torch.no_grad():
            ref = cpu_fn(x)
            got = fn(x.to(device)).cpu()
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        if not (torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f'{label}: card against CPU {err:.3g} of '
                                 f'the largest entry (limit {tol})')
        log(f'  ok  {label} {list(got.shape)}: card against CPU within '
            f'{err:.3g} of the largest entry (limit {tol})')
        out[f'card_vs_cpu {label}'] = err
        return got, ref

    def images(*shape):
        return torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32))
    against_cpu('InceptionV3 pool3, 256->299', inception,
                features.InceptionV3Features(paths['inception'],
                                             device='cpu'),
                images(4, 256, 256, 3), TOL_DETECTOR)
    cpu_lpips = features.VGG16Features(paths['vgg16'], device='cpu')
    x = images(2, 256, 256, 3)
    against_cpu('VGG16 relu5_3, 256', lambda t: lpips.net(
        t, return_lpips=False), lambda t: cpu_lpips.net(
        t, return_lpips=False), x, TOL_DETECTOR)
    got, ref = against_cpu('VGG16-LPIPS features, 256', lpips, cpu_lpips, x,
                           TOL_LPIPS_FEATURES)
    d_ref = (ref[0] - ref[1]).square().sum().item()
    d = (got[0] - got[1]).square().sum().item()
    out['lpips_distance'] = dict(card=d, cpu=d_ref)
    if not abs(d - d_ref) <= TOL_DETECTOR * d_ref:
        raise AssertionError(f'LPIPS distance {d} on the card, {d_ref} on '
                             'the CPU')
    log(f'  ok  LPIPS distance of the two images {d:.8g} (CPU {d_ref:.8g}, '
        f'limit {TOL_DETECTOR} relative)')
    del cpu_lpips

    # 2. fid2k end to end
    cfg = MontageConfig()
    model = seeded_model(cfg, SEED).to(device).eval().requires_grad_(False)
    sample_fn, map_fn, synth_fn = metric_utils.ensemble_fns(model)
    dataset = DatasetAIO(os.path.join(tmp, 'layers'))
    common = dict(dataset=dataset, sample_fn=sample_fn, map_fn=map_fn,
                  synth_fn=synth_fn, z_dim=cfg.z_dim, extractor=inception,
                  batch_size=METRIC_BATCH, device=device,
                  cache_dir=os.path.join(tmp, 'metric-cache'))
    with torch.no_grad():                    # warm-up (cuDNN plans)
        inception(metric_utils.images_to_metric_rgb(sample_fn(
            metric_utils.generator_draws(1, 0, METRIC_BATCH,
                                         cfg.z_dim).to(device))))
    torch.cuda.synchronize()
    # fid2k's first batch
    model32 = seeded_model(MontageConfig(num_fp16_res=0), SEED).to(
        device).eval().requires_grad_(False)
    out['metric_batch_vs_plain'] = check_metric_batch(
        model, model32, metric_utils.generator_draws(
            0, 0, METRIC_BATCH, cfg.z_dim).to(device), kernels)
    del model32
    marks = {}

    def progress(tag, done, total):
        torch.cuda.synchronize()
        marks.setdefault(tag, []).append((done, time.perf_counter()))
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.reset()
    t0 = time.perf_counter()
    result = metric_main.calc_metric('fid2k', progress_fn=progress, **common)
    fid_s = time.perf_counter() - t0
    fid_peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {name: k.launches for name, k in kernels.items()}
    batches = math.ceil(2000 / METRIC_BATCH)
    expect = {name: batches * n
              for name, n in expected_launches(model).items()}
    for name, n in launches.items():
        if n != expect.get(name, 0) or (name in expect and n == 0):
            raise AssertionError(f'{name}: {n} launches in fid2k, expected '
                                 f'{expect.get(name, 0)}')
    fid = result.results['fid2k']
    if not math.isfinite(fid) or fid < 0:
        raise AssertionError(f'fid2k {fid}')
    gen = marks['generator']
    ips = (gen[-1][0] - gen[0][0]) / (gen[-1][1] - gen[0][1])
    data_s = marks['dataset'][-1][1] - t0
    gen_s = gen[-1][1] - marks['dataset'][-1][1]
    out.update(fid2k=fid, fid2k_s=fid_s, fid2k_dataset_s=data_s,
               fid2k_generator_s=gen_s,
               fid2k_statistics_s=fid_s - data_s - gen_s,
               generator_inception_images_per_s=ips, launches=launches,
               fid2k_peak_gib=fid_peak)
    log(f'  fid2k {fid:.6g} in {fid_s:.1f} s: the {len(dataset)} dataset '
        f'samples {data_s:.2f} s, 2000 generated {gen_s:.1f} s '
        f'({ips:.1f} images/s through the generator and InceptionV3 at '
        f'batch {METRIC_BATCH}, batches 2-{batches}), the Frechet distance '
        f'(sqrtm on the host) {fid_s - data_s - gen_s:.1f} s; peak memory '
        f'{fid_peak:.2f} GiB  card: {card}')
    log(f'  launches {launches}: exactly {batches} sampling calls\' '
        f'{expected_launches(model)}')

    # 3. the others at a reduced budget
    opts = metric_main.MetricOptions(**common)
    for name, fn in (('kid', lambda: compute_kid(opts, None, METRIC_REDUCED)),
                     ('pr', lambda: compute_pr(opts, None, METRIC_REDUCED)),
                     ('is', lambda: compute_is(opts, METRIC_REDUCED))):
        t0 = time.perf_counter()
        value = fn()
        sec = time.perf_counter() - t0
        if not np.all(np.isfinite(value)):
            raise AssertionError(f'{name} {value}')
        out[name] = dict(value=value, seconds=sec)
        log(f'  {name} at {METRIC_REDUCED} generated images: {value} in '
            f'{sec:.1f} s')
    t0 = time.perf_counter()
    ppl = metric_main.calc_metric('ppl2_wend', ppl_samples=METRIC_PPL,
                                  **common).results['ppl2_wend']
    sec = time.perf_counter() - t0
    if not (math.isfinite(ppl) and ppl > 0):
        raise AssertionError(f'ppl2_wend {ppl}')
    out['ppl2_wend'] = dict(value=ppl, seconds=sec)
    log(f'  ppl2_wend at {METRIC_PPL} samples (VGG16-LPIPS): {ppl:.6g} in '
        f'{sec:.1f} s ({2 * METRIC_PPL / sec:.1f} images/s through the '
        f'generator and VGG16)  card: {card}')
    del model, opts, common, inception, lpips
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the training CLI scoring its snapshot, at micro widths (the
    # metric's contract, not its cost: config aio's fid2k is measured above)
    runs = os.path.join(tmp, 'metric-runs')
    t0 = time.perf_counter()
    train_aio.main(['--outdir', runs, '--data', os.path.join(tmp, 'layers'),
                    '--cfg', 'aio', '--batch', '8', '--run-once',
                    '--channel-base', str(MICRO['channel_base']),
                    '--channel-max', str(MICRO['channel_max']),
                    '--metrics', 'fid2k', '--device', device])
    cli_s = time.perf_counter() - t0
    run_dir = os.path.join(runs, os.listdir(runs)[0])
    with open(os.path.join(run_dir, 'metric-fid2k.jsonl')) as f:
        record = json.loads(f.readline())
    stats = read_stats(run_dir)[0]
    if not (record['snapshot_pkl'].endswith('network-snapshot-000000.pt')
            and stats['Metrics/fid2k']['mean'] == record['results']['fid2k']
            and math.isfinite(record['results']['fid2k'])):
        raise AssertionError(f'{run_dir}: {record}, '
                             f'{stats.get("Metrics/fid2k")}')
    out['cli'] = dict(fid2k=record['results']['fid2k'],
                      fid2k_s=record['total_time'], command_s=cli_s)
    shutil.rmtree(runs, ignore_errors=True)
    log(f'  ok  cli/train_aio --batch 8 --run-once --metrics fid2k at '
        f'channel_base {MICRO["channel_base"]}, channel_max '
        f'{MICRO["channel_max"]}: metric-fid2k.jsonl and Metrics/fid2k {record["results"]["fid2k"]:.6g}'
        f' (the EMA after one step), fid2k {record["total_time"]:.1f} s of '
        f'{cli_s:.1f} s')
    out['cli_peak_gib'] = torch.cuda.max_memory_allocated() / 2**30
    log(f'  peak memory from fid2k to the CLI\'s end (its micro training '
        f'step at batch 8) {out["cli_peak_gib"]:.2f} GiB  card: {card}')
    return out


# The tools phase: the projector's steps at config aio, the rows and columns
# of the style-mixing grid, and the micro step's draw of w noise (t > 0).
PROJECTOR_STEPS = 10
STYLE_GRID = ('0-3', '4-7')
MICRO_STEP = (3, 10)


def projector_micro_step(kernels, device='cuda'):
    """One projector step on the micro ensemble (float32) with the same
    weights, target and draws, CPU (plain versions) against the card
    (kernels): its loss and the gradients of w and the noise buffers, the
    gradients held within ``TOL_TRAIN_GRAD`` of the largest entry; the
    card's launches of K1', K1' grad and K2' exactly one step's."""
    import torch
    from montage_gan_tpu_torch.cli import projector
    from montage_gan_tpu_torch.metrics.features import RandomFeatures
    from montage_gan_tpu_torch.models.ensemble import (MontageConfig,
                                                       MontageEnsemble)

    cfg = MontageConfig(**MICRO)
    cpu_model = MontageEnsemble(cfg).init_weights(SEED)
    perturb_zero_init(cpu_model, torch.Generator().manual_seed(SEED + 3), 0.1)
    cpu_model.eval().requires_grad_(False)
    card_model = copy.deepcopy(cpu_model).to(device)
    draws = projector.default_draws(cpu_model, SEED)
    target = torch.rand(1, cfg.base_resolution, cfg.base_resolution, 4,
                        generator=torch.Generator().manual_seed(SEED))

    def step(model, dev):
        p = projector.Projector(model, target.to(dev), draws=draws,
                                extractor=RandomFeatures(seed=1, device=dev))
        loss = p.loss(*MICRO_STEP)
        grads = torch.autograd.grad(loss, p.params)
        return loss.item(), torch.cat([g.flatten().cpu() for g in grads])

    loss_ref, grad_ref = step(cpu_model, 'cpu')
    for k in kernels.values():
        k.reset()
    loss, grad = step(card_model, device)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    one = expected_projector_launches(card_model, 1)
    render = expected_projector_launches(card_model, 0)
    mapping_fc = card_model.mapping.num_layers
    expect = {'bias_act': one['bias_act'] - render['bias_act'] + mapping_fc,
              'bias_act_grad': one['bias_act_grad'],
              'upfirdn2d': one['upfirdn2d'] - render['upfirdn2d']}
    if launches != expect:
        raise AssertionError(f'projector micro step: launches {launches}, '
                             f'expected {expect}')
    loss_err = abs(loss - loss_ref) / abs(loss_ref)
    grad_err = ((grad - grad_ref).abs().max() / grad_ref.abs().max()).item()
    if not (loss_err <= TOL_TRAIN_LOSS and grad_err <= TOL_TRAIN_GRAD):
        raise AssertionError(f'projector micro step: loss {loss} against '
                             f'{loss_ref} ({loss_err:.3g}), gradients '
                             f'{grad_err:.3g} of the largest entry')
    log(f'  ok  projector step on the micro ensemble, card against CPU: loss '
        f'{loss:.8g} ({loss_err:.3g} relative, limit {TOL_TRAIN_LOSS}), the '
        f'gradients of w and {len(draws.noise)} noise buffers within '
        f'{grad_err:.3g} of the largest entry (limit {TOL_TRAIN_GRAD}); '
        f'launches {launches}')
    return dict(loss_rel_err=loss_err, grad_err=grad_err, launches=launches)


def phase_tools(card, kernels, tmp, device='cuda'):
    """The inference tools at config ``aio`` on phase 13's EMA snapshot
    (with its renderer) and dataset, with phase 15's random-weight VGG16 in
    the drop-in directory: ``cli/style_mixing`` (a 4x4 grid),
    ``cli/projector`` (``PROJECTOR_STEPS`` steps on one composite of the
    dataset, VGG16-LPIPS distance), one projector step on the micro
    ensemble held to the CPU, ``cli/generate --projected-w`` and
    ``--composite renderer``, ``cli/export_model`` (its reloaded artifact
    at batch 8 and 3 against direct execution, its images/s beside direct
    execution's), ``cli/compare_renderers`` over the dataset, and the
    host's cost of one ``mgt::bias_act`` dispatch against a direct launch.
    Every tool's launches of K1', K1' grad and K2' are held exactly to
    ``tools/launches.py``."""
    import collections
    import numpy as np
    import torch
    from montage_gan_tpu_torch.cli import (compare_renderers, export_model,
                                           generate, projector, style_mixing)
    from montage_gan_tpu_torch.data.dataset import DatasetAIO
    from montage_gan_tpu_torch.ops import bias_act
    from montage_gan_tpu_torch.utils import serving
    from montage_gan_tpu_torch.utils.checkpoint import load_network
    from montage_gan_tpu_torch.utils.image_utils import alpha_composite_np
    from montage_gan_tpu_torch.utils.png import read_png_rgba, write_png_rgba

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    ema = os.path.join(tmp, TOOLS_SNAPSHOT)
    work = os.path.join(tmp, 'tools')
    os.makedirs(work)
    cfg, model = load_network(ema, device=device)
    if model.renderer is None:
        raise AssertionError(f'{ema}: the EMA snapshot holds no renderer')
    res = cfg.base_resolution
    per_call = expected_launches(model)
    mapping_fc = model.mapping.num_layers
    synth = dict(per_call, bias_act=per_call['bias_act'] - mapping_fc)
    out = {'launches': {}}
    log(f'[tools] config aio from phase 13\'s EMA snapshot (renderer '
        f'{cfg.renderer_type}); one sampling call launches {per_call}')

    def counted(label, fn, expect):
        """``fn()`` with every count at 0 before it and read after; the
        launches must be ``expect``.  Returns (result, seconds)."""
        for k in kernels.values():
            k.reset()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = {name: k.launches for name, k in kernels.items()}
        want = {name: expect.get(name, 0) for name in kernels}
        if got != want:
            raise AssertionError(f'{label}: launches {got}, expected {want}')
        out['launches'][label] = got
        return result, sec

    def pngs(d, count):
        names = sorted(f for f in os.listdir(d) if f.endswith('.png'))
        if len(names) != count:
            raise AssertionError(f'{d}: {names}, expected {count} PNGs')
        return {n: read_png_rgba(os.path.join(d, n)) for n in names}

    # 1. the style-mixing grid
    d = os.path.join(work, 'mixing')
    rows, cols = STYLE_GRID
    n = 16
    images, sec = counted('style_mixing_4x4', lambda: style_mixing.main([
        '--network', ema, '--rows', rows, '--cols', cols, '--outdir', d,
        '--device', device]), {'bias_act': mapping_fc + n * synth['bias_act'],
                               'upfirdn2d': n * synth['upfirdn2d']})
    files = pngs(d, 1 + n)
    if files['grid.png'].shape != (4 * (res + 2) + 2, 4 * (res + 2) + 2, 4) \
            or not all(np.isfinite(v).all() for v in images.values()):
        raise AssertionError(f'style mixing: grid {files["grid.png"].shape}')
    out['style_mixing_s'] = sec
    log(f'  ok  cli/style_mixing --rows {rows} --cols {cols}: grid.png and '
        f'{n} montages in {sec:.1f} s (the snapshot read included)')

    # 2. the projector on one composite of the dataset
    layers = DatasetAIO(os.path.join(tmp, 'layers'))[0]
    target = os.path.join(work, 'target.png')
    write_png_rgba(target, (np.clip(alpha_composite_np(layers), 0, 1) * 255
                            + 0.5).astype(np.uint8))
    extractor = projector.projector_extractor(device)
    if extractor.name != 'vgg16_lpips':
        raise AssertionError(f'the projector\'s distance is {extractor.name}')
    del extractor
    d = os.path.join(work, 'projector')
    result, sec = counted(f'projector_{PROJECTOR_STEPS}_steps',
                          lambda: projector.main([
                              '--network', ema, '--target', target,
                              '--num-steps', str(PROJECTOR_STEPS),
                              '--outdir', d, '--device', device]),
                          expected_projector_launches(model, PROJECTOR_STEPS))
    pngs(d, 2)
    w = np.load(os.path.join(d, 'projected_w.npz'))['w']
    losses = result.losses
    if w.shape != (1, cfg.num_layers, model.num_ws, cfg.w_dim) or \
            not (np.isfinite(w).all() and torch.isfinite(losses).all()):
        raise AssertionError(f'projector: w {w.shape}, distances {losses}')
    out['projector'] = dict(
        steps=PROJECTOR_STEPS, s_per_step=result.seconds / PROJECTOR_STEPS,
        first_distance=losses[0].item(), last_distance=losses[-1].item(),
        command_s=sec)
    log(f'  ok  cli/projector --num-steps {PROJECTOR_STEPS} (VGG16-LPIPS '
        f'distance, random weights): {result.seconds / PROJECTOR_STEPS:.3f} '
        f's a step, distance {losses[0].item():.6g} at step 1, '
        f'{losses[-1].item():.6g} at step {PROJECTOR_STEPS}; {sec:.1f} s in '
        f'all  card: {card}')
    out['projector_micro_step'] = projector_micro_step(kernels, device)

    # 3. generate: the projection replayed, and seeds through the renderer
    d = os.path.join(work, 'replay')
    _, sec = counted('generate_projected_w', lambda: generate.main([
        '--network', ema, '--projected-w',
        os.path.join(work, 'projector', 'projected_w.npz'), '--save-layers',
        '--composite', 'renderer', '--outdir', d, '--device', device]),
        synth)
    pngs(d, 1 + cfg.num_layers)
    d = os.path.join(work, 'renderer')
    _, sec2 = counted('generate_renderer_8_seeds', lambda: generate.main([
        '--network', ema, '--seeds', '0-7', '--composite', 'renderer',
        '--outdir', d, '--device', device]),
        {k: 8 * v for k, v in per_call.items()})
    files = pngs(d, 8)
    out.update(generate_projected_w_s=sec, generate_renderer_s=sec2)
    log(f'  ok  cli/generate --projected-w --save-layers --composite '
        f'renderer ({sec:.1f} s) and --seeds 0-7 --composite renderer '
        f'({sec2:.1f} s): mean alpha '
        f'{np.mean([v[..., 3].mean() / 255 for v in files.values()]):.3f}')

    # 4. the serving artifact
    artifact = os.path.join(work, 'montage.pt2')
    meta, export_s = counted('export', lambda: export_model.main([
        '--network', ema, '--out', artifact, '--device', device]), {})
    nbytes_artifact = os.path.getsize(artifact)
    t0 = time.perf_counter()
    meta, call = serving.load_file(artifact)
    load_s = time.perf_counter() - t0
    nodes = collections.Counter(
        str(n.target).split('.')[1] for n in call.program.graph.nodes
        if str(n.target).startswith('mgt.'))
    if dict(nodes) != per_call:
        raise AssertionError(f'the artifact\'s kernel nodes {dict(nodes)}, '
                             f'expected {per_call}')
    direct = serving.build_inference_fn(cfg, model)
    errs = {}
    for batch in (8, 3):
        z = torch.from_numpy(seed_z(range(batch), cfg.z_dim)).to(device)
        got, _ = counted(f'artifact_batch{batch}', lambda: call(z), per_call)
        ref = direct(z)
        for name, a, b in zip(('placed', 'img'), got, ref):
            torch.testing.assert_close(
                a, b, rtol=2e-4, atol=2e-5,
                msg=lambda m: f'artifact {name}, batch {batch}: {m}')
            errs[f'{name}_batch{batch}'] = (a - b).abs().max().item()

    def images_per_s(fn, z, repeats=5):
        fn(z)
        times = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(z)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return z.shape[0] / statistics.median(times)
    z = torch.from_numpy(seed_z(range(BATCH), cfg.z_dim)).to(device)
    ips = {'artifact': images_per_s(call, z),
           'direct': images_per_s(direct, z)}
    out['export'] = dict(export_s=export_s, artifact_bytes=nbytes_artifact,
                         load_s=load_s, max_abs_err=errs,
                         images_per_s_batch8=ips)
    log(f'  ok  cli/export_model: traced and saved in {export_s:.1f} s (no '
        f'launch), {nbytes_artifact} bytes, loaded in {load_s:.1f} s; its '
        f'graph holds {dict(nodes)} kernel nodes; reloaded at batch 8 and 3 '
        f'against direct execution max_abs_err {errs} (rtol 2e-4, atol '
        f'2e-5), launches exactly a sampling call\'s; batch {BATCH}: '
        f'{ips["artifact"]:.2f} images/s through the artifact, '
        f'{ips["direct"]:.2f} direct  card: {card}')

    # 5. renderer checkpoints scored over the dataset
    scores, sec = counted('compare_renderers', lambda: compare_renderers.main([
        '--data', os.path.join(tmp, 'layers'), '--ckpt', ema, '--batch', '16',
        '--device', device]), {})
    psnr = scores[ema]
    if not math.isfinite(psnr):
        raise AssertionError(f'compare_renderers: PSNR {psnr}')
    n = len(DatasetAIO(os.path.join(tmp, 'layers')))
    out['compare_renderers'] = dict(psnr_db=psnr, samples=n, seconds=sec,
                                    samples_per_s=n / sec)
    log(f'  ok  cli/compare_renderers: average PSNR {psnr:.4f} dB over {n} '
        f'randomly placed samples in {sec:.1f} s ({n / sec:.1f} samples/s, '
        'the reads included)')

    # 6. the host's cost of one operator dispatch against a direct launch
    x = torch.randn(1, 32, 32, 256, device=device)
    b = torch.randn(256, device=device)
    gain = math.sqrt(2)
    host = {
        'direct_launch': host_us(lambda: bias_act.bias_act_cuda(
            x, b, act='lrelu', gain=gain, clamp=256.0)),
        'eager_wrapper': host_us(lambda: bias_act.bias_act(
            x, b, act='lrelu', gain=gain, clamp=256.0)),
        'operator': host_us(lambda: torch.ops.mgt.bias_act(
            x, b, -1, 'lrelu', 0.2, gain, 256.0))}
    out['host_us_bias_act_1x32x32x256'] = host
    log(f'  host µs a call of K1\' on [1,32,32,256] f32: direct launch '
        f'{host["direct_launch"]:.2f}, the eager wrapper '
        f'{host["eager_wrapper"]:.2f}, the mgt::bias_act operator '
        f'{host["operator"]:.2f}  card: {card}')
    out['phase_s'] = time.perf_counter() - t_phase
    log(f'[tools] {out["phase_s"]:.1f} s')
    return out


# Phase 17: interop and stage 0.
STAGE0_STEPS = 20            # pretrain_renderer steps
STAGE0_STN_STEPS = 5         # pretrain_stn steps 0..4 on the renderer
STAGE0_RENDERER_BATCH = 64   # the JAX CLI's defaults
STAGE0_STN_BATCH = 16
# config aio's largest layer as a reference Generator's kwargs
PKL_KW = dict(z_dim=512, w_dim=512, img_resolution=256, img_channels=4,
              init_res=[8, 8], mapping_kwargs=dict(num_layers=8),
              synthesis_kwargs=dict(channel_base=16384, channel_max=512,
                                    num_fp16_res=4, conv_clamp=256,
                                    conv_config_index=3, init_res=[8, 8]))
MICRO_STAGE0 = dict(res=16, layers=2, batch=2)


def check_pkl_batch(mapping, synthesis, kw, z, kernels, device):
    """One batch of a ``.pkl`` generator held to the plain route by
    ``hold_to_plain`` (launches exactly ``expected_generator_launches``),
    beside a copy of it with float32 blocks."""
    import copy as copy_
    from montage_gan_tpu_torch.tools.launches import (
        expected_generator_launches)
    from montage_gan_tpu_torch.utils.pkl_import import generator_modules

    kw32 = copy_.deepcopy(kw)
    kw32['synthesis_kwargs']['num_fp16_res'] = 0
    m32, s32 = generator_modules(kw32)
    m32.load_state_dict(mapping.state_dict())
    s32.load_state_dict(synthesis.state_dict())
    m32, s32 = (m.to(device).eval() for m in (m32, s32))

    def sample(m, s):
        return lambda: s(m(z), noise_mode='const')
    return hold_to_plain('.pkl generator batch', sample(mapping, synthesis),
                         sample(m32, s32),
                         expected_generator_launches(mapping, synthesis),
                         kernels)


def stage0_micro_steps(kernels, device='cuda'):
    """One micro step of each pretrainer with the same weights and draws,
    CPU (plain versions) against the card (kernels): the renderer step
    (cuDNN only), and the STN GAN's D step (R1 by double backward through
    K1' and K1' grad) and STN step with a narrow SG2 D, its launches
    exactly ``expected_stn_pretrain_launches``.  Losses within
    ``TOL_TRAIN_LOSS``; the renderer's gradients within ``TOL_TRAIN_GRAD``
    of the step's largest entry; D's and the STN's within the larger of
    that and ten times the spread of the CPU with weights moved by 1e-6 (as
    ``tools/ddp_check.py`` bounds the AIO step's phases): R1's gradients
    are ill-conditioned (phase 12), and the STN's reaches it through the
    renderer's and D's input gradients, piecewise constant in their inputs,
    which the STN's sub-pixel shifts move."""
    import numpy as np
    import torch
    from montage_gan_tpu_torch.data.synthetic import synthetic_batch
    from montage_gan_tpu_torch.models.discriminator import Discriminator
    from montage_gan_tpu_torch.models.renderer import build_renderer
    from montage_gan_tpu_torch.models.stn import STN, auto_stn_stages
    from montage_gan_tpu_torch.tools.launches import (
        expected_stn_pretrain_launches)
    from montage_gan_tpu_torch.training import pretrain
    from montage_gan_tpu_torch.training.train_step import AMSGrad
    from montage_gan_tpu_torch.utils.image_utils import generate_pseudo_fake_np

    res, nl, b = (MICRO_STAGE0[k] for k in ('res', 'layers', 'batch'))
    g = torch.Generator().manual_seed(SEED + 17)

    def seeded(m):
        m.reset_parameters(g)
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith('bias') or name.startswith('fc_loc.2'):
                    p.add_(torch.randn(p.shape, generator=g) * 0.05)
        return m

    renderer = seeded(build_renderer('tanh', img_resolution=res,
                                     img_channels=4, img_layers=nl))
    stn = seeded(STN(img_resolution=res, img_channels=4, img_layers=nl,
                     num_stages=auto_stn_stages(res)))
    d = seeded(Discriminator(img_resolution=res, img_channels=4,
                             channel_base=256, channel_max=32))
    rng = np.random.RandomState(SEED + 17)
    data = synthetic_batch(rng, 3 * b, nl, res)
    pseudo = torch.from_numpy(generate_pseudo_fake_np(data))
    data = torch.from_numpy(data)
    t = torch.from_numpy(rng.uniform(-1, 1, (b * nl, 2)).astype(np.float32))
    out = {}

    def renderer_run(r, dev):
        r = copy.deepcopy(r).to(dev)
        opt = AMSGrad(r.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
        loss, psnr = pretrain.renderer_step(r, opt, data[:b].to(dev),
                                            t.to(dev))
        return loss.cpu(), [p.grad.cpu() for p in r.parameters()]

    def stn_run(nets, dev):
        dd, ss, rr = (copy.deepcopy(m).to(dev) for m in nets)
        rr.requires_grad_(False)
        opt_d = torch.optim.Adam(dd.parameters(), lr=1e-3)
        opt_s = torch.optim.Adam(ss.parameters(), lr=1e-3)
        rec_d = pretrain.stn_d_step(dd, opt_d, ss, rr, data[:b].to(dev),
                                    pseudo[b:2 * b].to(dev))
        d_grads = [p.grad.cpu() for p in dd.parameters()]
        rec_g = pretrain.stn_g_step(ss, opt_s, dd, rr, pseudo[2 * b:].to(dev))
        return ({k: float(v) for k, v in {**rec_d, **rec_g}.items()},
                d_grads, [p.grad.cpu() for p in ss.parameters()])

    loss_ref, grads_ref = renderer_run(renderer, 'cpu')
    loss, grads = renderer_run(renderer, device)
    worst, _ = spread(grads, grads_ref)
    if not (abs(loss.item() - loss_ref.item()) <= TOL_TRAIN_LOSS
            and worst <= TOL_TRAIN_GRAD):
        raise AssertionError(f'renderer micro step: loss {loss.item()} '
                             f'against {loss_ref.item()}, gradients '
                             f'{worst:.3g} of the largest entry')
    out['renderer'] = dict(loss_abs_err=abs(loss.item() - loss_ref.item()),
                           grad_err=worst)
    log(f'  ok  pretrain_renderer micro step, card against CPU: loss '
        f'{loss.item():.8g} (CPU {loss_ref.item():.8g}, atol '
        f'{TOL_TRAIN_LOSS}); gradients within {worst:.3g} of the largest '
        f'entry (limit {TOL_TRAIN_GRAD})')

    nets = (d, stn, renderer)
    rec_ref, dg_ref, sg_ref = stn_run(nets, 'cpu')
    _, dg_moved, sg_moved = stn_run(tuple(nudged_copy(m) for m in nets),
                                    'cpu')
    for k in kernels.values():
        k.reset()
    rec, dg, sg = stn_run(nets, device)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    expect = expected_stn_pretrain_launches(d, 1)
    if launches != {name: expect.get(name, 0) for name in kernels}:
        raise AssertionError(f'STN micro step: launches {launches}, '
                             f'expected {expect}')
    loss_err = max(abs(rec[k] - rec_ref[k]) for k in rec_ref)
    d_err, _ = spread(dg, dg_ref)
    s_err, _ = spread(sg, sg_ref)
    d_floor, _ = spread(dg_moved, dg_ref)
    s_floor, _ = spread(sg_moved, sg_ref)
    d_bound = max(TOL_TRAIN_GRAD, 10 * d_floor)
    s_bound = max(TOL_TRAIN_GRAD, 10 * s_floor)
    if not (loss_err <= TOL_TRAIN_LOSS and d_err <= d_bound
            and s_err <= s_bound):
        raise AssertionError(f'STN micro step: losses {rec} against '
                             f'{rec_ref}, D gradients {d_err:.3g} (bound '
                             f'{d_bound:.3g}), STN gradients {s_err:.3g} '
                             f'(bound {s_bound:.3g}) of the largest entry')
    out['stn'] = dict(loss_abs_err=loss_err, d_grad_err=d_err,
                      d_grad_spread_cpu=d_floor, d_grad_bound=d_bound,
                      stn_grad_err=s_err, stn_grad_spread_cpu=s_floor,
                      stn_grad_bound=s_bound, launches=launches)
    log(f'  ok  pretrain_stn micro step (narrow SG2 D, R1), card against '
        f'CPU: losses within {loss_err:.3g} (atol {TOL_TRAIN_LOSS}); D '
        f'gradients within {d_err:.3g} of the largest entry (CPU moved '
        f'1e-6: {d_floor:.3g}, limit {d_bound:.3g}); STN gradients within '
        f'{s_err:.3g} (CPU moved 1e-6: {s_floor:.3g}, limit '
        f'{s_bound:.3g}); launches {launches}')
    return out


def phase_stage0(card, kernels, tmp, device='cuda'):
    """Checkpoint interop and stage-0 pretraining at config ``aio``'s
    widths, on phase 13's dataset and EMA snapshot: a reference SG2-ADA
    ``.pkl`` of config aio's largest layer (seeded, unconditional and with
    ``c_dim`` 10) through ``cli/generate`` (with ``--class 3``), a batch
    held to the plain route, ``convert-pickle`` and ``generate`` of the
    snapshot bit for bit; ``export-torch --format pth`` of the EMA snapshot
    read back through ``torch_import`` (sampling bit for bit) and scored by
    ``compare-renderers``; ``pretrain-renderer`` (tanh at batch 64, then
    sigmoid and subpixel) and ``pretrain-stn`` (the SG2 D at batch 16 on the
    pretrained renderer and on the exported one, then the simple Ds); one
    micro step of each pretrainer, card against CPU.  Every run's launches
    of K1', K1' grad and K2' are held exactly to ``tools/launches.py``."""
    import statistics as st
    import numpy as np
    import torch
    from montage_gan_tpu_torch.cli import (compare_renderers, convert_pickle,
                                           export_torch, generate,
                                           pretrain_renderer, pretrain_stn)
    from montage_gan_tpu_torch.tools.launches import (
        expected_generator_launches, expected_stn_pretrain_launches)
    from montage_gan_tpu_torch.tools.seeded import (seeded_generator,
                                                    write_persistence_pkl)
    from montage_gan_tpu_torch.training.pretrain import build_discriminator
    from montage_gan_tpu_torch.utils import torch_import
    from montage_gan_tpu_torch.utils.checkpoint import load_network
    from montage_gan_tpu_torch.utils.pkl_import import generator_from_pkl
    from montage_gan_tpu_torch.utils.png import read_png_rgba
    from montage_gan_tpu_torch.utils.serving import build_inference_fn

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    work = os.path.join(tmp, 'stage0')
    os.makedirs(work)
    layers = os.path.join(tmp, 'layers')
    out = {'launches': {}}

    def counted(label, fn, expect):
        for k in kernels.values():
            k.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = {name: k.launches for name, k in kernels.items()}
        want = {name: expect.get(name, 0) for name in kernels}
        if got != want:
            raise AssertionError(f'{label}: launches {got}, expected {want}')
        out['launches'][label] = got
        return result, sec

    # 1. a reference .pkl: generate, the plain route, convert-pickle
    seeds = list(range(8))
    pkls = {}
    for c_dim in (0, 10):
        kw = dict(PKL_KW, c_dim=c_dim)
        path = os.path.join(work, f'net-c{c_dim}.pkl')
        t0 = time.perf_counter()
        write_persistence_pkl(path, {'G_ema': seeded_generator(kw, SEED)},
                              {'G_ema': kw})
        pkls[c_dim] = path
        log(f'[stage0] wrote {path}: {os.path.getsize(path)} bytes in '
            f'{time.perf_counter() - t0:.1f} s')
    mapping, synthesis, kw = generator_from_pkl(pkls[0])
    per_image = expected_generator_launches(mapping, synthesis)
    for c_dim, extra in ((0, []), (10, ['--class', '3'])):
        d = os.path.join(work, f'pkl-c{c_dim}')
        _, sec = counted(f'generate_pkl_c{c_dim}', lambda: generate.main([
            '--network', pkls[c_dim], '--seeds', '0-7', '--outdir', d,
            '--device', device, *extra]),
            {k: len(seeds) * v + (len(seeds) if k == 'bias_act' and c_dim
                                  else 0) for k, v in per_image.items()})
        imgs = [read_png_rgba(os.path.join(d, f'seed{s:04d}.png'))
                for s in seeds]
        out[f'generate_pkl_c{c_dim}'] = dict(seconds=sec,
                                             images_per_s=len(seeds) / sec)
        log(f'  ok  cli/generate --network {os.path.basename(pkls[c_dim])} '
            f'--seeds 0-7 {" ".join(extra)}: {len(seeds)} RGBA PNGs '
            f'{imgs[0].shape} in {sec:.2f} s ({len(seeds) / sec:.2f} '
            f'images/s, the pickle read included)  card: {card}')
    z = torch.from_numpy(seed_z(seeds, kw['z_dim'])).to(device)
    mapping, synthesis = mapping.to(device), synthesis.to(device)
    out['pkl_batch'] = check_pkl_batch(mapping, synthesis, kw, z, kernels,
                                       device)
    t0 = time.perf_counter()
    snap = convert_pickle.main(['--source', pkls[0], '--dest',
                                os.path.join(work, 'net.pt')])
    convert_s = time.perf_counter() - t0
    d = os.path.join(work, 'snap')
    counted('generate_converted', lambda: generate.main([
        '--network', snap, '--seeds', '0-7', '--save-layers', '--outdir', d,
        '--device', device]), {k: len(seeds) * v
                               for k, v in per_image.items()})
    for s_ in seeds:
        a = read_png_rgba(os.path.join(work, 'pkl-c0', f'seed{s_:04d}.png'))
        b = read_png_rgba(os.path.join(d, f'seed{s_:04d}-0_image.png'))
        if not np.array_equal(a, b):
            raise AssertionError(f'seed {s_}: the converted snapshot\'s '
                                 'image is not the .pkl\'s')
    out['convert_pickle_s'] = convert_s
    log(f'  ok  cli/convert_pickle in {convert_s:.1f} s; cli/generate of the '
        'snapshot equals the .pkl\'s images bit for bit (8 seeds)')
    del mapping, synthesis

    # 2. export-torch of phase 13's EMA snapshot, read back
    ema = os.path.join(tmp, TOOLS_SNAPSHOT)
    pth = os.path.join(work, 'network-snapshot.pth')
    _, export_s = counted('export_torch', lambda: export_torch.main([
        '--network', ema, '--dest', pth]), {})
    cfg, model = load_network(ema, device=device)
    t0 = time.perf_counter()
    back = torch_import.load_aio_snapshot(pth, cfg).to(device).eval()
    import_s = time.perf_counter() - t0
    z = torch.from_numpy(seed_z(seeds, cfg.z_dim)).to(device)
    for composite in ('alpha', 'renderer'):
        ref = build_inference_fn(cfg, model, composite=composite)(z)
        got = build_inference_fn(cfg, back, composite=composite)(z)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f'export -> import: {composite} sampling '
                                 'differs from the snapshot\'s')
    del model, back
    scores, cmp_s = counted('compare_renderers_pth', lambda: (
        compare_renderers.main(['--data', layers, '--ckpt', ema, '--ckpt',
                                pth, '--batch', '16', '--device', device])),
        {})
    if scores[pth] != scores[ema]:
        raise AssertionError(f'compare_renderers: {scores}')
    out['export'] = dict(bytes=os.path.getsize(pth), export_s=export_s,
                         import_s=import_s, compare_renderers_s=cmp_s,
                         psnr_db=scores[pth])
    log(f'  ok  cli/export_torch --format pth: {os.path.getsize(pth)} bytes '
        f'in {export_s:.2f} s; torch_import.load_aio_snapshot in '
        f'{import_s:.2f} s samples as the snapshot, bit for bit (alpha and '
        f'renderer composites); compare_renderers of the .pth: '
        f'{scores[pth]:.4f} dB, the snapshot\'s  card: {card}')

    # 3. pretrain-renderer at batch 64, then sigmoid and subpixel
    def figures(result, steps_from=1):
        later = result.step_s[steps_from:]
        return dict(steps=len(result.step_s),
                    s_per_step=st.median(later) if later else None,
                    first_step_s=result.step_s[0],
                    data_wait_s=result.data_wait_s,
                    peak_bytes=result.peak_bytes)

    runs = {}
    for rtype, steps, batch in (('tanh', STAGE0_STEPS, STAGE0_RENDERER_BATCH),
                                ('sigmoid', 2, STAGE0_RENDERER_BATCH),
                                ('subpixel', 2, STAGE0_RENDERER_BATCH)):
        res, sec = counted(f'pretrain_renderer_{rtype}',
                           lambda: pretrain_renderer.main([
                               '--data', layers, '--outdir',
                               os.path.join(work, f'renderer-{rtype}'),
                               '--renderer-type', rtype, '--batch',
                               str(batch), '--steps', str(steps),
                               '--device', device]), {})
        if not np.isfinite(res.loss + res.psnr).all():
            raise AssertionError(f'pretrain_renderer {rtype}: {res.loss}')
        runs[rtype] = res
        out[f'pretrain_renderer_{rtype}'] = dict(
            figures(res), batch=batch, seconds=sec, psnr_first=res.psnr[0],
            psnr_last=res.psnr[-1], loss_first=res.loss[0],
            loss_last=res.loss[-1])
        f = out[f'pretrain_renderer_{rtype}']
        log(f'  ok  pretrain_renderer {rtype} batch {batch}, {steps} steps: '
            f'{f["s_per_step"]:.4f} s a step after step 1 (step 1 '
            f'{f["first_step_s"]:.2f} s), PSNR {res.psnr[0]:.2f} -> '
            f'{res.psnr[-1]:.2f} dB, data wait {res.data_wait_s:.2f} s, peak '
            f'{(res.peak_bytes or 0) / 2**30:.2f} GiB; no kernel of the five '
            f'launched (cuDNN)  card: {card}')
    renderer_ckpt = runs['tanh'].snapshots[-1]
    del runs

    # 4. pretrain-stn: the SG2 D on each renderer, then the simple Ds
    from montage_gan_tpu_torch.data.dataset import DatasetAIO
    d_sg2 = build_discriminator('sg2', DatasetAIO(layers).resolution, 4)
    for label, disc, steps, ckpt in (
            ('sg2', 'sg2', STAGE0_STN_STEPS - 1, renderer_ckpt),
            ('sg2_exported_renderer', 'sg2', 3, pth),
            ('simple', 'simple', 1, renderer_ckpt),
            ('simplev2', 'simplev2', 1, renderer_ckpt)):
        expect = (expected_stn_pretrain_launches(d_sg2, steps + 1)
                  if disc == 'sg2' else {})
        res, sec = counted(f'pretrain_stn_{label}', lambda: pretrain_stn.main([
            '--data', layers, '--outdir', os.path.join(work, f'stn-{label}'),
            '--renderer-ckpt', ckpt, '--discriminator', disc, '--batch',
            str(STAGE0_STN_BATCH), '--steps', str(steps), '--device',
            device]), expect)
        last = res.records[-1]
        if not all(math.isfinite(v) for r in res.records for v in r.values()):
            raise AssertionError(f'pretrain_stn {label}: {res.records}')
        out[f'pretrain_stn_{label}'] = dict(
            figures(res), batch=STAGE0_STN_BATCH, seconds=sec,
            first=res.records[0], last=last)
        f = out[f'pretrain_stn_{label}']
        log(f'  ok  pretrain_stn {label} batch {STAGE0_STN_BATCH} (x3), '
            f'{steps + 1} steps: {f["s_per_step"]:.4f} s a step after step 0 '
            f'(step 0 {f["first_step_s"]:.2f} s), data wait '
            f'{res.data_wait_s:.2f} s, peak '
            f'{(res.peak_bytes or 0) / 2**30:.2f} GiB; '
            f'D loss {res.records[0]["d_loss"]:.4f} -> {last["d_loss"]:.4f}, '
            f'gp {last["gp"]:.4f}, renderer MSE {last["r_loss"]:.6f}; '
            f'launches {out["launches"][f"pretrain_stn_{label}"]}  card: '
            f'{card}')
        del res

    # 5. one micro step of each pretrainer, card against CPU
    out['micro_steps'] = stage0_micro_steps(kernels, device)
    out['phase_s'] = time.perf_counter() - t_phase
    log(f'[stage0] {out["phase_s"]:.1f} s')
    return out


# The single-GAN phase: StyleGAN2-ADA's paper256 at 256 px and the
# conditional cifar config at 32 px, batch 64, 5 steps each (--kimg 0.32).
SINGLE_SAMPLES = 128
SINGLE_RES = 256
SINGLE_BATCH = 64
SINGLE_KIMG = '0.32'
CIFAR_PER_BATCH = 64                 # images in each data_batch_* pickle
CIFAR_CLASSES = 10
CIFAR_FREEZED = 2
PAPER256_KW = dict(z_dim=512, w_dim=512, img_resolution=SINGLE_RES,
                   img_channels=3, c_dim=0, mapping_kwargs=dict(num_layers=8),
                   synthesis_kwargs=dict(channel_base=16384, channel_max=512,
                                         num_fp16_res=4, conv_clamp=256))
PAPER256_D_KW = dict(c_dim=0, img_resolution=SINGLE_RES, img_channels=3,
                     channel_base=16384, channel_max=512, num_fp16_res=4,
                     conv_clamp=256, mbstd_group_size=8)


class _Tee:
    """Writes to standard output and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return ''.join(self.parts)


def single_micro_step(device='cuda'):
    """One labelled training step (Freeze-D of 2 layers, ADA's bgc pipe at
    p 0.6, learning rate 0 so that each phase reads the same weights) of a
    float32 micro single-GAN ensemble on the CPU (plain versions) and on the
    card (kernels), with the same weights, reals, labels and draws: each
    phase's loss within ``TOL_TRAIN_LOSS`` and gradients within
    ``TOL_TRAIN_GRAD`` of the phase's largest entry, or ten times the CPU's
    spread when its weights move by 1e-6 where that is larger."""
    import numpy as np
    import torch
    from montage_gan_tpu_torch.models.ensemble import (MontageConfig,
                                                       MontageEnsemble)
    from montage_gan_tpu_torch.training.augment import make_augment_config
    from montage_gan_tpu_torch.training.train_step import (MontageTrainer,
                                                           TrainHyper)
    cfg = MontageConfig(
        layer_names=('image',), layer_targets=((32, 32),),
        base_resolution=32, img_channels=3, conv_config_index=2, z_dim=32,
        w_dim=32, c_dim=CIFAR_CLASSES, freeze_d_layers=CIFAR_FREEZED,
        mapping_num_layers=2, channel_base=512, channel_max=32,
        num_fp16_res=0, conv_clamp=256, mbstd_group_size=2,
        use_global_mapping=False, train_global=False, renderer_type='none')
    hyper = TrainHyper(lrate=0.0, batch_size=4, train_global=False,
                       train_renderer=False, bypass_renderer=True,
                       augment=make_augment_config('bgc'),
                       augment_p_init=0.6)
    base = MontageEnsemble(cfg, with_d=True).init_weights(SEED + 9)
    with torch.no_grad():
        for name, p in base.named_parameters():    # zero-init terms do work
            if name.endswith(('bias', 'noise_strength')):
                p.add_(torch.randn(p.shape, generator=torch.Generator()
                                   .manual_seed(len(name))) * 0.1)
    rng = np.random.RandomState(SEED + 9)
    crops = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    eye = np.eye(CIFAR_CLASSES, dtype=np.float32)
    real_c, gen_c = (eye[rng.randint(0, CIFAR_CLASSES, 4)] for _ in range(2))

    def run(model, dev):
        draws = cpu_draws(SEED + 10, dev)
        trainer = MontageTrainer(MontageEnsemble(cfg, with_d=True), hyper,
                                 device=dev)
        state = trainer.state_from_variables(model.state_dict())
        grads = {}
        trainer.phase_hook = lambda name, g: grads.__setitem__(
            name, [None if t is None else t.detach().cpu() for t in g])
        _, stats = trainer.train_step(state, None, [crops], draws,
                                      real_c=real_c, gen_c=gen_c)
        return {k: float(v) for k, v in stats.items()
                if '/Loss/' in k and '/signs/' not in k}, grads

    ref_stats, ref = run(base, 'cpu')
    stats, got = run(base, device)
    n_stats, nudged = run(nudged_copy(base), 'cpu')
    out = {}
    for phase in ref:
        worst, at = spread(got[phase], ref[phase])
        floor, _ = spread(nudged[phase], ref[phase])
        limit = max(TOL_TRAIN_GRAD, 10 * floor)
        if not worst <= limit:
            raise AssertionError(f'single micro step {phase}: gradient {at} '
                                 f'differs by {worst:.3g} of the phase\'s '
                                 f'largest entry (limit {limit:.3g})')
        out[phase] = dict(grad_err=worst, nudged_spread=floor)
    worst_loss = 0.0
    for k, v in ref_stats.items():
        limit = max(TOL_TRAIN_LOSS, 10 * abs(n_stats[k] - v))
        if not abs(stats[k] - v) <= limit:
            raise AssertionError(f'single micro step {k}: {stats[k]} on the '
                                 f'card, {v} on the CPU (limit {limit:.3g})')
        worst_loss = max(worst_loss, abs(stats[k] - v))
    out['loss_max_abs_err'] = worst_loss
    log(f'  ok  one labelled micro step (Freeze-D {CIFAR_FREEZED}), card '
        f'against CPU: losses within {worst_loss:.3g} (atol '
        f'{TOL_TRAIN_LOSS}); gradients ' + ', '.join(
            f'{ph} {v["grad_err"]:.3g} (CPU moved 1e-6: '
            f'{v["nudged_spread"]:.3g})' for ph, v in out.items()
            if isinstance(v, dict)) + f' of the phase\'s largest entry '
        f'(limit {TOL_TRAIN_GRAD})')
    return out


def transfer_entries(nets) -> int:
    """The entries of a ``.pkl``'s G, D and G_ema (``{'G': module, ...}``)
    that ``pkl_import.transfer_into_train_state`` maps into a single-GAN
    train state."""
    from montage_gan_tpu_torch.utils.pkl_import import _jax_path
    parts = (('G', 'mapping.', 'mapping'), ('G', 'synthesis.', 'synthesis'),
             ('G_ema', 'mapping.', 'mapping'),
             ('G_ema', 'synthesis.', 'synthesis'), ('D', '', 'd'))
    return sum(_jax_path(net, k[len(prefix):]) is not None
               for key, prefix, net in parts
               for k in nets[key].state_dict() if k.startswith(prefix))


def phase_single(card, kernels, tmp, device='cuda'):
    """The single-GAN path in ``tmp/single``: ``dataset-tool`` of
    ``SINGLE_SAMPLES`` synthetic 256 px RGB PNGs (the port's writer) into a
    zip, and of five synthetic CIFAR-10 pickles into a labelled zip;
    ``train --cfg paper256`` for 5 steps at batch 64 resumed from a seeded
    ``paper256`` ``.pkl`` (G, D, G_ema) through
    ``transfer_into_train_state``; ``train --cfg cifar --cond true
    --freezed 2`` for 5 steps with its first layers checked bit for bit and
    ``generate`` of its EMA snapshot; ``calc-metrics --metrics fid2k`` of the
    ``.pkl`` on the 256 px zip (phase 15's random-weight detectors) after
    one batch of 16 through K1'/K2' is held to the plain route; one micro
    labelled step, card against CPU.  Every run's launches of K1'-K4' are
    held exactly to ``tools/launches.py``."""
    import pickle
    import numpy as np
    import torch
    from montage_gan_tpu_torch.cli import (calc_metrics, dataset_tool,
                                           generate, train)
    from montage_gan_tpu_torch.models.discriminator import Discriminator
    from montage_gan_tpu_torch.models.ensemble import MontageEnsemble
    from montage_gan_tpu_torch.tools.launches import (
        expected_generator_launches, expected_train_launches)
    from montage_gan_tpu_torch.tools.seeded import (seeded_generator,
                                                    use_detectors,
                                                    write_persistence_pkl,
                                                    write_random_detectors)
    from montage_gan_tpu_torch.utils.config import EasyDict
    from montage_gan_tpu_torch.utils.pkl_import import generator_from_pkl
    from montage_gan_tpu_torch.utils.png import read_png_rgba, write_png

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    work = os.path.join(tmp, 'single')
    os.makedirs(work)
    out = {'launches': {}}

    def counted(label, fn, expect):
        for k in kernels.values():
            k.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = {name: k.launches for name, k in kernels.items()}
        want = {name: expect.get(name, 0) for name in kernels}
        if got != want:
            raise AssertionError(f'{label}: launches {got}, expected {want}')
        out['launches'][label] = got
        return result, sec

    # 1. the data: dataset-tool of 256 px PNGs, and of CIFAR-10 pickles
    src = os.path.join(work, 'images')
    os.makedirs(src)
    rng = np.random.RandomState(SEED)
    t0 = time.perf_counter()
    yy, xx = np.mgrid[0:SINGLE_RES, 0:SINGLE_RES] / SINGLE_RES
    for i in range(SINGLE_SAMPLES):
        f = rng.uniform(1, 6, 3)
        smooth = 0.5 + 0.5 * np.sin(2 * np.pi * (f[:, None, None] * xx
                                                 + f[::-1, None, None] * yy))
        img = smooth.transpose(1, 2, 0) * 200 + rng.uniform(0, 55, (
            SINGLE_RES, SINGLE_RES, 3))
        write_png(os.path.join(src, f'{i:04d}.png'), img.astype(np.uint8))
    write_s = time.perf_counter() - t0
    zip256 = os.path.join(work, 'images256.zip')
    t0 = time.perf_counter()
    n = dataset_tool.main(['--source', src, '--dest', zip256])
    tool_s = time.perf_counter() - t0
    cifar = os.path.join(work, 'cifar')
    os.makedirs(cifar)
    for b in range(1, 6):
        with open(os.path.join(cifar, f'data_batch_{b}'), 'wb') as f:
            pickle.dump({'data': rng.randint(0, 256, (CIFAR_PER_BATCH, 3072))
                         .astype(np.uint8), 'labels': [
                             int(v) for v in rng.randint(
                                 0, CIFAR_CLASSES, CIFAR_PER_BATCH)]}, f)
    cifar_zip = os.path.join(work, 'cifar10.zip')
    t0 = time.perf_counter()
    n_cifar = dataset_tool.main(['--source', cifar, '--source-type',
                                 'cifar10', '--dest', cifar_zip])
    cifar_s = time.perf_counter() - t0
    if (n, n_cifar) != (SINGLE_SAMPLES, 5 * CIFAR_PER_BATCH):
        raise AssertionError(f'dataset-tool wrote {n} and {n_cifar} images')
    out['data'] = dict(write_s=write_s, dataset_tool_s=tool_s,
                       dataset_tool_cifar10_s=cifar_s,
                       zip_bytes=os.path.getsize(zip256))
    log(f'[single] {SINGLE_SAMPLES} RGB PNGs {SINGLE_RES} px written in '
        f'{write_s:.1f} s; dataset-tool to a zip ({os.path.getsize(zip256)} '
        f'bytes) in {tool_s:.1f} s; dataset-tool --source-type cifar10 of '
        f'{n_cifar} labelled images in {cifar_s:.1f} s')

    # 2. a seeded paper256 .pkl: G, D, G_ema
    pkl = os.path.join(work, 'paper256.pkl')
    t0 = time.perf_counter()
    d = Discriminator(**{k: v for k, v in PAPER256_D_KW.items()
                         if k != 'c_dim'})
    g = torch.Generator().manual_seed(SEED + 11)
    with torch.no_grad():
        d.reset_parameters(g)
        for name, t in d.named_parameters():
            if name.endswith('bias'):
                t.add_(torch.randn(t.shape, generator=g) * 0.1)
    nets = {'G': seeded_generator(PAPER256_KW, SEED), 'D': d,
            'G_ema': seeded_generator(PAPER256_KW, SEED + 1)}
    write_persistence_pkl(pkl, nets, {'G': PAPER256_KW, 'D': PAPER256_D_KW,
                                      'G_ema': PAPER256_KW})
    # equal resolution and widths: every entry the transfer maps is copied
    expect_copied = transfer_entries(nets)
    del d, nets
    log(f'  wrote {pkl}: {os.path.getsize(pkl)} bytes in '
        f'{time.perf_counter() - t0:.1f} s')

    # 3. train paper256 from the .pkl, and train cifar --cond --freezed
    def train_run(label, argv, batch):
        argv = [*argv, '--batch', str(batch)]
        opts = EasyDict(vars(train.make_parser().parse_args(argv)))
        run = train.setup(opts, 1)
        marks = []

        def hook(it, state, stats):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        loop, saved = train.train_loop, sys.stdout
        train.train_loop = lambda *a, **k: loop(*a, step_hook=hook, **k)
        tee = sys.stdout = _Tee(saved)
        try:
            state = None

            def fn():
                nonlocal state
                state = train.main(argv)
            model = MontageEnsemble(run.cfg, with_d=True)
            steps = int(round(float(opts.kimg) * 1000 / batch))
            expect = expected_train_launches(model, run.hyper, steps)
            grid = expected_generator_launches(model.mapping,
                                               model.local_g[0])
            for k, v in grid.items():
                expect[k] += v                 # the fakes grid of the EMA
            _, sec = counted(label, fn, expect)
        finally:
            train.train_loop, sys.stdout = loop, saved
        peak = torch.cuda.max_memory_allocated() / 2**30
        run_dir = os.path.join(opts.outdir, sorted(os.listdir(
            opts.outdir))[-1])
        records = read_stats(run_dir)
        bad = [k for r in records for k, v in r.items()
               if isinstance(v, dict) and not math.isfinite(v['mean'])]
        need = {'log.txt', 'stats.jsonl', 'fakes000000.png',
                'network-snapshot-000000.pt', 'ema-snapshot-000000.pt'}
        if bad or need - set(os.listdir(run_dir)) or state.step != steps:
            raise AssertionError(f'{label}: {run_dir}, non-finite {bad}, '
                                 f'step {state.step}')
        fig = dict(batch=batch, steps=steps, seconds=sec,
                   s_per_step=float(np.mean(np.diff(marks))),  # steps 2-5
                   data_wait_s=records[-1]['Timing/data_fetch']['mean'],
                   peak_gib=peak, launches=out['launches'][label])
        return state, run_dir, fig, tee.text()

    base = ['--data', zip256, '--cfg', 'paper256', '--kimg', SINGLE_KIMG,
            '--resume', pkl, '--device', device]
    try:
        state, run_dir, fig, text = train_run(
            'train_paper256', ['--outdir', os.path.join(work, 'runs256'),
                               *base], SINGLE_BATCH)
    except torch.OutOfMemoryError:
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f'  train --cfg paper256 at batch {SINGLE_BATCH} does not fit: '
            f'peak {peak:.2f} GiB; batch {SINGLE_BATCH // 2} instead')
        out['paper256_batch64_oom_peak_gib'] = peak
        gc.collect()
        torch.cuda.empty_cache()
        state, run_dir, fig, text = train_run(
            'train_paper256', ['--outdir', os.path.join(work, 'runs256b'),
                               *base], SINGLE_BATCH // 2)
    line = [ln for ln in text.splitlines()
            if ln.startswith('transfer_into_train_state')]
    m = re.search(r'copied (\d+) tensors, skipped (\d+)', ' '.join(line))
    if not m or (int(m.group(1)), int(m.group(2))) != (expect_copied, 0):
        raise AssertionError(f'train --resume {pkl}: {line}, expected '
                             f'copied {expect_copied} tensors, skipped 0')
    fig.update(copied=int(m.group(1)), skipped=int(m.group(2)))
    out['paper256'] = fig
    log(f'  ok  train --cfg paper256 --resume .pkl ({line[0]}): '
        f'{fig["steps"]} steps at batch {fig["batch"]}, '
        f'{fig["s_per_step"]:.3f} s a step over steps 2-{fig["steps"]}, '
        f'data wait {fig["data_wait_s"]:.4f} s a step, peak '
        f'{fig["peak_gib"]:.2f} GiB; launches {fig["launches"]} exactly '
        f'expected_train_launches + the fakes grid  card: {card}')
    del state
    gc.collect()
    torch.cuda.empty_cache()

    cargv = ['--outdir', os.path.join(work, 'runs-cifar'), '--data',
             cifar_zip, '--cfg', 'cifar', '--cond', 'true', '--freezed',
             str(CIFAR_FREEZED), '--kimg', SINGLE_KIMG, '--device', device]
    state, run_dir, fig, _ = train_run('train_cifar_cond_freezed', cargv,
                                       SINGLE_BATCH)
    init = MontageEnsemble(state.model.cfg, with_d=True).init_weights(SEED)
    frozen = moved = 0
    live = state.model.local_d[0].state_dict()
    for k, v in init.local_d[0].state_dict().items():
        if k.endswith('resample_filter'):
            continue
        same = torch.equal(live[k].cpu(), v)
        layer = k.rsplit('.', 1)[0]
        if layer in ('b32.fromrgb', 'b32.conv0'):
            if not same:
                raise AssertionError(f'Freeze-D: {k} moved')
            frozen += 1
        moved += int(not same)
    if frozen != 2 * CIFAR_FREEZED or moved == 0:
        raise AssertionError(f'Freeze-D: {frozen} frozen tensors, {moved} '
                             'moved')
    fig.update(frozen_tensors_bit_identical=frozen, d_tensors_moved=moved)
    out['cifar'] = fig
    log(f'  ok  train --cfg cifar --cond true --freezed {CIFAR_FREEZED}: '
        f'{fig["steps"]} steps at batch {fig["batch"]}, '
        f'{fig["s_per_step"]:.3f} s a step over steps 2-{fig["steps"]}, '
        f'peak {fig["peak_gib"]:.2f} GiB; the first {CIFAR_FREEZED} D layers '
        f'({frozen} tensors) bit for bit as initialised, {moved} D tensors '
        f'moved; launches {fig["launches"]} exactly  card: {card}')
    snap = os.path.join(run_dir, 'ema-snapshot-000000.pt')
    per = expected_generator_launches(state.ema.mapping, state.ema.local_g[0])
    gen_dir = os.path.join(work, 'generate-cifar')
    _, sec = counted('generate_cifar', lambda: generate.main([
        '--network', snap, '--seeds', '0-7', '--class', '3', '--outdir',
        gen_dir, '--device', device]), {k: 8 * v for k, v in per.items()})
    img = read_png_rgba(os.path.join(gen_dir, 'seed0000.png'))
    out['generate_cifar_s'] = sec
    log(f'  ok  cli/generate --class 3 of its EMA snapshot: 8 RGB PNGs '
        f'{img.shape[:2]} in {sec:.2f} s')
    del state, init
    gc.collect()
    torch.cuda.empty_cache()

    # 4. calc-metrics fid2k of the .pkl on the 256 px zip
    if not os.path.exists(os.path.join(tmp, 'weights', 'inception.npz')):
        write_random_detectors(os.path.join(tmp, 'weights'), SEED)
    use_detectors(os.path.join(tmp, 'weights'))
    mapping, synthesis, kw = generator_from_pkl(pkl)
    mapping, synthesis = mapping.to(device), synthesis.to(device)
    z = torch.from_numpy(seed_z(list(range(METRIC_BATCH)),
                                kw['z_dim'])).to(device)
    out['pkl_batch'] = check_pkl_batch(mapping, synthesis, kw, z, kernels,
                                       device)
    per = expected_generator_launches(mapping, synthesis)
    del mapping, synthesis
    batches = math.ceil(2000 / METRIC_BATCH)
    results, sec = counted('calc_metrics_pkl_fid2k', lambda: calc_metrics.main(
        ['--network', pkl, '--data', zip256, '--metrics', 'fid2k',
         '--batch', str(METRIC_BATCH), '--cache-dir',
         os.path.join(work, 'metric-cache'), '--device', device]),
        {k: batches * v for k, v in per.items()})
    fid = results[0].results['fid2k']
    if not (math.isfinite(fid) and fid >= 0):
        raise AssertionError(f'calc-metrics fid2k of the .pkl: {fid}')
    out['calc_metrics_pkl'] = dict(fid2k=fid, seconds=sec)
    log(f'  ok  calc-metrics --metrics fid2k of the .pkl on the zip: '
        f'{fid:.6g} in {sec:.1f} s; launches exactly {batches} sampling '
        f'calls\' {per}  card: {card}')

    # 5. one labelled micro step, card against CPU
    out['micro_step'] = single_micro_step(device)
    out['phase_s'] = time.perf_counter() - t_phase
    log(f'[single] {out["phase_s"]:.1f} s')
    return out


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
    seconds = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        seconds[name] = round(time.perf_counter() - t0, 1)
        log(f'[seconds] {name} {seconds[name]}')
        return result
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
    seconds['1-2 device, build'] = round(time.perf_counter() - START, 1)
    k1 = timed('3 kernels: bias_act', phase_bias_act, 'cuda', card)
    x = torch.empty(8, 256, 256, 64, dtype=torch.bfloat16)
    checks = {'bias_act': (*k1, *bound(2 * nbytes(x), 5 * x.numel()), None)}
    k2, k2_backward = timed('3 kernels: upfirdn2d', phase_upfirdn2d, 'cuda',
                            card)
    x = torch.empty(8, 128, 128, 4)
    checks['upfirdn2d'] = (*k2, *bound(5 * nbytes(x), 8 * 4 * x.numel()),
                           library_upsample_ms('cuda'))
    warp = timed('4 warp', phase_warp, 'cuda', card)
    warp_extra = {k: warp.pop(k) for k in ('two_calls', 'direct_share',
                                           'host_us')}
    checks.update(warp)
    grads = timed('5 grads', phase_grads, 'cuda', card)
    checks['bias_act_grad'] = grads['bias_act_grad']

    slice_kernels = {k: kernels[k] for k in ('bias_act', 'upfirdn2d')}
    tool_kernels = ('bias_act', 'bias_act_grad', 'upfirdn2d')
    train_kernels = ('bias_act', 'bias_act_grad', 'upfirdn2d',
                     'warp_forward', 'warp_transpose')
    model, z = timed('6 slice', phase_slice, card, slice_kernels,
                     MontageConfig())
    composite_check, composite_launches, composite_extra = timed(
        '10 composite', phase_composite, card, model, z)
    checks.update(composite_check)
    del model
    timed('7 cross-device', phase_cross_device)
    timed('8 train', phase_train, card, kernels,
          MontageConfig(train_global=False))
    timed('9 train cross-device', phase_train_cross_device)
    launches, variants = timed('11 aio train', phase_aio_train, card,
                               kernels, MontageConfig())
    launches['composite'] = composite_launches
    timed('12 aio cross-device', phase_aio_cross_device)
    gc.collect()
    torch.cuda.empty_cache()
    ddp = timed('14 ddp', phase_ddp, card)
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix='mgt-loop-')
    try:
        loop = timed('13 loop', phase_loop, card, kernels, tmp)
        metrics = timed('15 metrics', phase_metrics, card,
                        {k: kernels[k] for k in slice_kernels}, tmp)
        tools = timed('16 tools', phase_tools, card,
                      {k: kernels[k] for k in tool_kernels}, tmp)
        stage0 = timed('17 stage0', phase_stage0, card,
                       {k: kernels[k] for k in tool_kernels}, tmp)
        single = timed('18 single', phase_single, card,
                       {k: kernels[k] for k in train_kernels}, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

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
        row_loop = loop['launches'].get(name)
        rows.append({'name': name, 'route': 'cuda',
                     'source': f'montage_gan_tpu_torch/csrc/{src}',
                     'replaces': f'montage_gan_tpu/ops/pallas/{rep}',
                     'launches': launches[name], 'max_abs_err': err,
                     'ms': ms, 'plain_ms': plain, 'bound_ms': bound_ms,
                     'bound_by': bound_by, 'library_ms': lib})
        if name in ('bias_act', 'upfirdn2d', 'warp_forward',
                    'warp_transpose'):
            rows[-1]['launches_by_variant'] = variants[name]
        if name in ddp[0]['launches']:
            # the data-parallel steps, on each rank
            rows[-1]['launches_ddp_by_rank'] = [r['launches'][name]
                                                for r in ddp]
        if name in metrics['launches']:
            # calc_metric('fid2k') at config aio: 125 sampling calls
            rows[-1]['launches_fid2k'] = metrics['launches'][name]
        if name in tool_kernels:
            # the inference tools at config aio, each checked against
            # tools/launches.py (export: the tracing, which launches none)
            rows[-1]['launches_tools'] = {
                label: got[name] for label, got in tools['launches'].items()}
        if name in tool_kernels:
            # interop and stage 0 at config aio, each checked against
            # tools/launches.py (the renderer's pretraining launches none)
            rows[-1]['launches_stage0'] = {
                label: got[name] for label, got in stage0['launches'].items()}
        if name in train_kernels:
            # the single-GAN phase's runs, each checked against
            # tools/launches.py (train: 5 steps and the fakes grid)
            rows[-1]['launches_single'] = {
                label: got[name] for label, got in single['launches'].items()}
        if row_loop is not None:
            # the training CLI's one accumulated step at batch 32 (and its
            # EMA grid), checked against expected_train_launches
            rows[-1]['launches_cli_step_batch32'] = row_loop
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
    log(json.dumps({'loop': {k: v for k, v in loop.items()
                             if k != 'launches'}, 'card': card}))
    log(json.dumps({'metrics': metrics, 'card': card}))
    log(json.dumps({'tools': {k: v for k, v in tools.items()
                              if k != 'launches'}, 'card': card}))
    log(json.dumps({'stage0': {k: v for k, v in stage0.items()
                               if k != 'launches'}, 'card': card}))
    log(json.dumps({'ddp': [{k: v for k, v in r.items()
                             if k not in ('expected', 'launches')}
                            for r in ddp], 'card': card}))
    log(json.dumps({'phase_seconds': seconds, 'card': card}))
    log(f'[total] {time.perf_counter() - START:.1f} s')
    log(json.dumps({'single': {k: v for k, v in single.items()
                               if k != 'launches'}, 'card': card}))
    log(json.dumps({'kernels': rows}))
    log(card_line())
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
