"""Where the card's time goes on the port's main paths, by kernel family.

    python -m montage_gan_tpu_torch.tools.profile --path aio
    python -m montage_gan_tpu_torch.tools.profile --path train
    python -m montage_gan_tpu_torch.tools.profile --path sample

Full-width config ``aio`` (``MontageConfig()`` widths and depths) at batch 8,
seeded random weights, on the card:

* ``aio``: the all-in-one training step, ``TrainHyper()`` defaults (the
  renderer phase, the local phases, global Gmain/Dmain every step, global
  R1 every 16), augment ``bgcfnc`` at p 0.6, synthetic reals;
* ``train``: the local-phase training step (``train_global=False``).

  For both, step 0 (every phase) warms up; steps 1-3 (no regularizer) run
  under ``torch.profiler``; steps 5-7 run without it, timed on the host
  clock (steps 4 and 8 run Greg and are not timed); steps 9-11 again, with
  a synchronisation after each phase for the per-phase split; then one step
  numbered 16, where every regularizer runs, split the same way.
* ``sample``: ``build_inference_fn`` (``noise_mode='const'``); one warm-up
  call, 3 calls under the profiler, 5 timed without it.

Prints the kernel time per family and the 12 longest kernels, the wall time
with and without the profiler and the busy share (kernel time over the
unprofiled wall time), with the card's name and power limit.  For each
hand-written kernel it also prints, over the profiled steps: the kernel
time and launches per step, the bytes its launches had to move (each input
read once, each output written once, as the wrappers count them), the bound
those bytes set (over 3.35 TB/s) and the gap between the two, the largest
first; K1'-K4' with their launches by variant.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import time

import numpy as np
import torch

from .timing import PEAK_BYTES, card_line

# (family, substrings of the lower-cased kernel name); the first match wins,
# so every variant of a hand-written kernel (upfirdn2d_kernel,
# upfirdn2d_tiled_kernel) lands in its own family before the library
# families are tried.
FAMILIES = (
    ("K1' bias_act grad", ('bias_act_grad',)),
    ("K1' bias_act", ('bias_act',)),
    ("K2' upfirdn2d", ('upfirdn2d',)),
    ("K3' warp forward", ('warp_forward',)),
    ("K4' warp transpose", ('warp_transpose',)),
    ("K5' composite", ('composite_kernel',)),
    ('convolution (cuDNN)', ('conv', 'fprop', 'dgrad', 'wgrad', 'cudnn',
                             'winograd', 'implicit_gemm')),
    ('matrix products (cuBLAS)', ('gemm', 'gemv')),
    ('optimizer (Adam)', ('adam', 'multi_tensor_apply')),
    ('reductions', ('reduce',)),
    ('gather and scatter', ('index', 'gather', 'scatter', 'grid_sampler')),
    ('elementwise and copies', ('elementwise', 'copy', 'fill', 'cat',
                                'memcpy', 'memset')),
)
BATCH = 8
SEED = 0


def hand_written():
    """(family, kernel wrapper) of every hand-written kernel."""
    from ..ops import affine_warp, bias_act, composite, upfirdn2d
    return (("K1' bias_act", bias_act.kernel),
            ("K1' bias_act grad", bias_act.grad_kernel),
            ("K2' upfirdn2d", upfirdn2d.kernel),
            ("K3' warp forward", affine_warp.forward_kernel),
            ("K4' warp transpose", affine_warp.transpose_kernel),
            ("K5' composite", composite.kernel))


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return 'other'


def kernel_table(prof, calls: int):
    """Device time (ms per call) and launches per call, by family and by
    kernel name."""
    fam_ms = collections.Counter()
    fam_n = collections.Counter()
    name_ms = collections.Counter()
    for e in prof.events():
        # device events only, and not the ranges that record_function marks
        # on the device's timeline (Optimizer.step spans its own kernels)
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, 'is_user_annotation', False)
                or e.name.startswith(('Optimizer.', 'ProfilerStep'))):
            continue
        ms = e.time_range.elapsed_us() / 1e3 / calls
        fam = family(e.name)
        fam_ms[fam] += ms
        fam_n[fam] += 1 / calls
        name_ms[(fam, e.name)] += ms
    return fam_ms, fam_n, name_ms


def setup_train(aio: bool):
    """(state box, step function) of the AIO step, or of the local-phase
    step (``aio=False``)."""
    from ..data.synthetic import synthetic_batch
    from ..models.ensemble import MontageConfig, MontageEnsemble
    from ..training.augment import make_augment_config
    from ..training.train_step import MontageTrainer, TrainHyper
    from ..utils.image_utils import make_batch_for_local_d_np
    local = {} if aio else dict(train_global=False)
    cfg = MontageConfig(**local)
    hyper = TrainHyper(batch_size=BATCH, augment=make_augment_config('bgcfnc'),
                       augment_p_init=0.6, train_renderer=aio, **local)
    trainer = MontageTrainer(MontageEnsemble(cfg, with_d=True), hyper)
    box = {'state': trainer.init_state(SEED)}
    stack01 = synthetic_batch(np.random.RandomState(SEED), BATCH,
                              cfg.num_layers, cfg.base_resolution)
    crops = [torch.from_numpy(c).cuda() for c in make_batch_for_local_d_np(
        stack01, cfg.layer_targets, to_minus11=True)]
    stack = torch.from_numpy(stack01 * 2.0 - 1.0).float().cuda()
    gen = torch.Generator(device='cuda').manual_seed(SEED)

    def step():
        box['state'], _ = trainer.train_step(box['state'], stack, crops, gen)
    return box, step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--path', choices=('aio', 'train', 'sample'),
                    default='aio')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile: no CUDA device')
    from .. import set_fp32_precision
    set_fp32_precision()
    card = card_line()

    def timed_ms(fn, n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    phases = None
    training = args.path in ('aio', 'train')
    if training:
        box, step = setup_train(args.path == 'aio')
        timed_ms(step, 1)                                  # step 0
        calls, unit = 3, 'step'
        run = step
    else:
        from ..models.ensemble import MontageConfig, MontageEnsemble
        from ..utils.serving import build_inference_fn
        cfg = MontageConfig()
        model = MontageEnsemble(cfg).init_weights(SEED).cuda().eval()
        fn = build_inference_fn(cfg, model.requires_grad_(False))
        z = torch.randn(BATCH, cfg.z_dim, device='cuda',
                        generator=torch.Generator('cuda').manual_seed(SEED))
        run = lambda: fn(z)                               # noqa: E731
        timed_ms(run, 1)
        calls, unit = 3, 'call'

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    kernels = hand_written()
    for _, k in kernels:
        k.reset()
    with torch.profiler.profile(activities=acts) as prof:
        prof_ms = timed_ms(run, calls)
    counted = {fam: (k.launches / calls, k.bytes / calls, dict(k.variants))
               for fam, k in kernels}
    fam_ms, fam_n, name_ms = kernel_table(prof, calls)

    if training:
        timed_ms(step, 1)                                  # step 4 (Greg)
        wall = timed_ms(step, 3)                           # steps 5-7
        timed_ms(step, 1)                                  # step 8 (Greg)
        phases = phase_split(step, 3)                      # steps 9-11
        box['state'].step = 16                             # every regularizer
        reg_phases = phase_split(step, 1)
    else:
        wall = timed_ms(run, 5)
    total = sum(fam_ms.values())
    wall_ms = statistics.median(wall)
    print(f'[profile] {args.path}, config aio, batch {BATCH}  card: {card}')
    print(f'  wall {wall_ms:.2f} ms per {unit} (median, no profiler), '
          f'{statistics.median(prof_ms):.2f} under the profiler; kernel time '
          f'{total:.2f} ms, busy share {total / wall_ms:.3f}, '
          f'{sum(fam_n.values()):.0f} launches per {unit}')
    for fam, ms in fam_ms.most_common():
        print(f'  {fam:28s} {ms:9.3f} ms {fam_n[fam]:8.0f} launches '
              f'{100 * ms / total:6.1f}%')
    print('  longest kernels:')
    for (fam, name), ms in name_ms.most_common(12):
        print(f'    {ms:9.3f} ms  [{fam}] {name[:160]}')
    print(f'  hand-written kernels per {unit}: kernel ms, launches, bytes '
          f'moved, bound (bytes / {PEAK_BYTES / 1e12} TB/s), gap; largest '
          'gap first')
    rows = []
    for fam, (n, nbytes, variants) in counted.items():
        bound = nbytes / PEAK_BYTES * 1e3
        rows.append((fam_ms[fam] - bound, fam, n, nbytes, bound, variants))
    for gap, fam, n, nbytes, bound, variants in sorted(rows, reverse=True):
        by = f'  by variant {variants}' if len(variants) > 1 or fam in (
            "K1' bias_act", "K2' upfirdn2d", "K3' warp forward",
            "K4' warp transpose") else ''
        print(f'    {fam:20s} {fam_ms[fam]:9.3f} ms {n:7.0f} launches '
              f'(profiler {fam_n[fam]:.0f}) {nbytes / 1e9:8.3f} GB  bound '
              f'{bound:8.3f} ms  gap {gap:8.3f} ms{by}')
    if phases:
        for label, split in (('steps 9-11', phases),
                             ('step 16 (every regularizer)', reg_phases)):
            print(f'  per phase, {label}, local phases summed over the 9 '
                  'layers (synchronised after each): ' + ', '.join(
                      f'{k} {v:.1f} ms' for k, v in split.items()))


# The loss of each phase, by its name in training/losses.py.
PHASES = {'renderer_loss': 'renderer', 'local_gmain_loss': 'Gmain',
          'local_gpl_loss': 'Greg', 'local_dmain_loss': 'Dmain',
          'local_dr1_loss': 'Dr1', 'global_gmain_loss': 'global Gmain',
          'global_dmain_loss': 'global Dmain',
          'global_dr1_loss': 'global Dr1'}


def phase_split(step, steps: int):
    """Wall ms per phase (its loss, backward and optimizer step; the local
    phases summed over the layers) and of the rest of the step (EMA, ADA),
    with a synchronisation after each phase; the median over ``steps``
    calls of ``step``."""
    from ..training import losses
    from ..training import train_step as ts
    orig_apply = ts._apply_grads
    orig_losses = {name: getattr(losses, name) for name in PHASES}
    per_step = []
    mark = [0.0]
    current = ['']

    def labelled(name):
        def fn(*args, **kwargs):
            current[0] = PHASES[name]
            return orig_losses[name](*args, **kwargs)
        return fn

    def timed(opt, params, loss):
        orig_apply(opt, params, loss)
        torch.cuda.synchronize()
        now = time.perf_counter()
        per_step[-1][current[0]] += (now - mark[0]) * 1e3
        mark[0] = now

    ts._apply_grads = timed
    for name in PHASES:
        setattr(losses, name, labelled(name))
    try:
        for _ in range(steps):
            per_step.append(collections.Counter())
            torch.cuda.synchronize()
            mark[0] = time.perf_counter()
            step()
            torch.cuda.synchronize()
            per_step[-1]['EMA and ADA'] += (time.perf_counter() - mark[0]) * 1e3
    finally:
        ts._apply_grads = orig_apply
        for name, fn in orig_losses.items():
            setattr(losses, name, fn)
    return {k: statistics.median(s[k] for s in per_step) for k in per_step[0]}


if __name__ == '__main__':
    main()
