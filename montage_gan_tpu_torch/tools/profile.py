"""Where the card's time goes on the port's main paths, by kernel family.

    python -m montage_gan_tpu_torch.tools.profile --path train
    python -m montage_gan_tpu_torch.tools.profile --path sample

Full-width config ``aio`` (``MontageConfig()`` widths and depths) at batch 8,
seeded random weights, on the card:

* ``train``: the local-phase training step (``train_global=False``, augment
  ``bgcfnc`` at p 0.6, synthetic reals).  Step 0 (all four phases) warms up;
  steps 1-3 (Gmain + Dmain for each of the 9 layers) run under
  ``torch.profiler``; steps 5-7 (the same phases) run without it, timed on
  the host clock; steps 9-11 again, with a synchronisation after each phase
  for the per-phase split (steps 4 and 8 run Greg and are not timed).
* ``sample``: ``build_inference_fn`` (``noise_mode='const'``); one warm-up
  call, 3 calls under the profiler, 5 timed without it.

Prints the kernel time per family and the 12 longest kernels, the wall time
with and without the profiler and the busy share (kernel time over the
unprofiled wall time), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import subprocess
import time

import numpy as np
import torch

# (family, substrings of the lower-cased kernel name); the first match wins.
FAMILIES = (
    ("K1' bias_act grad", ('bias_act_grad_kernel',)),
    ("K1' bias_act", ('bias_act_kernel',)),
    ("K2' upfirdn2d", ('upfirdn2d_kernel',)),
    ("K3' warp forward", ('warp_forward_kernel',)),
    ("K4' warp transpose", ('warp_transpose_kernel',)),
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


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return 'other'


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def setup_train():
    from ..data.synthetic import synthetic_batch
    from ..models.ensemble import MontageConfig, MontageEnsemble
    from ..training.augment import make_augment_config
    from ..training.train_step import MontageTrainer, TrainHyper
    from ..utils.image_utils import make_batch_for_local_d_np
    cfg = MontageConfig(train_global=False)
    hyper = TrainHyper(batch_size=BATCH, train_global=False,
                       train_renderer=False,
                       augment=make_augment_config('bgcfnc'),
                       augment_p_init=0.6)
    trainer = MontageTrainer(MontageEnsemble(cfg, with_d=True), hyper)
    box = {'state': trainer.init_state(SEED)}
    stack01 = synthetic_batch(np.random.RandomState(SEED), BATCH,
                              cfg.num_layers, cfg.base_resolution)
    crops = [torch.from_numpy(c).cuda() for c in make_batch_for_local_d_np(
        stack01, cfg.layer_targets, to_minus11=True)]
    gen = torch.Generator(device='cuda').manual_seed(SEED)

    def step():
        box['state'], _ = trainer.train_step(box['state'], None, crops, gen)
    return box, step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--path', choices=('train', 'sample'), default='train')
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
    if args.path == 'train':
        box, step = setup_train()
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
    with torch.profiler.profile(activities=acts) as prof:
        prof_ms = timed_ms(run, calls)
    fam_ms, fam_n, name_ms = kernel_table(prof, calls)

    if args.path == 'train':
        timed_ms(step, 1)                                  # step 4 (Greg)
        wall = timed_ms(step, 3)                           # steps 5-7
        timed_ms(step, 1)                                  # step 8 (Greg)
        g_ids = {id(o) for o in box['state'].opt_local_g}
        phases = _phase_split(step, g_ids, 3)              # steps 9-11
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
    if phases:
        print('  per phase, summed over the 9 layers (synchronised after '
              'each): ' + ', '.join(f'{k} {v:.1f} ms'
                                    for k, v in phases.items()))


def _phase_split(step, g_ids, steps: int):
    """Wall ms per phase kind (loss, backward and Adam, summed over the 9
    layers) and of the rest of the step (EMA, ADA), with a synchronisation
    after each phase; the median over ``steps`` Gmain + Dmain steps."""
    from ..training import train_step as ts
    orig = ts._apply_grads
    per_step = []
    mark = [0.0]

    def timed(opt, params, loss):
        orig(opt, params, loss)
        torch.cuda.synchronize()
        now = time.perf_counter()
        kind = 'Gmain' if id(opt) in g_ids else 'Dmain'
        per_step[-1][kind] += (now - mark[0]) * 1e3
        mark[0] = now

    ts._apply_grads = timed
    try:
        for _ in range(steps):
            per_step.append(collections.Counter())
            torch.cuda.synchronize()
            mark[0] = time.perf_counter()
            step()
            torch.cuda.synchronize()
            per_step[-1]['EMA and ADA'] += (time.perf_counter() - mark[0]) * 1e3
    finally:
        ts._apply_grads = orig
    return {k: statistics.median(s[k] for s in per_step) for k in per_step[0]}


if __name__ == '__main__':
    main()
