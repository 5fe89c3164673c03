"""Data-parallel training on every visible card, held to one process.

    python -m montage_gan_tpu_torch.tools.ddp_check [--ranks N] [--no-loop]
        [--metrics-only]

Full-width config ``aio`` (``MontageConfig()``), ``TrainHyper()`` defaults
with augment ``bgcfnc`` at p 0.6, seeded random weights, synthetic reals,
``PER_RANK`` images a rank: the global batch is ``PER_RANK · N``.  One
process per card through an NCCL process group (on one card: one rank, so
every collective still runs).

1. The step (``check_rank``, which ``chip_smoke.py`` calls on its one
   card), at config ``aio``'s widths and depths in float32
   (``num_fp16_res=0``: the bf16 blocks round differently at another batch
   size), the global batch in 2 accumulation rounds, learning rates 0 (so
   that every phase of the step reads the step's initial weights in every
   run: Adam's first update is ``lr · sign(g)``, and where g is tiny its
   sign is set by the order of a sum).  Rank 0 first takes step 0 at the
   global batch in one process (no process group), then again with every
   weight moved by ``NUDGE`` relative: the step's own conditioning at
   these random weights.  Then every rank takes ``STEPS`` steps of the
   data-parallel step on its rows of the same batch, with the same draws
   (step 0 runs every phase and regularizer).  Each phase's reduced
   gradients at step 0 are held to the one-process phase's on the
   phase's scale, its largest entry within the larger of ``TOL_GRAD`` and
   ``FACTOR`` times the moved step's spread; each loss and score likewise
   (``TOL_LOSS``); each rank's launches of K1'-K4' over the steps are
   exactly ``tools/launches.py::expected_train_launches``; the ranks'
   train states are identical (``assert_replicated``).  Then config
   ``aio`` as it trains (bf16 blocks, one round, ``TrainHyper()`` learning
   rates): a step without regularizer timed, with each card's peak
   memory, and one under ``torch.profiler``: the NCCL kernels' time and
   the kernel time.
2. The loop (not ``--no-loop``): ``cli/train_aio.py --gpus N`` (on one
   card ``--coordinator`` with ``WORLD_SIZE=1``, so the loop still runs as
   a rank of a process group) at the global batch for ``LOOP_STEPS``
   steps in 2-step ticks on a synthetic dataset of ``LOOP_SAMPLES`` 256-px samples in a temporary directory
   (deleted): training images/s of steps 2 on, the data wait, each card's
   peak memory (the ranks' mean and spread), the snapshots' bytes and
   seconds and the replica check's seconds, from the run's ``stats.jsonl``
   and ``log.txt``.

3. The metrics (``metrics_check``; alone with ``--metrics-only``):
   ``cli/calc_metrics.py --gpus N`` against ``--gpus 1`` on an EMA snapshot
   of config ``aio`` (seeded random weights, ``seeded_model``) and the
   synthetic dataset, with seeded random InceptionV3 and VGG16-LPIPS
   ``.npz`` files in a drop-in directory (``write_random_detectors``), so
   the real architectures run: fid2k and ppl2_wend at ``METRIC_PPL``
   samples.  Each rank's features and distances are the one process's
   batches, so the results are held within ``TOL_METRIC`` relative (the
   same float64 sums in the same order; only sqrtm's and the percentile
   filter's inputs could differ, and they should not); the seconds of
   each run.

Prints one line per rank, a JSON summary ``{"ddp": ...}`` and the card's
name and power limit; exits non-zero if any check fails.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

PER_RANK = 8
STEPS = 2
SEED = 0
LOOP_STEPS = 6
LOOP_SAMPLES = 64
METRIC_PPL = 512
# R ranks against one process: each batch's features are computed by the
# same code at the same shapes on a card of the same kind, and accumulated
# in batch order, so they should be equal; a batch missing, doubled or out
# of order moves a FID of 2000 samples by far more.
TOL_METRIC = 1e-9
# Data-parallel step against one process on the card, float32: the same
# operations at another batch size per convolution, in another order (cuDNN
# may pick other algorithms), move each sample's activations by a few 1e-6
# relative.  At random weights the step is ill-conditioned: one process
# whose weights move by 1e-6 relative moves the renderer phase by about
# its largest gradient entry (the alpha composite of generated alphas far
# outside [0, 1]) and the local Dmain phases by a few 1e-2 (on an H100;
# this tool prints it as the moved step's spread).  So the limit of each
# phase (and loss) is the larger of a fixed tolerance (the JAX package's
# stats tolerance for the losses, chip_smoke.py's 1e-3 of a phase's
# largest entry for the gradients) and FACTOR times the spread of one
# process whose weights move by NUDGE; a missing or doubled reduction moves
# a phase by 1 or more of its largest entry.  tests/test_torch_ddp.py holds
# the float32 CPU step within 2e-5.
TOL_LOSS = dict(rtol=2e-3, atol=2e-4)
TOL_GRAD = 1e-3
NUDGE = 1e-6
FACTOR = 10
# the stats compared: losses, penalties and mean scores (not the mean
# signs, which a logit near 0 flips by 1 / batch)
LOSS_KEYS = ('Loss/', 'Renderer/loss')
# what the loop prints (training/loop_aio.py)
SNAPSHOT_LINE = re.compile(r'^(Saved|Restored) (.+): (\d+) bytes in '
                           r'([0-9.]+) s$', re.M)
REPLICA_LINE = re.compile(r'^Checked (\d+) tensors replicated over (\d+) '
                          r'ranks in ([0-9.]+) s$', re.M)


def _say(msg=''):
    print(msg, flush=True)


def spread(grads, ref_grads):
    """(largest entry difference, worst tensor) over a phase's gradients,
    relative to the phase's largest entry."""
    pairs = [(i, torch.zeros_like(r) if g is None else g,
              torch.zeros_like(g) if r is None else r)
             for i, (g, r) in enumerate(zip(grads, ref_grads))
             if g is not None or r is not None]
    scale = max(max(r.abs().max().item() for _, _, r in pairs), 1e-12)
    return max(((g - r).abs().max().item() / scale, i) for i, g, r in pairs)


def _inputs(cfg, batch):
    from ..data.synthetic import synthetic_batch
    from ..utils.image_utils import make_batch_for_local_d_np
    stack01 = synthetic_batch(np.random.RandomState(SEED), batch,
                              cfg.num_layers, cfg.base_resolution)
    crops = make_batch_for_local_d_np(stack01, cfg.layer_targets,
                                      to_minus11=True)
    return stack01 * 2.0 - 1.0, crops


def rank_rows(x, rank, world, rounds):
    """Rank ``rank``'s rows of a global batch laid out round-major
    (``parallel/mesh.py``)."""
    x = np.asarray(x)
    per = x.shape[0] // (rounds * world)
    return x.reshape(rounds, world, per, *x.shape[1:])[:, rank].reshape(
        -1, *x.shape[1:])


def _losses(stats):
    return {k: float(v) for k, v in stats.items()
            if any(s in k for s in LOSS_KEYS) and '/signs/' not in k}


def check_rank(dp) -> dict:
    """This rank's part of section 1 (the process group up, ``dp`` its
    ``parallel.mesh.DataParallel``); raises where a check fails, on rank 0
    after every rank's last collective.  Returns this rank's figures."""
    from ..models.ensemble import MontageConfig, MontageEnsemble
    from ..ops import affine_warp, bias_act, upfirdn2d
    from ..parallel import mesh
    from ..training.augment import make_augment_config
    from ..training.train_step import MontageTrainer, TrainHyper
    from ..utils.checkpoint import train_state_tensors
    from .launches import expected_train_launches
    from .profile import kernel_table

    dev = dp.device
    batch = PER_RANK * dp.world
    cfg = MontageConfig(num_fp16_res=0)
    hyper = TrainHyper(batch_size=batch, microbatch=batch // 2,
                       augment=make_augment_config('bgcfnc'),
                       augment_p_init=0.6, lrate=0.0, renderer_lr=0.0)
    stack, crops = _inputs(cfg, batch)
    out = {'rank': dp.rank, 'world': dp.world, 'batch': batch}
    failed = []

    def on_card(stack, crops):
        return (torch.from_numpy(stack).float().to(dev),
                [torch.from_numpy(c).to(dev) for c in crops])

    def sync():
        torch.cuda.synchronize(dev)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    ref_grads, ref_losses, floor = {}, None, {}

    def one_process(hook, nudge=0.0):
        """Step 0 at the global batch in this process, no process group,
        every weight moved by ``nudge`` relative: its losses; ``hook`` sees
        each phase's gradients."""
        trainer = MontageTrainer(MontageEnsemble(cfg, with_d=True), hyper,
                                 device=dev)
        state = trainer.init_state(SEED)
        with torch.no_grad():
            for i, p in enumerate(trainer.ens.parameters() if nudge else ()):
                p.mul_(1 + nudge * torch.randn(
                    p.shape, generator=torch.Generator().manual_seed(i))
                    .to(dev))
        trainer.phase_hook = hook
        _, stats = trainer.train_step(
            state, *on_card(stack, crops),
            torch.Generator(device=dev).manual_seed(SEED))
        losses = _losses(stats)
        del trainer, state, stats
        free()
        return losses

    if dp.rank == 0:
        t0 = time.perf_counter()
        ref_losses = one_process(lambda name, g: ref_grads.__setitem__(
            name, [None if t is None else t.to('cpu') for t in g]))
        out['one_process_s'] = time.perf_counter() - t0
        moved = one_process(lambda name, g: floor.__setitem__(name, spread(
            g, [None if r is None else r.to(dev) for r in ref_grads[name]])
            [0]), NUDGE)
        floor_loss = {k: abs(moved[k] - ref_losses[k]) for k in ref_losses}
    mesh.barrier(dp)

    trainer = MontageTrainer(MontageEnsemble(cfg, with_d=True), hyper,
                             device=dev, data_parallel=dp)
    state = trainer.init_state(SEED)
    mesh.replicate((t for _, t in train_state_tensors(state)), dp)
    rounds = hyper.accum_rounds
    mine = on_card(rank_rows(stack, dp.rank, dp.world, rounds),
                   [rank_rows(c, dp.rank, dp.world, rounds) for c in crops])
    errs = {}

    def compare(name, grads):
        if dp.rank == 0:
            ref = [None if r is None else r.to(dev) for r in ref_grads[name]]
            errs[name] = spread(grads, ref)
    trainer.phase_hook = compare
    kernels = {'bias_act': bias_act.kernel,
               'bias_act_grad': bias_act.grad_kernel,
               'upfirdn2d': upfirdn2d.kernel,
               'warp_forward': affine_warp.forward_kernel,
               'warp_transpose': affine_warp.transpose_kernel}
    gen = torch.Generator(device=dev)
    sync()
    for k in kernels.values():
        k.reset()
    for step in range(STEPS):
        gen.manual_seed(SEED + step)
        state, stats = trainer.train_step(state, *mine, gen)
        bad = [k for k, v in stats.items() if not torch.isfinite(v).all()]
        if bad:
            failed.append(f'step {step}: non-finite stats {bad}')
        if step == 0:
            trainer.phase_hook = None
            got_losses = _losses(stats)
    sync()
    launches = {name: k.launches for name, k in kernels.items()}
    expect = expected_train_launches(trainer.ens, hyper, STEPS)
    out.update(launches=launches, expected=expect)
    if launches != expect or 0 in launches.values():
        failed.append(f'launches {launches}, expected {expect}')
    out['replicated'] = mesh.assert_replicated(train_state_tensors(state),
                                               dp)
    if dp.rank == 0:
        if set(errs) != set(ref_grads) or set(got_losses) != set(ref_losses):
            failed.append(f'phases {sorted(errs)} and losses '
                          f'{sorted(got_losses)}, one process\'s '
                          f'{sorted(ref_grads)} and {sorted(ref_losses)}')
        grad_err = {k: v[0] for k, v in errs.items()}
        loss_err = {k: abs(got_losses[k] - ref_losses[k])
                    for k in ref_losses if k in got_losses}
        grad_limit = {k: max(TOL_GRAD, FACTOR * floor[k]) for k in floor}
        loss_limit = {k: max(TOL_LOSS['atol'] + TOL_LOSS['rtol']
                             * abs(ref_losses[k]), FACTOR * floor_loss[k])
                      for k in ref_losses}
        worst = max(grad_err, key=lambda k: grad_err[k] / grad_limit[k])
        worst_loss = max(loss_err, key=lambda k: loss_err[k] / loss_limit[k])
        out.update(phases=len(errs), losses=len(loss_err),
                   worst_phase=worst, worst_grad=grad_err[worst],
                   worst_grad_limit=grad_limit[worst],
                   worst_loss=worst_loss, worst_loss_err=loss_err[worst_loss],
                   worst_loss_limit=loss_limit[worst_loss],
                   grad_err=grad_err, floor_by_phase=floor,
                   floor_grad=max(floor.values()))
        bad = {k: (v, grad_limit[k]) for k, v in grad_err.items()
               if v > grad_limit[k]}
        if bad:
            failed.append(f'gradients beyond their limits (phase: error, '
                          f'limit): {bad}; by phase: {grad_err}; one process '
                          f'moved by {NUDGE}: {floor}')
        bad = {k: (got_losses[k], ref_losses[k], loss_limit[k])
               for k, e in loss_err.items() if e > loss_limit[k]}
        if bad:
            failed.append(f'losses beyond their limits: {bad}')
    del trainer, state, stats
    free()

    # config aio as it trains (bf16 blocks, the whole batch in one round):
    # step 1 (no regularizer) warms up, step 2 is timed, step 3 profiled
    cfg = MontageConfig()
    hyper = TrainHyper(batch_size=batch,
                       augment=make_augment_config('bgcfnc'),
                       augment_p_init=0.6)
    stack, crops = _inputs(cfg, batch)
    mine = on_card(rank_rows(stack, dp.rank, dp.world, 1),
                   [rank_rows(c, dp.rank, dp.world, 1) for c in crops])
    trainer = MontageTrainer(MontageEnsemble(cfg, with_d=True), hyper,
                             device=dev, data_parallel=dp)
    state = trainer.init_state(SEED)
    mesh.replicate((t for _, t in train_state_tensors(state)), dp)
    state.step = 1
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.train_step(state, *mine, gen)
    sync()
    t0 = time.perf_counter()
    trainer.train_step(state, *mine, gen)
    sync()
    out.update(step_s=time.perf_counter() - t0,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer.train_step(state, *mine, gen)
        sync()
    fam_ms, fam_n, _ = kernel_table(prof, 1)
    out.update(nccl_ms=fam_ms.get('collectives (NCCL)', 0.0),
               nccl_launches=fam_n.get('collectives (NCCL)', 0),
               kernel_ms=sum(fam_ms.values()))
    _say(f'  rank {dp.rank}/{dp.world}: ' + json.dumps(
        {k: v for k, v in out.items() if k not in ('grad_err', 'expected')}))
    mesh.barrier(dp)
    if failed:
        raise AssertionError(f'rank {dp.rank}: ' + '; '.join(failed))
    return out


def _rank_main(local_rank, world, port, outdir):
    from .. import set_fp32_precision
    from ..parallel import distributed, mesh
    distributed.maybe_initialize(f'localhost:{port}', world, local_rank,
                                 local_rank, device='cuda')
    set_fp32_precision()
    out = check_rank(mesh.DataParallel.from_process_group('cuda'))
    with open(os.path.join(outdir, f'rank{local_rank}.json'), 'w') as f:
        json.dump(out, f)
    # only after success: leaving the group waits for the other ranks, so a
    # rank that raised leaves without it and the launcher ends the others
    distributed.shutdown()


def run_ranks(world: int) -> list:
    """Section 1 on ``world`` cards: one spawned process each."""
    from ..ops import cuda
    from ..parallel import distributed
    cuda.build()                          # once, before the ranks start
    outdir = tempfile.mkdtemp(prefix='mgt-ddp-')
    try:
        distributed.launch(_rank_main, world, args=(
            world, distributed.free_port(), outdir), device='cuda')
        results = []
        for r in range(world):
            with open(os.path.join(outdir, f'rank{r}.json')) as f:
                results.append(json.load(f))
        return results
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


def metrics_check(world: int, card: str, log=_say) -> dict:
    """Section 3: ``calc_metrics --gpus world`` against ``--gpus 1``."""
    from ..cli import calc_metrics
    from ..data.synthetic import make_synthetic_layer_dataset
    from ..models.ensemble import MontageConfig
    from ..utils.checkpoint import save_checkpoint
    from .seeded import seeded_model, use_detectors, write_random_detectors
    tmp = tempfile.mkdtemp(prefix='mgt-ddp-metrics-')
    try:
        data = make_synthetic_layer_dataset(os.path.join(tmp, 'layers'),
                                            num_samples=LOOP_SAMPLES)
        use_detectors(os.path.join(tmp, 'weights'))
        write_random_detectors(os.environ['MGT_WEIGHTS_DIR'], SEED)
        cfg = MontageConfig()
        model = seeded_model(cfg, SEED)
        out, records = {}, {}
        for n, name in ((1, 'one'), (world, 'ranks')):
            d = os.path.join(tmp, name)
            os.makedirs(d)
            snap = os.path.join(d, 'ema-snapshot-000000.pt')
            save_checkpoint(snap, cfg, model)
            t0 = time.perf_counter()
            calc_metrics.main(['--network', snap, '--data', data,
                               '--metrics', 'fid2k,ppl2_wend',
                               '--ppl-samples', str(METRIC_PPL), '--gpus',
                               str(n), '--cache-dir',
                               os.path.join(d, 'cache')])
            out[f'{name}_s'] = time.perf_counter() - t0
            records[name] = {}
            for metric in ('fid2k', 'ppl2_wend'):
                with open(os.path.join(d, f'metric-{metric}.jsonl')) as f:
                    rec = json.loads(f.readline())
                if rec['num_gpus'] != n:
                    raise AssertionError(f'{metric}: {rec["num_gpus"]} '
                                         f'ranks recorded, {n} started')
                records[name].update(rec['results'])
        for k, want in records['one'].items():
            got = records['ranks'][k]
            rel = abs(got - want) / max(abs(want), 1e-30)
            out[k] = dict(one=want, ranks=got, rel=rel)
            if not (np.isfinite(want) and rel <= TOL_METRIC):
                raise AssertionError(f'{k}: {got} on {world} ranks, {want} '
                                     f'in one process (limit {TOL_METRIC})')
        log(f'[ddp metrics] calc_metrics fid2k,ppl2_wend (ppl {METRIC_PPL} '
            f'samples), config aio, random-weight InceptionV3 and '
            f'VGG16-LPIPS: --gpus {world} '
            + ', '.join(f'{k} {v["ranks"]!r}' for k, v in out.items()
                        if isinstance(v, dict))
            + f'; --gpus 1 ' + ', '.join(
                f'{k} {v["one"]!r} (rel {v["rel"]:.3g})'
                for k, v in out.items() if isinstance(v, dict))
            + f'; {out["ranks_s"]:.1f} s on {world} rank(s) against '
            f'{out["one_s"]:.1f} s  card: {card}')
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def loop_check(world: int, card: str, log=_say) -> dict:
    """Section 2: ``train_aio --gpus world`` at ``PER_RANK · world``."""
    from ..cli import train_aio
    from ..data.synthetic import make_synthetic_layer_dataset
    batch = PER_RANK * world
    tmp = tempfile.mkdtemp(prefix='mgt-ddp-loop-')
    try:
        data = make_synthetic_layer_dataset(os.path.join(tmp, 'layers'),
                                            num_samples=LOOP_SAMPLES)
        outdir = os.path.join(tmp, 'runs')
        ranks = ['--gpus', str(world)]
        if world == 1:
            os.environ.update(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0')
            from ..parallel.distributed import free_port
            ranks = ['--coordinator', f'localhost:{free_port()}']
        argv = ['--outdir', outdir, '--data', data, *ranks, '--cfg', 'aio', '--batch', str(batch), '--aug', 'ada',
                '--augpipe', 'bgcfnc', '--kimg', str(LOOP_STEPS * batch / 1e3),
                '--kimg-per-tick', str(2 * batch / 1e3), '--snap', '1000',
                '--net-snap', '1000']
        t0 = time.perf_counter()
        train_aio.main(argv)
        wall = time.perf_counter() - t0
        run_dir = os.path.join(outdir, os.listdir(outdir)[0])
        with open(os.path.join(run_dir, 'stats.jsonl')) as f:
            recs = [json.loads(line) for line in f]
        with open(os.path.join(run_dir, 'log.txt')) as f:
            text = f.read()
        steps = sum(r['Timing/data_fetch']['num'] for r in recs) / world
        if steps != LOOP_STEPS:
            raise AssertionError(f'the loop ran {steps} steps')
        secs = sum(r['Timing/sec_per_tick']['mean'] for r in recs[1:])
        fetch = (sum(r['Timing/data_fetch']['mean']
                     * r['Timing/data_fetch']['num'] for r in recs)
                 / sum(r['Timing/data_fetch']['num'] for r in recs))
        mem = recs[-1]['Resources/peak_gpu_mem_gb']
        for r in recs:
            for k, v in r.items():
                if isinstance(v, dict) and not np.isfinite(v['mean']):
                    raise AssertionError(f'stats: {k} {v}')
        out = dict(images_per_s=(LOOP_STEPS - 1) * batch / secs,
                   data_fetch_s=fetch, peak_gib_mean=mem['mean'],
                   peak_gib_std=mem['std'], command_s=wall,
                   snapshots=[(w, os.path.basename(p), int(n), float(s))
                              for w, p, n, s in SNAPSHOT_LINE.findall(text)],
                   replica_checks=[(int(n), int(w), float(s)) for n, w, s in
                                   REPLICA_LINE.findall(text)],
                   ticks=[r['Timing/data_fetch']['num'] // world
                          for r in recs])
        if not out['replica_checks'] or len(out['snapshots']) < 2:
            raise AssertionError(f'log: {out["snapshots"]} '
                                 f'{out["replica_checks"]}')
        log(f'[ddp loop] cli/train_aio --gpus {world} --batch {batch}: '
            f'{LOOP_STEPS} steps in ticks of {out["ticks"]} steps; steps '
            f'2-{LOOP_STEPS}: {out["images_per_s"]:.2f} images/s; data wait '
            f'{fetch * 1e3:.1f} ms a step; peak memory '
            f'{mem["mean"]:.2f} GiB a card (spread {mem["std"]:.3f}); '
            f'{wall:.1f} s of command  card: {card}')
        for w, p, n, s in out['snapshots']:
            log(f'  {w} {p}: {n} bytes in {s:.2f} s  card: {card}')
        for n, w, s in out['replica_checks']:
            log(f'  {n} tensors checked replicated over {w} ranks in '
                f'{s:.2f} s')
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--ranks', type=int, default=None,
                    help='cards to use (default: every visible card)')
    ap.add_argument('--no-loop', action='store_true',
                    help='without the loop (section 2)')
    ap.add_argument('--metrics-only', action='store_true',
                    help='only the metrics (section 3)')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('ddp_check: no CUDA device')
    from .timing import card_line
    card = card_line()
    world = args.ranks or torch.cuda.device_count()
    t0 = time.perf_counter()
    if args.metrics_only:
        from ..ops import cuda
        cuda.build()
        summary = {'world': world, 'card': card,
                   'metrics': metrics_check(world, card),
                   'seconds': time.perf_counter() - t0}
        print(json.dumps({'ddp': summary}))
        print(card)
        return
    _say(f'[ddp] {world} rank(s) of {torch.cuda.device_count()} cards, '
         f'{PER_RANK} images a rank, config aio  card: {card}')
    ranks = run_ranks(world)
    r0 = ranks[0]
    step = statistics.median(r['step_s'] for r in ranks)
    _say(f'  one process at batch {r0["batch"]}: {r0["phases"]} phases\' '
         'gradients within their limits (nearest: '
         f'{r0["worst_phase"]} {r0["worst_grad"]:.3g} of its largest entry, '
         f'limit {r0["worst_grad_limit"]:.3g}); {r0["losses"]} losses '
         f'within theirs (nearest: {r0["worst_loss"]} '
         f'{r0["worst_loss_err"]:.3g}, limit {r0["worst_loss_limit"]:.3g}); '
         f'replicas identical ({r0["replicated"]} tensors); launches exact '
         'on every rank')
    nccl = statistics.median(r['nccl_ms'] for r in ranks)
    kernel = statistics.median(r['kernel_ms'] for r in ranks)
    _say(f'  config aio, a step without regularizer: {step * 1e3:.1f} ms '
         f'({r0["batch"] / step:.2f} images/s); NCCL {nccl:.2f} ms of '
         f'{kernel:.1f} ms kernel time (profiled step); peak '
         f'{max(r["peak_gib"] for r in ranks):.2f} GiB  card: {card}')
    summary = {'world': world, 'batch': r0['batch'], 'card': card,
               'worst_grad': r0['worst_grad'],
               'worst_phase': r0['worst_phase'],
               'worst_grad_limit': r0['worst_grad_limit'],
               'worst_loss': r0['worst_loss'],
               'worst_loss_err': r0['worst_loss_err'],
               'worst_loss_limit': r0['worst_loss_limit'],
               'floor_grad': r0['floor_grad'],
               'grad_err': r0['grad_err'],
               'floor_by_phase': r0['floor_by_phase'],
               'step_ms': step * 1e3,
               'nccl_ms': [r['nccl_ms'] for r in ranks],
               'nccl_launches': [r['nccl_launches'] for r in ranks],
               'kernel_ms': [r['kernel_ms'] for r in ranks],
               'peak_gib': [r['peak_gib'] for r in ranks],
               'launches': [r['launches'] for r in ranks],
               'replicated': r0['replicated']}
    if not args.no_loop:
        summary['loop'] = loop_check(world, card)
    summary['metrics'] = metrics_check(world, card)
    summary['seconds'] = time.perf_counter() - t0
    print(json.dumps({'ddp': summary}))
    print(card)


if __name__ == '__main__':
    main()
