"""One run of one cell: set-up, the measured window, the traced steps, and
the check of ``correct`` against the plain reference.

The port is driven as its training loop drives it: the trainer's
``train_step`` fed by the loop's prefetcher and ``to_device``.  Set-up
writes the cell's synthetic data, draws the weights from the seed on the
card (``weights.py``), builds the trainer around them and runs the
traffic's warm-up steps, which are also the steps the reference follows:
their losses, the first step's gradients as the optimizers hold them, and
each parameter's change (live and EMA) after the first step and after the
warm-up are kept.  The window then sets the
step counter to the traffic's ``window_start`` and runs steps until
``--seconds`` have passed: the last step counted is the last that began
inside them, and the window closes when the card has finished it.  A
traffic whose steps are few and unequal opens its window where the
deadline falls inside its longest step, so that no run's count of steps
hangs on a small change in speed.  A traced run (``--trace 1``) runs the same window,
then the traffic's ``profile_steps`` under ``torch.profiler``.  Once the
peak memory is read and the port's state is freed, the reference follows
the warm-up steps that the compared numbers read (the first alone where
they read only it) on the same weights, rows and draws, and ``check.py``
compares.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, data, flops, launch_bytes, spec, trace
from .draws import draws_for
from .weights import seeded_state

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'montage_gan_tpu')
WINDOW_SPAN = 'bench.window'


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(t_start: float, message: str) -> None:
    """A progress line on standard error, seconds since the process began."""
    print(f'[bench {time.perf_counter() - t_start:8.2f} s] {message}',
          file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Readings:
    """What a run measured, for the metric readers (``metrics/*.py``)."""
    cell: spec.Cell
    batch: int
    window_steps: List[int]          # the step counters the window ran
    window_s: float
    data_wait_s: List[float]         # per window step, the host's wait
    step_flops: Callable[[int], float]
    trace: Optional[trace.Trace] = None
    kernel_bytes: Dict[str, Optional[int]] = dataclasses.field(
        default_factory=dict)


def load_reader(name: str, root=spec.ROOT):
    """``benchmark/metrics/<name>.py``'s ``read(readings)``."""
    path = root / 'benchmark' / 'metrics' / f'{name}.py'
    mod_spec = importlib.util.spec_from_file_location(
        f'benchmark_metric_{name}', path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------


def _kernels():
    """(family, ``CudaKernel``) of the port's hand-written kernels."""
    from montage_gan_tpu_torch.ops import (affine_warp, bias_act, composite,
                                           upfirdn2d)
    return ((trace.HANDWRITTEN[0], bias_act.grad_kernel),
            (trace.HANDWRITTEN[1], bias_act.kernel),
            (trace.HANDWRITTEN[2], upfirdn2d.kernel),
            (trace.HANDWRITTEN[3], affine_warp.forward_kernel),
            (trace.HANDWRITTEN[4], affine_warp.transpose_kernel),
            (trace.HANDWRITTEN[5], composite.kernel))


class PortRun:
    """The port's trainer, state and prefetcher for one cell."""

    def __init__(self, cell: spec.Cell, seed: int, dev: torch.device,
                 data_dir: str, ref_ens):
        from montage_gan_tpu_torch.models.ensemble import MontageEnsemble
        from montage_gan_tpu_torch.training.draws import Draws
        from montage_gan_tpu_torch.training.loop_aio import (
            U8_TO_MINUS11, BatchPrefetcher, ImageBatchPrefetcher)
        from montage_gan_tpu_torch.training.train_step import MontageTrainer
        self.cell, self.seed, self.dev = cell, seed, dev
        cfg, hyper = spec.build_port(cell.config, cell.traffic)
        self.hyper = hyper
        self.kind = cell.traffic['kind']
        with torch.device('meta'):
            ens = MontageEnsemble(cfg, with_d=True)
        ens = ens.to_empty(device=dev)
        self.trainer = MontageTrainer(ens, hyper, device=dev)
        with torch.device(dev):
            self.state = self.trainer.state_from_variables(
                ref_ens.state_dict())
        self.Draws = draws_for(Draws)
        self.lut = U8_TO_MINUS11.to(dev)
        pin = dev.type == 'cuda'
        samples = int(cell.traffic['samples'])
        if self.kind == 'layers':
            from montage_gan_tpu_torch.data.dataset import DatasetAIO
            dataset = DatasetAIO(
                data_dir, conv_config_index=cfg.conv_config_index,
                stat=data.layer_stat(cell.config['model'], samples),
                use_stat_cache=False)
            self.prefetcher = BatchPrefetcher(
                dataset, hyper.batch_size, cfg.layer_targets,
                seed=seed % 2**32, pin_memory=pin)
        else:
            from montage_gan_tpu_torch.data.dataset import ImageFolderDataset
            dataset = ImageFolderDataset(data_dir)
            self.prefetcher = ImageBatchPrefetcher(
                dataset, hyper.batch_size, seed=seed % 2**32,
                pin_memory=pin)

    def feed(self):
        """The next batch on the card, as the loop feeds it."""
        if self.kind == 'layers':
            from montage_gan_tpu_torch.training.loop_aio import to_device
            return to_device(self.prefetcher.next(), self.lut)
        images, _, _ = self.prefetcher.next()
        real = self.lut[images.to(self.dev, non_blocking=True).int()]
        return None, [real]

    def step(self, counter: int, batch) -> Dict[str, torch.Tensor]:
        """The step numbered ``counter`` on ``batch`` (the window's call)."""
        stack, crops = batch
        self.state.step = counter
        _, stats = self.trainer.train_step(
            self.state, stack, crops, self.Draws(self.seed, counter, self.dev))
        return stats

    def close(self) -> None:
        self.prefetcher.stop()
        self.trainer = self.state = None


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def warmup_and_record(run, steps: List[int], initial: Dict[str, torch.Tensor],
                      feed: Callable, step_fn: Callable) -> Dict[str, Any]:
    """Run the warm-up steps through ``step_fn`` and keep what the check
    compares: each step's losses, the first step's gradients as each phase
    hands them to its optimizer (``run.trainer.phase_hook``), the second
    moments the optimizers hold after it, and each parameter's change, live
    and EMA, after the first step and after the last."""
    losses, phases, moments, changes0 = [], {}, None, None
    for k, counter in enumerate(steps):
        if k == 0:
            run.trainer.phase_hook = check.PhaseGrads(phases)
        try:
            stats = step_fn(counter, feed())
        finally:
            run.trainer.phase_hook = None
        losses.append(check.losses_of(stats))
        if k == 0:
            moments = check.optimizer_grad_norms(run.state)
            changes0 = check.change_norms(run.state, initial)
    return {'losses': losses, 'phases': phases, 'moments': moments,
            'changes0': changes0,
            'changes': (changes0 if len(steps) == 1 else
                        check.change_norms(run.state, initial))}


def measure_window(port: PortRun, seconds: float, start: int):
    """The window: steps from counter ``start`` while ``seconds`` last."""
    counters, waits, starts = [], [], []
    sync(port.dev)
    t0 = time.perf_counter()
    counter = start
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        starts.append(t - t0)
        batch = port.feed()
        waits.append(time.perf_counter() - t)
        port.step(counter, batch)
        counters.append(counter)
        counter += 1
    sync(port.dev)
    window_s = time.perf_counter() - t0
    print('[bench] window step starts (s): '
          + ' '.join(f'{s:.2f}' for s in starts), file=sys.stderr)
    return counters, waits, window_s


def profile_steps(port: PortRun, counters: List[int]):
    """The traffic's profiled steps under ``torch.profiler``: (``Trace``,
    bytes of the hand-written kernels by family, worked out by
    ``launch_bytes`` from each launch's arguments)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    kernels = _kernels()
    for _, k in kernels:
        k.reset()
    sync(port.dev)
    with launch_bytes.Recorder(kernels) as recorder, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            for counter in counters:
                with record_function('bench.data_wait'):
                    batch = port.feed()
                with record_function('bench.train_step'):
                    port.step(counter, batch)
            sync(port.dev)
    nbytes = recorder.bytes()
    # the port's own counters, as a cross-check only
    print('[bench] hand-written kernels\' bytes (benchmark, port counters): '
          + '; '.join(f'{fam} {nbytes[fam]} {k.bytes}' for fam, k in kernels),
          file=sys.stderr)
    return trace.read_profile(prof, WINDOW_SPAN, len(counters)), nbytes


def reference_record(cell: spec.Cell, seed: int, dev: torch.device,
                     data_dir: str, control: bool = False,
                     rows: Optional[int] = None,
                     steps: Optional[int] = None,
                     tf32: Optional[bool] = None) -> Dict[str, Any]:
    """The plain reference through the first ``steps`` warm-up steps (all
    of them by default), on the seed's
    weights, the rows its own copy of the sampler picks from the files and
    the keyed draws.  ``control`` computes it a step below the
    configuration's precision (the control): float32 in TF32, the bfloat16
    blocks' convolutions through float8; ``tf32`` alone sets the first of
    the two.  ``rows`` keeps only the first rows of each batch (a planted
    fault)."""
    from .reference.draws import Draws
    from .reference.precision import fp8_blocks
    from .reference.train_step import MontageTrainer
    tf32 = control if tf32 is None else tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    cfg, hyper = spec.build_reference(cell.config, cell.traffic)
    ens = seeded_state(cfg, seed, dev)
    initial = {k: v.detach().clone() for k, v in ens.named_parameters()}
    trainer = MontageTrainer(ens, hyper, device=dev)
    with torch.device(dev):
        state = trainer.state_from_variables(ens.state_dict())
    KeyedDraws = draws_for(Draws)
    steps = list(cell.traffic['warmup_steps'])[:steps]
    batches = iter(reference_batches(cell, seed, data_dir, len(steps)))

    class Run:
        pass
    run = Run()
    run.state, run.trainer = state, trainer

    def to(x):
        return None if x is None else torch.from_numpy(x[:rows]).to(dev)

    def feed():
        stack, crops = next(batches)
        return to(stack), [to(c) for c in crops]

    def step_fn(counter, batch):
        state.step = counter
        _, stats = trainer.train_step(state, batch[0], batch[1],
                                      KeyedDraws(seed, counter, dev))
        return stats
    try:
        with fp8_blocks(control):
            return warmup_and_record(run, steps, initial, feed, step_fn)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def reference_batches(cell: spec.Cell, seed: int, data_dir: str, count: int):
    """The first ``count`` batches as float32 arrays in [-1, 1]:
    ``(stack [B, L, H, W, 4], crops per layer)`` of a ``layers`` mix,
    ``(None, [images [B, H, W, 3]])`` of an ``images`` mix."""
    from .reference.image_utils import crop_to_content_np, pad_center_np
    traffic, model = cell.traffic, cell.config['model']
    kind, batch = traffic['kind'], int(traffic['batch'])
    samples = int(traffic['samples'])
    if kind == 'layers':
        items = sorted(os.path.join(data_dir, d) for d in os.listdir(data_dir))
    else:
        items = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
                       if f.endswith('.png'))
    order = data.sample_order(samples, seed % 2**32, batch * count)

    def minus11(u8):
        return (u8.astype(np.float32) / np.float32(255.0) * np.float32(2.0)
                - np.float32(1.0))
    for k in range(count):
        rows = [data.read_item(items[i], kind)
                for i in order[k * batch:(k + 1) * batch]]
        if kind == 'images':
            yield None, [minus11(np.stack(rows))]
            continue
        stack = np.stack(rows)
        size = stack.shape[2]
        crops = []
        for layer, (bh, bw) in enumerate(model['layer_targets']):
            out = np.empty((batch, bh, bw, 4), np.uint8)
            for b in range(batch):
                centred = pad_center_np(crop_to_content_np(stack[b, layer]),
                                        size)
                y0, x0 = (size - bh) // 2, (size - bw) // 2
                out[b] = centred[y0:y0 + bh, x0:x0 + bw]
            crops.append(minus11(out))
        yield minus11(stack), crops


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             dev: torch.device, t_start: float,
             limits: Optional[Dict[str, float]] = None,
             port_hook: Optional[Callable[[PortRun], None]] = None
             ) -> Dict[str, Any]:
    """One run; returns the result line's object (``correct`` and the
    compared numbers included).  ``port_hook`` sees the port's run after
    set-up is built, before the warm-up (the fault tests break it there)."""
    traffic = cell.traffic
    data_dir = tempfile.mkdtemp(prefix='bench-data-')
    try:
        data.write_dataset(data_dir, traffic['kind'], int(traffic['samples']),
                           seed, len(cell.config['model']['layer_names']))
        log(t_start, 'data written')
        ref_cfg, _ = spec.build_reference(cell.config, traffic)
        ref_ens = seeded_state(ref_cfg, seed, dev)
        log(t_start, 'weights drawn')
        port = PortRun(cell, seed, dev, data_dir, ref_ens)
        log(t_start, 'trainer built')
        # on the host, so that the port's peak memory holds none of it
        initial = {k: v.detach().cpu() for k, v in ref_ens.named_parameters()}
        del ref_ens
        if port_hook is not None:
            port_hook(port)
        record = warmup_and_record(port, list(traffic['warmup_steps']),
                                   initial, port.feed, port.step)
        del initial
        sync(dev)
        setup_s = time.perf_counter() - t_start
        log(t_start, f'warm-up done: set-up {setup_s:.3f} s')
        counters, waits, window_s = measure_window(
            port, seconds, int(traffic['window_start']))
        readings = Readings(
            cell=cell, batch=port.hyper.batch_size, window_steps=counters,
            window_s=window_s, data_wait_s=waits,
            step_flops=lambda c, cfg=ref_cfg, h=port.hyper:
            flops.step_flops(cfg, h, c))
        log(t_start, f'window: {len(counters)} steps in {window_s:.3f} s')
        if traced:
            readings.trace, readings.kernel_bytes = profile_steps(
                port, list(traffic['profile_steps']))
            log(t_start, f'profiled {readings.trace.steps} steps, '
                f'{len(readings.trace.device)} device operations')
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda'
                else 0)
        port.close()
        del port
        gc.collect()
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
        log(t_start, f'peak {peak} bytes; port freed')
        limits = limits or check.limits(cell)
        reference = reference_record(
            cell, seed, dev, data_dir,
            steps=check.steps_needed(limits, len(traffic['warmup_steps'])))
        log(t_start, 'reference done')
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    compared = check.compare(record, reference, limits)
    images = readings.batch * len(counters)
    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m['name'])(readings)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        values = {'train_images_per_s': images / window_s,
                  'peak_mem_gib': peak / 2**30, 'setup_s': setup_s}
        metrics = {m['name']: {'value': values[m['name']], 'unit': m['unit']}
                   for m in cell.end_to_end}
    device = {'platform': 'gpu' if dev.type == 'cuda' else dev.type,
              'kind': (torch.cuda.get_device_name(dev) if dev.type == 'cuda'
                       else 'cpu'),
              'count': cell.chips, 'memory_peak_bytes': int(peak)}
    out = {'correct': all(c['value'] <= c['limit'] for c in compared.values()),
           'attempted': len(counters), 'failed': 0, 'metrics': metrics,
           'device': device}
    if traced:
        device['busy_s'] = readings.trace.busy_s()
        device['window_s'] = readings.trace.window_s
        out['breakdown'] = trace.breakdown(readings.trace)
    out['compared'] = compared
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        visible = (torch.cuda.device_count() if torch.cuda.is_available()
                   else 0)
        print(f'{cell.name} needs {cell.chips} CUDA device(s); {visible} '
              'visible', file=sys.stderr)
        return 2
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    torch.set_num_threads(4)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                   t_start)
    found = forbidden_modules()
    if found:
        print('loaded in the measuring process: ' + ', '.join(found),
              file=sys.stderr)
        return 3
    for name, c in out['compared'].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0
