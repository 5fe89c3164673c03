"""Quality metrics of a snapshot.

Port of ``montage_gan_tpu/cli/calc_metrics.py`` (the reference's
calc_metrics.py:29-191), with ``argparse`` in place of click and a
``--device`` flag (default ``cuda``; without a card it raises):

    python -m montage_gan_tpu_torch.cli.calc_metrics --network SNAP \\
        --data DIR [--metrics fid2k,ppl2_wend] [--gpus N] [--device cuda]

``--network`` takes the port's EMA snapshot (``ema-snapshot-*.pt``, or any
``utils.checkpoint.save_checkpoint`` file) or a JAX EMA snapshot
(``.msgpack`` with its ``.json``), through ``utils/checkpoint.load_network``,
scored on a layer dataset (``DatasetAIO``); or a reference SG2-ADA ``.pkl``
(``utils/pkl_import.py::generator_from_pkl``: its ``G_ema``, the image in
[0, 1] with constant noise), scored on a flat dataset
(``ImageFolderDataset``), as the JAX CLI's lines 57-77 do.  A single-GAN
snapshot (``MontageConfig.single_gan``: ``train``'s EMA snapshots,
``convert-pickle``'s) is scored as the ``.pkl`` is, its single G on a flat
dataset; one of several layers without the global path raises.  Each
result is
printed and appended to ``metric-<name>.jsonl`` beside the snapshot.
``--gpus N`` starts N ranks on this host, one per card, through
``parallel/distributed.launch`` (the route of ``train_aio --gpus``): they
share each metric's batches and rank 0 writes.  The detectors are found as
``cli/check_weights.py`` reports (``MGT_WEIGHTS_DIR``); without them the
metrics are relative (``--extractor random``).
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import torch

from ..parallel import distributed
from .train_aio import _bool


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='python -m montage_gan_tpu_torch.cli.calc_metrics',
        description='Calculate quality metrics for a trained snapshot.')
    add = p.add_argument
    add('--network', dest='network_path', required=True, metavar='PATH')
    add('--metrics', default='fid2k', help='Comma-separated metric names')
    add('--data', required=True, metavar='DIR')
    add('--mirror', type=_bool, default=False)
    add('--extractor', choices=['auto', 'random', 'inception'],
        default='auto')
    add('--cache-dir', default=os.path.join(tempfile.gettempdir(),
                                            'mgt-metric-cache'))
    add('--batch', type=int, default=16)
    add('--seed', type=int, default=0)
    add('--ppl-samples', type=int, default=None,
        help='PPL sample budget (default: the reference 50k)')
    add('--gpus', dest='num_devices', type=int, default=1,
        help='Ranks to start on this host, one per card (on the CPU, '
             'processes), sharing each metric\'s batches')
    add('--device', default='cuda',
        help="torch device (default 'cuda')")
    return p


def calc(opts) -> list:
    """Every metric of ``opts`` on this process (a rank, where a process
    group is up); returns the result dicts."""
    from ..data.dataset import DatasetAIO
    from ..metrics import metric_main
    from ..metrics.features import build_extractor, metric_device
    from ..metrics.metric_utils import generator_fns, snapshot_fns
    from ..utils.checkpoint import load_network

    dev = metric_device(opts.device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    if opts.network_path.endswith('.pkl'):
        from ..utils.pkl_import import generator_from_pkl
        mapping, synthesis, kw = generator_from_pkl(opts.network_path)
        z_dim, montage = kw['z_dim'], False
        fns = generator_fns(mapping.to(dev), synthesis.to(dev))
    else:
        cfg, model = load_network(opts.network_path, device=dev)
        z_dim, montage = cfg.z_dim, not cfg.single_gan
        fns = snapshot_fns(model)
    if montage:
        dataset = DatasetAIO(opts.data, xflip=opts.mirror,
                             conv_config_index=cfg.conv_config_index)
    else:
        from ..data.dataset import ImageFolderDataset
        dataset = ImageFolderDataset(opts.data, xflip=opts.mirror)
    sample_fn, map_fn, synth_fn = fns
    extractor = build_extractor(opts.extractor, device=dev)
    run_dir = os.path.dirname(opts.network_path) or '.'
    results = []
    for m in opts.metric_list:
        result = metric_main.calc_metric(
            m, dataset=dataset, sample_fn=sample_fn, z_dim=z_dim,
            map_fn=map_fn, synth_fn=synth_fn, ppl_samples=opts.ppl_samples,
            extractor=extractor, cache_dir=opts.cache_dir,
            batch_size=opts.batch, seed=opts.seed, device=dev)
        metric_main.report_metric(result, run_dir=run_dir,
                                  snapshot_pkl=opts.network_path)
        results.append(result)
    return results


def _calc_rank(local_rank: int, opts, world: int, port: int) -> None:
    """One rank of ``--gpus N`` (``parallel.distributed.launch``)."""
    distributed.maybe_initialize(f'localhost:{port}', world, local_rank,
                                 local_rank, device=opts.device)
    calc(opts)
    # only after success: a rank that raised leaves without waiting for
    # the others (the launcher ends them)
    distributed.shutdown()


def main(argv: Optional[Sequence[str]] = None):
    """Parse, check and run; returns the results (None where ``--gpus N``
    started the ranks: rank 0 wrote them)."""
    from ..metrics import metric_main
    opts = make_parser().parse_args(argv)
    opts.metric_list = metric_main.check_metrics(opts.metrics.split(','))
    if opts.num_devices < 1:
        raise ValueError(f'--gpus {opts.num_devices}')
    from ..metrics.features import metric_device
    metric_device(opts.device)            # no card: raise, no fallback
    if opts.num_devices == 1:
        return calc(opts)
    if torch.device(opts.device).type == 'cuda':
        from ..ops import cuda
        cuda.build()                      # once, before the ranks start
    distributed.launch(_calc_rank, opts.num_devices,
                       args=(opts, opts.num_devices, distributed.free_port()),
                       device=opts.device)
    return None


if __name__ == '__main__':
    main()
