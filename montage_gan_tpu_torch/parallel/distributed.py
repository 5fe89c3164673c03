"""One process per card: the process group, the roles and the launcher.

Port of ``montage_gan_tpu/parallel/distributed.py``.  The JAX package runs
one process per host over a global mesh; the port runs one process per card
(the reference's own route, train_aio.py:570-577, and PyTorch's idiom),
joined by a ``torch.distributed`` process group: NCCL between cards, gloo
between CPU processes (never gloo for CUDA tensors).

* ``maybe_initialize`` brings the group up where a rendezvous is given
  (explicitly, or by torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
  ``WORLD_SIZE``/``LOCAL_RANK``); a single process without one stays as it
  is.  A rank on a card makes its card current before anything touches it.
* ``process_info`` and ``is_primary``: files, logs and snapshots are written
  by rank 0 alone (the reference's ``rank == 0`` gates).
* ``launch`` starts the ranks of one host (``cli/train_aio.py --gpus N``)
  and joins them; a rank that fails ends the others and raises here.

Each rank reads its own stride of the shared sampler stream
(``data/sampler.py``), so the data needs no coordination.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# How long a collective waits for the other ranks before the group fails
# (a rank that died leaves the others waiting at most this long; ranks that
# ``launch`` starts are ended at once instead).  A snapshot of config aio
# takes seconds to write while the other ranks wait at a barrier.
TIMEOUT = datetime.timedelta(minutes=10)


def backend(device) -> str:
    """The process group's backend for tensors on ``device``."""
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, '') else None


def maybe_initialize(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     device='cuda') -> Tuple[int, int]:
    """Join the process group when a rendezvous is configured; return
    ``(rank, world size)``.

    Each value comes from its argument, else from torchrun's environment:
    ``coordinator`` (``HOST:PORT``) from ``MASTER_ADDR``/``MASTER_PORT``,
    ``num_processes`` from ``WORLD_SIZE``, ``process_id`` from ``RANK``,
    ``local_rank`` (the card of this process on its host) from
    ``LOCAL_RANK``, else the rank.  Without a rendezvous this is a no-op
    for one process.  A group that is already up is kept."""
    if dist.is_initialized():
        return process_info()
    if coordinator is None and os.environ.get('MASTER_ADDR'):
        coordinator = (f'{os.environ["MASTER_ADDR"]}:'
                       f'{os.environ.get("MASTER_PORT", "29500")}')
    if num_processes is None:
        num_processes = _env_int('WORLD_SIZE')
    if process_id is None:
        process_id = _env_int('RANK')
    if coordinator is None:
        if num_processes not in (None, 1):
            raise ValueError(f'{num_processes} processes and no coordinator '
                             '(HOST:PORT or MASTER_ADDR/MASTER_PORT)')
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError(f'coordinator {coordinator}: the world size and '
                         'this process\'s rank are needed (arguments, or '
                         'WORLD_SIZE and RANK)')
    if local_rank is None:
        local_rank = _env_int('LOCAL_RANK')
    if local_rank is None:
        local_rank = process_id
    dev = torch.device(device)
    if dev.type == 'cuda':
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f'rank {process_id}: card {local_rank} of '
                               f'{torch.cuda.device_count()} visible')
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend(dev), init_method=f'tcp://{coordinator}',
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return process_info()


def process_info() -> Tuple[int, int]:
    """``(rank, world size)``; ``(0, 1)`` without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """True on the one process that writes files (rank 0)."""
    return process_info()[0] == 0


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port free on this host for a rendezvous at ``localhost``."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank_entry(local_rank: int, fn: Callable, device: str, nprocs: int,
                args: Sequence) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.set_device(local_rank)     # before anything touches a card
    else:                                     # the host's cores, shared
        torch.set_num_threads(max(1, torch.get_num_threads() // nprocs))
    fn(local_rank, *args)


def launch(fn: Callable, nprocs: int, args: Sequence = (),
           device='cuda') -> None:
    """Run ``fn(local_rank, *args)`` in ``nprocs`` new processes of this
    host, rank ``i`` on card ``i`` for ``device`` ``'cuda'`` (on the CPU
    each takes its share of the cores), and wait for all.  ``fn`` must be
    a module-level function (the processes are spawned, so nothing of this
    process's state carries over).  Fewer visible cards than ``nprocs``
    raises; a rank that fails ends the others and raises here."""
    if nprocs < 1:
        raise ValueError(f'{nprocs} processes')
    if torch.device(device).type == 'cuda' and \
            nprocs > torch.cuda.device_count():
        raise RuntimeError(f'{nprocs} ranks, {torch.cuda.device_count()} '
                           'CUDA cards visible: one rank per card')
    torch.multiprocessing.spawn(_rank_entry,
                                args=(fn, str(device), nprocs, args),
                                nprocs=nprocs, join=True)
