"""Data-parallel execution over the ranks of a process group.

Port of ``montage_gan_tpu/parallel/mesh.py``.  The JAX package runs one
program over a 1-D data mesh: parameters replicated, batches sharded, and
every mean over the batch a mean over the global batch (XLA inserts the
collectives).  The port runs the same step on every rank over its rows of
the global batch, and makes global by hand what mixes samples:

* ``all_reduce_grads``: each phase's summed gradients, averaged over the
  ranks in one flat buffer per phase before its optimizer step (local
  batches are equal, so the mean of the ranks' mean losses is the global
  mean).  ``DistributedDataParallel`` does not fit: its hooks fire when
  gradients accumulate into ``.grad``, and the phases take theirs with
  ``torch.autograd.grad``.
* ``gather_batch``: a differentiable all-gather along the batch (the
  minibatch-std groups span ranks); its backward sums the ranks' gradients
  of a rank's rows, and is differentiable again (R1 differentiates twice).
* ``global_mean`` (no gradient: ``w_avg``, ``pl_mean``, the stats, ADA's
  signs) and ``global_sum`` (differentiable: the theta constraint, a norm
  over the batch).
* ``replicate`` (a fresh init, broadcast from rank 0) and
  ``assert_replicated`` (the reference's ``check_ddp_consistency``).

The step reads the ranks through ``activate(DataParallel(...))``, which
the trainer enters around each step; outside it (or without a process
group) every function here is the identity and the step is the one-process
step.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place among the ``world`` ranks of the default
    process group, and the device its collectives run on (the rank's card
    for NCCL, the CPU for gloo)."""
    rank: int
    world: int
    device: torch.device

    @classmethod
    def from_process_group(cls, device) -> 'DataParallel':
        """The default process group's ranks, collectives on ``device``."""
        if not dist.is_initialized():
            raise RuntimeError('no process group: call '
                               'parallel.distributed.maybe_initialize first')
        dev = torch.device(device)
        if (dist.get_backend() == 'nccl') != (dev.type == 'cuda'):
            raise ValueError(f'a {dist.get_backend()} process group for '
                             f'tensors on {dev}: NCCL for the card, gloo for '
                             'the CPU')
        if dev.type == 'cuda' and dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
        return cls(dist.get_rank(), dist.get_world_size(), dev)


_ACTIVE: List[DataParallel] = []


@contextlib.contextmanager
def activate(dp: Optional[DataParallel]) -> Iterator[None]:
    """Within the block, the functions below act across ``dp``'s ranks
    (nothing changes for ``None``)."""
    if dp is None:
        yield
        return
    _ACTIVE.append(dp)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active() -> Optional[DataParallel]:
    return _ACTIVE[-1] if _ACTIVE else None


# ---------------------------------------------------------------------------
# Collectives of the step
# ---------------------------------------------------------------------------

def _sum_(x: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


class _Gather(torch.autograd.Function):
    """All ranks' ``x`` stacked along dim 0 in rank order."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        parts = [torch.empty_like(x) for _ in range(dp.world)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        return _SumRows.apply(grad, ctx.dp), None


class _SumRows(torch.autograd.Function):
    """The sum over ranks of this rank's rows of ``g``: the adjoint of
    ``_Gather``, and ``_Gather`` is its own."""

    @staticmethod
    def forward(ctx, g, dp):
        ctx.dp = dp
        n = g.shape[0] // dp.world
        total = _sum_(g.contiguous().clone())
        return total.narrow(0, dp.rank * n, n).clone()

    @staticmethod
    def backward(ctx, grad):
        return _Gather.apply(grad, ctx.dp), None


class _Sum(torch.autograd.Function):
    """The sum over ranks; its adjoint is the sum over ranks of the
    gradients."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return _sum_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return _Sum.apply(grad, ctx.dp), None


def gather_batch(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``(the global batch of x, the index of this rank's first row in
    it)``: every rank's rows in rank order, differentiable twice.  Without
    active ranks ``(x, 0)``."""
    dp = active()
    if dp is None:
        return x, 0
    return _Gather.apply(x, dp), dp.rank * x.shape[0]


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (every rank's
    ``x`` reaches the result)."""
    dp = active()
    return x if dp is None else _Sum.apply(x, dp)


@torch.no_grad()
def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks, without gradient: a mean over the
    global batch where ``x`` is a mean over a rank's equal share."""
    dp = active()
    if dp is None:
        return x
    return _sum_(x.detach().clone()) / dp.world


@torch.no_grad()
def leading_rows(x: torch.Tensor, shrink: int) -> torch.Tensor:
    """The first ``1/shrink`` of the global batch's rows, shared evenly
    among the ranks in rank order (the path-length regularizer's
    ``z[:batch // pl_batch_shrink]`` over the global batch, JAX
    ``training/losses.py``).  Without active ranks ``x[:n // shrink]``."""
    dp = active()
    if dp is None:
        return x[:x.shape[0] // shrink]
    parts = [torch.empty_like(x) for _ in range(dp.world)]
    dist.all_gather(parts, x.contiguous())
    rows = torch.cat(parts)[:x.shape[0] * dp.world // shrink]
    if rows.shape[0] % dp.world:
        raise ValueError(f'{rows.shape[0]} rows (a microbatch of '
                         f'{x.shape[0] * dp.world} / {shrink}) do not share '
                         f'among {dp.world} ranks')
    n = rows.shape[0] // dp.world
    return rows[dp.rank * n:(dp.rank + 1) * n].clone()


@torch.no_grad()
def global_rows(x: torch.Tensor, rounds: int = 1) -> torch.Tensor:
    """The global batch of ``x`` (no gradient), where each rank holds its
    share of each of ``rounds`` rounds laid end to end: round-major, the
    ranks' rows of a round in rank order.  Without active ranks ``x``."""
    dp = active()
    if dp is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dp.world)]
    dist.all_gather(parts, x.contiguous())
    rest = x.shape[1:]
    full = torch.stack(parts).reshape(dp.world, rounds, -1, *rest)
    return full.transpose(0, 1).reshape(-1, *rest)


def own_rows(x: torch.Tensor, rounds: int = 1) -> torch.Tensor:
    """This rank's rows of a global batch laid out as ``global_rows`` lays
    it out.  Without active ranks ``x``."""
    dp = active()
    if dp is None:
        return x
    rest = x.shape[1:]
    return x.reshape(rounds, dp.world, -1, *rest)[:, dp.rank].reshape(
        -1, *rest)


def all_reduce_grads(grads: Sequence[Optional[torch.Tensor]]
                     ) -> List[Optional[torch.Tensor]]:
    """A phase's gradients averaged over the ranks: one flat buffer per
    dtype, one collective each.  ``None`` stays ``None`` (every rank runs
    the same graph, so the ranks agree on which are)."""
    grads = list(grads)
    dp = active()
    if dp is None:
        return grads
    by_dtype = {}
    for i, g in enumerate(grads):
        if g is not None:
            by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        _sum_(flat).div_(dp.world)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            grads[i] = part.view_as(grads[i])
    return grads


# ---------------------------------------------------------------------------
# Replicas
# ---------------------------------------------------------------------------

@torch.no_grad()
def replicate(tensors: Iterable[torch.Tensor], dp: DataParallel) -> None:
    """Every rank's ``tensors`` set to rank 0's, in place."""
    for t in tensors:
        src = t.detach()
        buf = src if src.device == dp.device else src.to(dp.device)
        dist.broadcast(buf, 0)
        if buf is not src:
            src.copy_(buf)


def _checksum(t: torch.Tensor) -> torch.Tensor:
    """Two int64 sums of ``t``'s bytes (plain and position-weighted): equal
    replicas give equal sums."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8).long()
    w = torch.arange(b.numel(), device=b.device) % 65521 + 1
    return torch.stack([b.sum(), (b * w).sum()])


@torch.no_grad()
def assert_replicated(named: Iterable[Tuple[str, torch.Tensor]],
                      dp: DataParallel) -> int:
    """Raise ``AssertionError`` naming every tensor whose bytes differ from
    rank 0's, on every rank (the reference's ``check_ddp_consistency``).
    Every rank passes the same names in the same order.  Returns the number
    of tensors checked."""
    named = list(named)
    if not named:
        return 0
    sums = torch.stack([_checksum(t).to(dp.device) for _, t in named])
    parts = [torch.empty_like(sums) for _ in range(dp.world)]
    dist.all_gather(parts, sums)
    differ = torch.stack([(p != parts[0]).any(dim=1) for p in parts]).any(0)
    bad = [named[i][0] for i in differ.nonzero().flatten().tolist()]
    if bad:
        raise AssertionError(f'{len(bad)} of {len(named)} tensors differ '
                             f'between the {dp.world} ranks: {bad[:8]}')
    return len(named)


@torch.no_grad()
def broadcast_flag(flag: bool, dp: Optional[DataParallel]) -> bool:
    """Rank 0's ``flag`` on every rank."""
    if dp is None:
        return flag
    t = torch.tensor([int(flag)], device=dp.device)
    dist.broadcast(t, 0)
    return bool(t.item())


def barrier(dp: Optional[DataParallel]) -> None:
    if dp is not None:
        dist.barrier(**({'device_ids': [dp.device.index]}
                         if dp.device.type == 'cuda' else {}))
