"""The data-parallel group that a forward pass runs in.

Under ``jit`` over a data-sharded global array, the JAX package computes on
the GLOBAL batch: BatchNorm and the ActNorm data init take their statistics
over every process's rows, and dropout masks and noise are drawn for the
whole batch from one global key, each device keeping its rows. The port
runs one model per process on its own rows, so a forward that is part of a
global batch says so with ``data_group(DataGroup(...))``:

* ``draw`` (dropout masks, posterior and prior noise) draws the tensor of
  the global batch from the caller's generator and keeps this process's
  rows, so that every process consumes the same stream as one process
  running the global batch would;
* ``global_mean`` averages a per-process mean over the processes, through
  a sum that autograd carries back (the gradient of a global statistic
  reaches every process's rows), for BatchNorm in training;
* ``all_reduce_sum`` sums over the processes, for the ActNorm init.

Outside such a block every function here is the single-process one.
Processes hold equal numbers of rows (the loop pads them to one shape), so
a mean of per-process means is the global mean.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator, Optional, Sequence

import torch


class _AllReduceSum(torch.autograd.Function):
    """Sum over the processes, forward and backward: the gradient of every
    process's copy of the sum is the sum of the processes' gradients."""

    @staticmethod
    def forward(ctx, x, reduce):
        ctx.reduce = reduce
        return reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.reduce(grad.contiguous()), None


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """This process's rows [start, stop) of a global batch of ``total``
    rows, held by ``count`` processes; ``all_reduce_sum`` returns the sum
    of a tensor over them (``DistContext.all_reduce_sum``)."""
    start: int
    stop: int
    total: int
    count: int
    all_reduce_sum: Callable[[torch.Tensor], torch.Tensor]

    def draw(self, fn: Callable, shape: Sequence[int], **kwargs) -> torch.Tensor:
        """``fn(shape, **kwargs)`` (``torch.rand``, ``torch.randn``) for the
        global batch, cut to this process's rows. A leading dimension of k
        rows an example (the tiled posterior samples) is cut k rows an
        example."""
        rows = self.stop - self.start
        if shape[0] % rows:
            raise ValueError(f"a draw of {shape[0]} rows is not a multiple of the "
                             f"process's {rows} rows")
        k = shape[0] // rows
        full = fn((self.total * k, *shape[1:]), **kwargs)
        return full[self.start * k:self.stop * k]

    def global_mean(self, local_mean: torch.Tensor) -> torch.Tensor:
        """The mean over the processes of a mean over this process's rows,
        differentiable."""
        return _AllReduceSum.apply(local_mean, self.all_reduce_sum) / self.count


_ACTIVE: Optional[DataGroup] = None


def active() -> Optional[DataGroup]:
    return _ACTIVE


@contextlib.contextmanager
def data_group(group: Optional[DataGroup]) -> Iterator[None]:
    """Run the block as ``group``'s part of a global batch (None: alone)."""
    global _ACTIVE
    previous, _ACTIVE = _ACTIVE, group
    try:
        yield
    finally:
        _ACTIVE = previous


def draw(fn: Callable, shape: Sequence[int], **kwargs) -> torch.Tensor:
    """``fn(shape, **kwargs)``, or in a data group this process's rows of
    the global batch's draw."""
    if _ACTIVE is None:
        return fn(tuple(shape), **kwargs)
    return _ACTIVE.draw(fn, shape, **kwargs)
