"""Multi-process data-parallel runtime on ``torch.distributed`` (the port of
``vaenar_tts_tpu/parallel/distributed.py``).

One process per device, each owning a disjoint SET of ``.vrs`` train shards
(``partition_shards``) and feeding its rows of a GLOBAL batch. Every process
holds the whole model (replicated: broadcast from process 0 at the start);
a train step averages the gradients over the processes before Adam, so the
fleet computes what one process computes on the global batch.

* ``initialize_from_env``: ``VAENAR_COORDINATOR`` (host:port),
  ``VAENAR_NUM_PROCESSES`` and ``VAENAR_PROCESS_ID`` give
  ``init_process_group(init_method="tcp://...")``; without them the
  ``env://`` variables of ``torchrun``. The backend is ``nccl`` on CUDA and
  ``gloo`` on the CPU; ``VAENAR_DIST_BACKEND`` overrides it (NCCL refuses
  two processes on one card, so a fleet that shares one card runs gloo).
  The process's device is ``cuda:{local_rank % device_count}``.
* ``DistContext``: the collectives the loop uses, on tensors on the
  process's device under either backend. gloo takes CUDA tensors in every
  collective used here (all_reduce, broadcast, all_gather; checked on the
  card by ``chip_smoke.py``'s sharded-synthesis processes, torch 2.11) and
  stages them through the host itself; its point-to-point send and recv do
  not (they write from the tensor's address: "writev ... Bad address",
  ``chip_smoke.py``'s point-to-point probe), so ``model_shift`` stages a
  CUDA tensor through the host itself under gloo.
* The mesh (``parallel/mesh.py``): a ``(data, model)`` layout of the
  processes, process-major, as ``Mesh.data_index`` says. The processes of
  one model group (``model`` consecutive ranks) hold the same rows of a
  global batch and run one model together: tensor-parallel weights
  (``mesh.shard_params``) and the ring self-attention
  (``parallel/ring_attention.py``) talk over it. The data group (the
  processes with one model coordinate) is what the data-parallel half
  spans: the row statistics (``rows``), ``fetch`` and the gradient average
  act over it only, since a sum over every process would count each row
  ``model`` times. The default mesh is ``model = 1``: one data group of
  every process, as before.

Contract, as the JAX package's: every process runs the same number of steps
an epoch (``sync_min`` of the local counts); step i is padded to one shape
on every process (the lockstep bucket schedule, ``sync_elementwise_max``);
process 0 writes checkpoints and the others wait at a barrier; SIGTERM must
reach every process (``kill -TERM -- -pgid``), and the fleet stops at the
end of the epoch in which any process was signalled.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from .data_group import DataGroup
from .mesh import Mesh, make_mesh, sharded_parameters


def _backend(device: torch.device) -> str:
    return os.environ.get("VAENAR_DIST_BACKEND") or (
        "nccl" if device.type == "cuda" else "gloo")


def process_device(device="cuda") -> torch.device:
    """``cuda:{local_rank % device_count}`` (local rank: ``LOCAL_RANK``, else
    ``VAENAR_PROCESS_ID``, else 0) for ``cuda``; the CPU for ``cpu``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("VAENAR_PROCESS_ID", "0")))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_from_env(device="cuda") -> Optional["DistContext"]:
    """Join the process group the environment describes; return its
    ``DistContext``, or None (the group left again) when it has one
    process."""
    dev = process_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = _backend(dev)
    coord = os.environ.get("VAENAR_COORDINATOR")
    if coord:
        tdist.init_process_group(backend, init_method=f"tcp://{coord}",
                                 world_size=int(os.environ["VAENAR_NUM_PROCESSES"]),
                                 rank=int(os.environ["VAENAR_PROCESS_ID"]))
    else:
        tdist.init_process_group(backend, init_method="env://")
    if tdist.get_world_size() == 1:
        tdist.destroy_process_group()
        return None
    return DistContext(dev)


def is_multiprocess() -> bool:
    return tdist.is_available() and tdist.is_initialized() and tdist.get_world_size() > 1


def partition_shards(paths: Sequence[str], index: Optional[int] = None,
                     count: Optional[int] = None) -> List[str]:
    """This process's disjoint set of shards: a round robin over the sorted
    list. Raises when the process would own none."""
    index = tdist.get_rank() if index is None else index
    count = tdist.get_world_size() if count is None else count
    mine = sorted(paths)[index::count]
    if not mine:
        raise ValueError(f"process {index}: no record shards to own ({len(paths)} shards < "
                         f"{count} processes; re-preprocess with dataset.record_split >= "
                         f"process count)")
    return mine


class DistContext:
    """The process group of a run, seen from one process on ``device``, laid
    out as ``mesh`` (by default ``make_mesh(model=1)``: every process on the
    data axis)."""

    def __init__(self, device, mesh: Optional[Mesh] = None):
        self.device = torch.device(device)
        self.process_index = tdist.get_rank()
        self.process_count = tdist.get_world_size()
        self.backend = tdist.get_backend()
        self.mesh = mesh if mesh is not None else make_mesh(model=1,
                                                            processes=self.process_count)
        if self.mesh.data * self.mesh.model != self.process_count:
            raise ValueError(f"mesh {self.mesh.shape} does not cover {self.process_count} "
                             f"processes")
        n_data, n_model = self.mesh.data, self.mesh.model
        self.data_index = self.mesh.data_index(self.process_index)
        self.model_index = self.process_index % n_model
        # every process creates every subgroup, in the same order
        # (tdist.new_group's contract); a group of one process is not made
        self._data_group = self._model_group = None
        self._model_ranks = [self.data_index * n_model + m for m in range(n_model)]
        if n_model > 1:
            for d in range(n_data):
                ranks = [d * n_model + m for m in range(n_model)]
                group = tdist.new_group(ranks)
                if d == self.data_index:
                    self._model_group = group
            if n_data > 1:
                for m in range(n_model):
                    group = tdist.new_group([d * n_model + m for d in range(n_data)])
                    if m == self.model_index:
                        self._data_group = group

    @property
    def data_count(self) -> int:
        return self.mesh.data

    @property
    def model_count(self) -> int:
        return self.mesh.model

    @property
    def is_main(self) -> bool:
        return self.process_index == 0

    def close(self) -> None:
        if tdist.is_initialized():
            tdist.destroy_process_group()

    # -- the collectives, each on a copy of its input -------------------------

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data group."""
        t = x.detach().clone(memory_format=torch.contiguous_format)
        if self.data_count > 1:
            tdist.all_reduce(t, op=tdist.ReduceOp.SUM, group=self._data_group)
        return t

    def _reduce_host(self, values, dtype, op) -> np.ndarray:
        t = torch.as_tensor(np.asarray(values), dtype=dtype).to(self.device)
        tdist.all_reduce(t, op=op)
        return t.cpu().numpy()

    def fetch(self, x: torch.Tensor) -> torch.Tensor:
        """The full batch of a tensor of which each data group member holds
        its rows (equal shapes), in data order."""
        t = x.detach().contiguous()
        if self.data_count == 1:
            return t.clone()
        parts = [torch.empty_like(t) for _ in range(self.data_count)]
        tdist.all_gather(parts, t, group=self._data_group)
        return torch.cat(parts)

    # -- the model group: tensor-parallel weights and the ring ----------------

    def model_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The model group's parts of a tensor (equal shapes), concatenated
        along ``dim`` in model order."""
        t = x.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(self.model_count)]
        tdist.all_gather(parts, t, group=self._model_group)
        return torch.cat(parts, dim=dim)

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the model group, formed in fp32 (a bf16 or
        fp16 ``x`` is rounded once, after the sum) and returned in x's
        dtype."""
        t = x.detach().to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        tdist.all_reduce(t, op=tdist.ReduceOp.SUM, group=self._model_group)
        return t.to(x.dtype)

    def model_shift(self, x: torch.Tensor, step: int = 1) -> torch.Tensor:
        """Send ``x`` to the model group's member ``step`` places on (mod the
        group's size) and return what the member ``step`` places back sent:
        ``ppermute`` over the model axis. gloo's point-to-point ops read
        and write host memory only, so a CUDA tensor goes through a host
        copy under gloo."""
        n = self.model_count
        dst = self._model_ranks[(self.model_index + step) % n]
        src = self._model_ranks[(self.model_index - step) % n]
        staged = x.is_cuda and self.backend == "gloo"
        send = (x.detach().cpu() if staged else x.detach()).contiguous()
        recv = torch.empty_like(send)
        for req in tdist.batch_isend_irecv([
                tdist.P2POp(tdist.isend, send, dst, group=self._model_group),
                tdist.P2POp(tdist.irecv, recv, src, group=self._model_group)]):
            req.wait()
        return recv.to(x.device) if staged else recv

    def replicate(self, module: torch.nn.Module) -> torch.nn.Module:
        """Process 0's parameters and buffers in every process's ``module``."""
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                tdist.broadcast(t.data, src=0)
        return module

    def to_host(self, tree):
        """Tensors of a (nested dict or list) tree -> numpy."""
        if isinstance(tree, dict):
            return {k: self.to_host(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.to_host(v) for v in tree)
        return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else tree

    def global_batch(self, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """This process's rows of a batch (numpy) onto its device; integer
        token ids as int64, as the loop feeds them."""
        out = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a))
            out.append((t.long() if t.dim() == 2 and not t.is_floating_point() else t)
                       .to(self.device))
        return tuple(out)

    def rows(self, local_rows: int) -> DataGroup:
        """The data group of a forward on ``local_rows`` rows a process (the
        rows of this process's data coordinate)."""
        i = self.data_index
        return DataGroup(i * local_rows, (i + 1) * local_rows,
                         local_rows * self.data_count, self.data_count,
                         self.all_reduce_sum)

    def average_gradients(self, params: Sequence[torch.nn.Parameter],
                          extra: Optional[Dict[str, torch.Tensor]] = None
                          ) -> Dict[str, torch.Tensor]:
        """Average the gradients of ``params`` (those that have one; every
        process has the same set) and the scalars ``extra`` over the data
        group, in one collective; return the averaged ``extra``. A
        tensor-parallel shard is averaged with the shards of its model
        coordinate, which hold the same columns."""
        grads = [p.grad for p in params if p.grad is not None]
        names = sorted(extra or {})
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [extra[k].reshape(1).float() for k in names])
        flat = self.all_reduce_sum(flat) / self.data_count
        offset = 0
        with torch.no_grad():
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
        return {k: flat[offset + j] for j, k in enumerate(names)}

    def average_replicas(self, model: torch.nn.Module) -> None:
        """Average over the model group, in one collective, the gradients of
        the parameters that ``mesh.shard_params`` left whole. Each process
        of the group computes them from the same rows, but not to the same
        bits where a library's gradient is not reproducible (cuDNN's
        convolution weight gradients); Adam would then step the replicas
        apart. An all-reduce hands every process the same sum, so the
        replicas stay bit-equal."""
        sharded = set(sharded_parameters(model))
        grads = [p.grad for name, p in model.named_parameters()
                 if name not in sharded and p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        tdist.all_reduce(flat, op=tdist.ReduceOp.SUM, group=self._model_group)
        flat /= self.model_count
        offset = 0
        with torch.no_grad():
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    # -- host values ---------------------------------------------------------

    def sync_min(self, value: int) -> int:
        return int(self._reduce_host([value], torch.int64, tdist.ReduceOp.MIN)[0])

    def sync_max(self, value: int) -> int:
        return int(self._reduce_host([value], torch.int64, tdist.ReduceOp.MAX)[0])

    def sync_elementwise_max(self, arr: np.ndarray) -> np.ndarray:
        """The element-wise max of an equally shaped int array over the
        processes (the lockstep bucket schedule, once an epoch)."""
        return self._reduce_host(np.ascontiguousarray(arr), torch.int64, tdist.ReduceOp.MAX)

    def allsum(self, values) -> np.ndarray:
        """The sum of a small host array over the processes, in float64."""
        return self._reduce_host(values, torch.float64, tdist.ReduceOp.SUM)

    def barrier(self) -> None:
        """Every process reaches this point before any leaves it."""
        self._reduce_host([0], torch.int64, tdist.ReduceOp.SUM)
