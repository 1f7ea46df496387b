"""The ('data', 'model') layout of a multi-process run (the port of
``vaenar_tts_tpu/parallel/mesh.py``).

The JAX package places arrays on a device mesh and lets XLA insert the
collectives. The port runs one process a device: ``DistContext``
(``parallel/distributed.py``) lays the process group out as a ``Mesh``,
``Mesh.data_index`` says which contiguous rows of a global batch a process
holds, and the processes of one model group hold the same rows.

The ``model`` axis: ``shard_params`` cuts every parameter that
``param_sharding_rules`` picks (the output dimension of a wide kernel, as
the JAX rule picks it) to this process's columns, and its module
(``Dense``, ``Conv``, ``Embedding`` of ``models/layers.py``) becomes
column-parallel (``ColumnShard``): the input enters as it is, the module
multiplies by its columns, the model group's outputs are gathered, and
the replicated bias is added after the gather. In the backward the
output's gradient is cut to this process's columns and the input's
gradient, a part from each process's columns, is summed over the model
group. Everything else stays replicated and identical within a model
group, as the JAX package's GSPMD program is one program.
``unshard_params`` gathers the whole state back (the counterpart of
reading a sharded JAX array to the host).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

MIN_SHARD_DIM = 512


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    model: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    def data_index(self, process_index: int) -> int:
        """The ``data`` coordinate of a process (process-major, as
        ``make_mesh`` reshapes the JAX devices)."""
        return process_index // self.model


def make_mesh(data: Optional[int] = None, model: int = 1,
              processes: Optional[int] = None) -> Mesh:
    """A (data, model) layout over ``processes`` processes (by default the
    process group's size, or 1 without one)."""
    if processes is None:
        import torch.distributed as tdist
        processes = tdist.get_world_size() if tdist.is_initialized() else 1
    if data is None:
        data = processes // model
    if data * model != processes:
        raise ValueError(f"mesh data {data} x model {model} != {processes} processes")
    return Mesh(data, model)


def _output_dim(module: nn.Module, name: str, shape: Tuple[int, ...]) -> int:
    """The index of a parameter's output dimension: the last one of its flax
    layout (a Dense kernel [in, out] is a Linear weight [out, in], a Conv
    kernel [k, in, out] a Conv1d weight [out, in, k])."""
    if name == "weight" and isinstance(module, (nn.Linear, nn.Conv1d)):
        return 0
    return len(shape) - 1


def param_sharding_rules(model: nn.Module, mesh: Mesh) -> Dict[str, Optional[int]]:
    """{parameter name: the dimension it would shard over ``model``, or
    None (replicated)}: the output dimension of a parameter of 2 or more
    dimensions that is at least MIN_SHARD_DIM and divides by the model
    axis; the flow (``prior``) and everything else replicated."""
    modules = dict(model.named_modules())
    rules: Dict[str, Optional[int]] = {}
    for full, param in model.named_parameters():
        module_name, _, name = full.rpartition(".")
        shape = tuple(param.shape)
        dim = None
        if mesh.model > 1 and "prior" not in full.split(".") and len(shape) >= 2:
            d = _output_dim(modules[module_name], name, shape)
            if shape[d] % mesh.model == 0 and shape[d] >= MIN_SHARD_DIM:
                dim = d
        rules[full] = dim
    return rules


class _EnterModel(torch.autograd.Function):
    """The identity on a replicated input; its gradient, a part from each
    process's columns, summed over the model group."""

    @staticmethod
    def forward(ctx, x, dist):
        ctx.dist = dist
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.dist.model_sum(grad), None


class _GatherModel(torch.autograd.Function):
    """The model group's column blocks concatenated along ``dim``; the
    gradient cut back to this process's block."""

    @staticmethod
    def forward(ctx, y, dist, dim):
        ctx.dist, ctx.dim, ctx.size = dist, dim, y.shape[dim]
        return dist.model_gather(y, dim)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.dist.model_index * ctx.size
        return grad.narrow(ctx.dim, start, ctx.size).contiguous(), None, None


class _SplitModel(torch.autograd.Function):
    """This process's block along ``dim`` of a tensor that the model group
    holds whole; the gradient, each process's block's, gathered whole."""

    @staticmethod
    def forward(ctx, x, dist, dim):
        ctx.dist, ctx.dim = dist, dim
        size = x.shape[dim] // dist.model_count
        return x.narrow(dim, dist.model_index * size, size).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return ctx.dist.model_gather(grad, ctx.dim), None, None


class _ShiftModel(torch.autograd.Function):
    """``DistContext.model_shift`` one place on; the gradient shifted one
    place back, to the process that sent the block."""

    @staticmethod
    def forward(ctx, x, dist):
        ctx.dist = dist
        return dist.model_shift(x, 1)

    @staticmethod
    def backward(ctx, grad):
        return ctx.dist.model_shift(grad, -1), None


def gather_model(y: torch.Tensor, dist, dim: int) -> torch.Tensor:
    """The model group's blocks of ``y`` concatenated along ``dim``
    (differentiable)."""
    return _GatherModel.apply(y, dist, dim)


def split_model(x: torch.Tensor, dist, dim: int) -> torch.Tensor:
    """This process's block of ``x`` along ``dim`` (differentiable)."""
    return _SplitModel.apply(x, dist, dim)


def shift_model(x: torch.Tensor, dist) -> torch.Tensor:
    """The block of the model group's member one place back
    (differentiable)."""
    return _ShiftModel.apply(x, dist)


@dataclasses.dataclass(eq=False)
class ColumnShard:
    """A module's weight holds this process's block of its output columns
    (``dim`` of the weight) over ``dist``'s model group."""
    dist: object
    dim: int

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _EnterModel.apply(x, self.dist)

    def gather(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        return gather_model(y, self.dist, dim)


def shard_params(model: nn.Module, mesh: Mesh, dist=None) -> nn.Module:
    """The model as this process holds it: whole (replicated) on a mesh of
    ``model = 1``; with ``model > 1`` every parameter that
    ``param_sharding_rules`` picks cut, in place, to this process's block
    of its output dimension (``dist.model_index`` of ``dist.model_count``),
    and its module made column-parallel. The parameter objects stay the
    same, so an optimizer made before or after steps the shards."""
    if mesh.model == 1:
        return model
    if dist is None or dist.mesh != mesh:
        raise ValueError(f"shard_params over {mesh.shape} needs the DistContext of that mesh")
    modules = dict(model.named_modules())
    with torch.no_grad():
        for full, dim in param_sharding_rules(model, mesh).items():
            if dim is None:
                continue
            module_name, _, name = full.rpartition(".")
            module = modules[module_name]
            # Dense, Conv and Embedding (models/layers.py) say ``tp = None``
            if (getattr(module, "tp", False) is not None or name != "weight"
                    or getattr(module, "groups", 1) != 1):
                raise ValueError(f"{full} ({type(module).__name__}) cannot be column-parallel")
            param = getattr(module, name)
            size = param.shape[dim] // mesh.model
            param.data = param.data.narrow(dim, dist.model_index * size, size).clone()
            module.tp = ColumnShard(dist, dim)
    return model


def sharded_parameters(model: nn.Module) -> Dict[str, int]:
    """{parameter name: the dimension it is sharded over} of a model that
    ``shard_params`` cut; empty for a whole one."""
    return {f"{name}.weight" if name else "weight": m.tp.dim
            for name, m in model.named_modules() if getattr(m, "tp", None) is not None}


def unshard_params(model: nn.Module, mesh: Mesh, dist=None,
                   tensors: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
    """The whole state dict of a model that ``shard_params`` cut (every
    process calls it: the shards are gathered over the model group), as
    detached copies; or, given ``tensors`` {parameter name: a tensor of the
    parameter's shape, such as its gradient}, those made whole."""
    state = dict(model.state_dict() if tensors is None else tensors)
    shards = sharded_parameters(model) if mesh.model > 1 else {}
    out = {}
    for name, t in state.items():
        t = t.detach()
        out[name] = dist.model_gather(t, shards[name]) if name in shards else t.clone()
    return out


__all__ = ["MIN_SHARD_DIM", "ColumnShard", "Mesh", "make_mesh", "param_sharding_rules",
           "shard_params", "sharded_parameters", "unshard_params"]
