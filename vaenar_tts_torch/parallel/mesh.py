"""The ('data', 'model') layout of a multi-process run (the port of
``vaenar_tts_tpu/parallel/mesh.py``).

The JAX package places arrays on a device mesh and lets XLA insert the
collectives. The port runs one process a device: the ``data`` axis is the
process group of ``parallel/distributed.py``, and ``Mesh.data_index`` says
which contiguous rows of a global batch a process holds. The ``model`` axis (tensor-parallel
weights) is described by ``param_sharding_rules`` but not run:
``shard_params`` with ``model > 1`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """The model as each process holds it: whole (replicated) on a mesh of
    ``model = 1``. Tensor-parallel weights (``model > 1``) are not part of
    the port yet."""
    if mesh.model > 1:
        raise NotImplementedError(
            "shard_params with model > 1 (tensor-parallel weights) is not ported: it is "
            "ROADMAP.md Queue 1 item 5, the mesh's model axis (tensor-parallel shard_params "
            "and parallel/ring_attention.py)")
    return model


__all__ = ["MIN_SHARD_DIM", "Mesh", "make_mesh", "param_sharding_rules", "shard_params"]
