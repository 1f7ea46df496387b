"""Map the JAX package's flax trees (``params``, ``batch_stats``, as nested
dicts of arrays) onto the port's state dict.

The port's modules carry the flax names, so a leaf at ``a/b/kernel`` lands
at ``a.b.weight``. By leaf:

* Dense ``kernel`` [in, out] -> ``Linear.weight`` [out, in];
* Conv ``kernel`` [k, in, out] -> ``Conv1d.weight`` [out, in, k];
* ``embedding`` -> ``Embedding.weight``;
* LayerNorm and BatchNorm ``scale`` -> ``weight``; ``bias`` -> ``bias``;
* BatchNorm ``mean`` / ``var`` (batch_stats) -> ``running_mean`` /
  ``running_var``, plus a zero ``num_batches_tracked``;
* ``pos_weight`` (scalar), ActNorm ``log_scale``, InvertibleLinear
  ``weight`` -> the same name, unchanged.

The mapping is strict: an unknown leaf raises, and ``load_jax_weights``
raises on any key the model does not have and on any model key left unset.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch
from torch import nn

_SAME_NAME = ("bias", "pos_weight", "log_scale", "weight")


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping -> {'a/b/leaf': array}."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def _param(path: str, leaf: np.ndarray):
    module, _, name = path.rpartition("/")
    arr = np.asarray(leaf, dtype=np.float32)
    if name == "kernel" and arr.ndim == 2:
        name, arr = "weight", arr.T
    elif name == "kernel" and arr.ndim == 3:
        name, arr = "weight", arr.transpose(2, 1, 0)
    elif name in ("embedding", "scale"):
        name = "weight"
    elif name not in _SAME_NAME:
        raise KeyError(f"no torch counterpart for flax leaf {path!r} "
                       f"of shape {arr.shape}")
    return module, name, arr


def jax_to_torch(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict for the given flax trees."""
    sd: Dict[str, torch.Tensor] = {}

    def put(module: str, name: str, arr: np.ndarray):
        key = f"{module.replace('/', '.')}.{name}" if module else name
        sd[key] = torch.from_numpy(np.array(arr, order="C"))

    for path, leaf in flatten(params).items():
        put(*_param(path, leaf))
    stats_names = {"mean": "running_mean", "var": "running_var"}
    for path, leaf in flatten(batch_stats).items():
        module, _, name = path.rpartition("/")
        if name not in stats_names:
            raise KeyError(f"no torch counterpart for batch_stats leaf {path!r}")
        put(module, stats_names[name], np.asarray(leaf, dtype=np.float32))
        put(module, "num_batches_tracked", np.zeros((), np.int64))
    return sd


def load_jax_weights(model: nn.Module, params: Mapping,
                     batch_stats: Mapping) -> None:
    """Load the flax trees into ``model``; raise on any key or shape that
    does not match."""
    sd = jax_to_torch(params, batch_stats)
    expected = model.state_dict()
    extra = sorted(set(sd) - set(expected))
    missing = sorted(set(expected) - set(sd))
    if extra or missing:
        raise KeyError(f"weight mapping mismatch: {len(extra)} key(s) the model "
                       f"does not have {extra[:5]}, {len(missing)} model key(s) "
                       f"left unset {missing[:5]}")
    for key, value in sd.items():
        if tuple(value.shape) != tuple(expected[key].shape):
            raise ValueError(f"{key}: export shape {tuple(value.shape)} != "
                             f"model shape {tuple(expected[key].shape)}")
    model.load_state_dict(sd, strict=True)
