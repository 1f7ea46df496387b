"""The JAX package's single-file weight export (``export.npz``): reader,
writer, and the export of a training directory's latest checkpoint.

Format (``vaenar_tts_tpu/utils/export.py``): one ``np.savez_compressed``
archive. Each leaf sits under its ``/``-joined path prefixed by its collection
(``params/...`` or ``batch_stats/...``); ``epoch`` is a scalar entry, and a
``__meta__`` JSON entry records each leaf's original dtype, restored on load
(leaves are usually stored as float16). numpy only, so the JAX package's
``load_npz`` reads what ``save_npz`` writes and the port reads the JAX
package's exports.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, Optional

import numpy as np

EXPORT_NAME = "export.npz"
STORE_DTYPE = "float16"  # floating leaves are stored at this dtype


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def _flatten(tree: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            flat.update(_flatten(value, f"{prefix}{key}/"))
        else:
            flat[f"{prefix}{key}"] = np.asarray(value)
    return flat


def load_npz(path: str) -> Dict[str, Any]:
    """Read an export to ``{params, batch_stats, epoch}`` (nested dicts of
    numpy arrays), each leaf at its original dtype."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        dtypes = meta["dtypes"]
        flat = {k: z[k].astype(dtypes[k]) for k in dtypes}
        epoch = int(z["epoch"])
    collections = {}
    for name in ("params", "batch_stats"):
        prefix = name + "/"
        collections[name] = unflatten({k[len(prefix):]: v for k, v in flat.items()
                                       if k.startswith(prefix)})
    return {**collections, "epoch": epoch}


def save_npz(path: str, state: Dict[str, Any]) -> str:
    """Write ``{params, batch_stats, epoch}`` (flax trees of numpy arrays,
    as ``interop.weights.torch_to_jax`` makes them) to a compressed archive.
    Floating leaves are stored as float16; ``__meta__`` records every leaf's
    dtype for ``load_npz``. The archive is written to a temporary name and
    renamed into place."""
    flat = {}
    flat.update(_flatten(state["params"], "params/"))
    flat.update(_flatten(state.get("batch_stats", {}), "batch_stats/"))
    dtypes = {k: str(v.dtype) for k, v in flat.items()}
    flat = {k: v.astype(STORE_DTYPE) if np.issubdtype(v.dtype, np.floating) else v
            for k, v in flat.items()}
    flat["epoch"] = np.asarray(int(state.get("epoch", 0)), np.int64)
    meta = {"version": 1, "store_dtype": STORE_DTYPE, "dtypes": dtypes}
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                     dtype=np.uint8).copy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    buf = io.BytesIO()
    np.savez_compressed(buf, **flat)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)
    return path


def export_model_dir(model_dir: str, out_path: Optional[str] = None) -> str:
    """Export the latest checkpoint of a training directory written by
    ``cli.train`` to ``out_path`` (default ``model_dir/export.npz``, where
    inference looks). Needs the directory's ``hparams.json``. Runs on the
    CPU."""
    from ..configs.serialize import load_hparams
    from ..interop.weights import torch_to_jax
    from ..models.vaenar import VAENAR
    from .checkpoint import CheckpointManager

    hp = load_hparams(model_dir)
    if hp is None:
        raise FileNotFoundError(f"no hparams.json in {model_dir}: the export "
                                "needs the training config")
    model = VAENAR(hp)
    restored = CheckpointManager(model_dir).restore(model)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint in {model_dir}")
    params, batch_stats = torch_to_jax(model)
    return save_npz(out_path or os.path.join(model_dir, EXPORT_NAME),
                    {"params": params, "batch_stats": batch_stats,
                     "epoch": restored})
