"""Reader for the JAX package's single-file weight export (``export.npz``).

Format (``vaenar_tts_tpu/utils/export.py``): one ``np.savez_compressed``
archive. Each leaf sits under its ``/``-joined path prefixed by its collection
(``params/...`` or ``batch_stats/...``); ``epoch`` is a scalar entry, and a
``__meta__`` JSON entry records each leaf's original dtype, restored here
(leaves are usually stored as float16). numpy only.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

EXPORT_NAME = "export.npz"


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


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
